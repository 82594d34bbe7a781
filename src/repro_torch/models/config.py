"""Model configuration: one schema covering every assigned architecture.

Counterpart of `repro/models/config.py` (the port keeps its own copy; it
is plain data).  A model is a stack of *stages*; each stage repeats a
short *pattern* of blocks R times, and the parameters of each pattern
position are stacked (R, ...) over the repeats.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One layer's shape: the sequence mixer + the channel mixer."""
    mixer: str = "attn"          # attn | mamba | mlstm | slstm
    window: int = 0              # 0 = full attention, >0 = sliding window
    cross_attn: bool = False     # decoder block with encoder cross-attn
    causal: bool = True
    mlp: str = "dense"           # dense | moe | none
    qk_norm: bool = False


@dataclasses.dataclass(frozen=True)
class Stage:
    pattern: Tuple[BlockSpec, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str               # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0              # 0 -> d_model // n_heads
    stages: Tuple[Stage, ...] = ()
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # SSM (mamba)
    ssm_d_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # xLSTM
    mlstm_chunk: int = 256
    # encoder-decoder (whisper): decoder uses the fields above
    is_encoder_decoder: bool = False
    encoder_stages: Tuple[Stage, ...] = ()
    encoder_seq: int = 1500
    frontend: str = "tokens"     # tokens | frames
    # attention implementation off the card: "naive" materializes the
    # (S, T) scores, "chunked" streams KV blocks with an online softmax;
    # on the card causal self-attention runs the flash kernel either way
    attn_impl: str = "naive"
    attn_block_q: int = 1024
    attn_block_k: int = 1024
    # misc
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    act: str = "silu"
    dtype: str = "bfloat16"
    # long-context decode variant for dense archs: beyond
    # `long_context_threshold` attention falls back to this window
    long_context_window: int = 0
    long_context_threshold: int = 131_072

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def all_layers(self) -> List[BlockSpec]:
        out: List[BlockSpec] = []
        for st in self.stages:
            out.extend(list(st.pattern) * st.repeats)
        return out

    def validate(self):
        n = sum(st.n_layers for st in self.stages)
        assert n == self.n_layers, \
            f"{self.name}: stages cover {n} layers != n_layers={self.n_layers}"
        if self.is_encoder_decoder:
            assert self.encoder_stages, f"{self.name}: missing encoder stages"
        for st in self.stages:
            for b in st.pattern:
                assert b.mixer in ("attn", "mamba", "mlstm", "slstm"), b.mixer
                assert b.mlp in ("dense", "moe", "none"), b.mlp
                if b.mlp == "moe":
                    assert self.n_experts > 0 and self.top_k > 0
        return self


def uniform_stages(n_layers: int, block: BlockSpec) -> Tuple[Stage, ...]:
    return (Stage(pattern=(block,), repeats=n_layers),)


# ---------------------------------------------------------------------------
# analytic cost model (the reference's, for model-FLOP rates)
# ---------------------------------------------------------------------------

def param_count(cfg: ModelConfig) -> dict:
    """Per-component parameter counts (embedding counted once if tied)."""
    d, hd = cfg.d_model, cfg.head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    counts = {"embed": cfg.vocab_size * d, "norms": 0, "mixer": 0, "mlp": 0}
    if not cfg.tie_embeddings:
        counts["embed"] *= 2

    def mixer_params(b: BlockSpec) -> int:
        if b.mixer == "attn":
            p = d * h * hd + 2 * d * hkv * hd + h * hd * d
            if b.cross_attn:
                p *= 2
            return p
        if b.mixer == "mamba":
            di = cfg.ssm_expand * d
            return (d * 2 * di + di * cfg.ssm_conv
                    + di * (2 * cfg.ssm_d_state + 1) + di + di * d)
        if b.mixer in ("mlstm", "slstm"):
            return d * 3 * h * hd + 2 * d * h + h * hd * d
        raise ValueError(b.mixer)

    def mlp_params(b: BlockSpec) -> int:
        if b.mlp == "dense":
            return 3 * d * cfg.d_ff
        if b.mlp == "moe":
            return d * cfg.n_experts + cfg.n_experts * 3 * d * cfg.d_ff
        return 0

    layers = cfg.all_layers()
    if cfg.is_encoder_decoder:
        for st in cfg.encoder_stages:
            layers = layers + list(st.pattern) * st.repeats
    for b in layers:
        counts["mixer"] += mixer_params(b)
        counts["mlp"] += mlp_params(b)
        counts["norms"] += 2 * d + (d if b.cross_attn else 0)
    counts["total"] = sum(v for k, v in counts.items() if k != "total")
    return counts


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top_k experts instead of all)."""
    if cfg.n_experts == 0:
        return param_count(cfg)["total"]
    layers = cfg.all_layers()
    moe_layers = sum(1 for b in layers if b.mlp == "moe")
    full = param_count(cfg)["total"]
    inactive = moe_layers * (cfg.n_experts - cfg.top_k) * 3 \
        * cfg.d_model * cfg.d_ff
    return full - inactive


def step_flops(cfg: ModelConfig, batch: int, seq: int, training: bool,
               kv_len: int = 0) -> dict:
    """Analytic FLOPs for one forward (and backward if training).

    kv_len > 0 means decode: `seq` new tokens attending to kv_len cached
    positions.  Matmul flops only (2*MACs); backward = 2x forward."""
    d, hd = cfg.d_model, cfg.head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    tokens = batch * seq
    out = {"proj": 0.0, "attn": 0.0, "mixer_state": 0.0, "mlp": 0.0,
           "logits": 2.0 * tokens * d * cfg.vocab_size}

    def attn_ctx(b: BlockSpec) -> float:
        if kv_len:
            ctx = min(kv_len, b.window or cfg.long_context_window or kv_len)
            return 2.0 * 2.0 * tokens * h * hd * ctx
        w = b.window or seq
        # causal: sum over i of min(i, w) approx seq*min(seq,w)/2 for full
        eff = seq * min(seq, w) / 2 if w >= seq else seq * w
        return 2.0 * 2.0 * batch * h * hd * eff

    layers = cfg.all_layers()
    if cfg.is_encoder_decoder:
        enc_tokens = batch * cfg.encoder_seq
        for st in cfg.encoder_stages:
            for b in st.pattern:
                out["proj"] += st.repeats * 2.0 * enc_tokens * (
                    d * h * hd + 2 * d * hkv * hd + h * hd * d)
                out["attn"] += st.repeats * 2.0 * 2.0 * batch * h * hd \
                    * cfg.encoder_seq ** 2
                out["mlp"] += st.repeats * 2.0 * enc_tokens * 3 * d * cfg.d_ff

    for b in layers:
        if b.mixer == "attn":
            out["proj"] += 2.0 * tokens * (d * h * hd + 2 * d * hkv * hd
                                           + h * hd * d)
            out["attn"] += attn_ctx(b)
            if b.cross_attn:
                out["proj"] += 2.0 * tokens * (d * h * hd + h * hd * d)
                out["attn"] += 2.0 * 2.0 * tokens * h * hd * cfg.encoder_seq
        elif b.mixer == "mamba":
            di = cfg.ssm_expand * d
            out["proj"] += 2.0 * tokens * (2 * d * di + di * d
                                           + di * (2 * cfg.ssm_d_state + 1))
            out["mixer_state"] += 2.0 * tokens * di * cfg.ssm_d_state * 2
        else:  # mlstm / slstm
            out["proj"] += 2.0 * tokens * (3 * d * h * hd + h * hd * d)
            if b.mixer == "mlstm":
                # chunkwise matrix-memory update ~ 2 * dh^2 per token-head
                out["mixer_state"] += 2.0 * tokens * h * hd * hd * 2
            else:
                out["mixer_state"] += 2.0 * tokens * h * hd * 4
        if b.mlp == "dense":
            out["mlp"] += 2.0 * tokens * 3 * d * cfg.d_ff
        elif b.mlp == "moe":
            out["mlp"] += 2.0 * tokens * (d * cfg.n_experts
                                          + cfg.top_k * 3 * d * cfg.d_ff)

    out["fwd_total"] = sum(v for k, v in out.items())
    out["total"] = out["fwd_total"] * (3.0 if training else 1.0)
    return out
