"""Decoder stack of the LLM paths: the training loss, prefill and greedy
decode, for every architecture of `configs/archs.py`.

Counterpart of `repro/models/transformer.py`: attention (dense, GQA,
sliding-window, qk-norm, cross-attention), Mamba, mLSTM and sLSTM
mixers, the dense GLU MLP and the MoE MLP, and Whisper's encoder over
precomputed frame embeddings (the reference's stub frontend).  The
parameter tree is the reference's, `{"embed", "final_norm",
"lm_head"?, "stages": [{"posI": stacked (R, ...)}], "encoder"?,
"enc_pos"?, "enc_norm"?}`, so weights carry across one to one
(`repro_torch.convert`).  The layer loop is a Python loop over each
stage's repeats.

`impl` routes the kernels of a forward's attention and mLSTM chunks
like `ops.cut_eval`: None runs the kernels on CUDA tensors and the plain
math on CPU tensors, "kernel" insists on the kernels, "ref" forces the
plain math anywhere.  The kernels are forward-only, as the reference's
Pallas kernels are: `train_loss` and every objective that is
differentiated run the plain math (`impl="ref"`), and a kernel handed a
tensor that a gradient can flow through raises.  Mamba's scan and the
MoE dispatch are plain torch, as they are plain jnp in the reference;
so is decode.

Modes:
  train   : full-sequence forward + next-token CE + MoE aux loss
            (train_loss)
  prefill : full-sequence forward that also seeds the decode cache
  decode  : one token per call against the cache (decode_step)
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.utils.checkpoint as torch_checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.config import BlockSpec, ModelConfig, Stage
from repro_torch.models.layers import (dense_init, dtype_of, embed_init,
                                       glu_mlp_apply, glu_mlp_init, rms_norm,
                                       softmax_cross_entropy, zeros)
from repro_torch.utils.tree import tree_index, tree_map

# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _block_init(cfg: ModelConfig, spec: BlockSpec, generator, device,
                lead):
    dt = dtype_of(cfg.dtype)
    d = cfg.d_model
    kw = dict(device=device, lead=lead)
    p: Dict[str, Any] = {"norm1": zeros((d,), dt, **kw),
                         "norm2": zeros((d,), dt, **kw)}
    if spec.mixer == "attn":
        p["attn"] = attn_lib.attn_init(generator, d, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.head_dim, dt,
                                       cross=spec.cross_attn,
                                       qk_norm=spec.qk_norm, **kw)
        if spec.cross_attn:
            p["norm_x"] = zeros((d,), dt, **kw)
    elif spec.mixer == "mamba":
        p["mamba"] = mamba_lib.mamba_init(generator, d, cfg.ssm_expand,
                                          cfg.ssm_d_state, cfg.ssm_conv, dt,
                                          **kw)
    elif spec.mixer == "mlstm":
        p["mlstm"] = xlstm_lib.mlstm_init(generator, d, cfg.n_heads,
                                          cfg.head_dim, dt, **kw)
    elif spec.mixer == "slstm":
        p["slstm"] = xlstm_lib.slstm_init(generator, d, cfg.n_heads,
                                          cfg.head_dim, dt, **kw)
    if spec.mlp == "dense":
        p["mlp"] = glu_mlp_init(generator, d, cfg.d_ff, dt, **kw)
    elif spec.mlp == "moe":
        p["moe"] = moe_lib.moe_init(generator, d, cfg.d_ff, cfg.n_experts,
                                    dt, **kw)
    return p


def _stage_init(cfg: ModelConfig, stage: Stage, generator, device):
    return {f"pos{i}": _block_init(cfg, spec, generator, device,
                                   (stage.repeats,))
            for i, spec in enumerate(stage.pattern)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random weights with the reference's distributions, drawn from
    `generator` (which must live on `device`); stacked weights are drawn
    one repeat (and one expert) at a time."""
    cfg.validate()
    dt = dtype_of(cfg.dtype)
    params: Dict[str, Any] = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dt,
                            device=device),
        "final_norm": zeros((cfg.d_model,), dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator,
                                       (cfg.d_model, cfg.vocab_size), dt,
                                       device=device)
    params["stages"] = [_stage_init(cfg, st, generator, device)
                        for st in cfg.stages]
    if cfg.is_encoder_decoder:
        params["encoder"] = [_stage_init(cfg, st, generator, device)
                             for st in cfg.encoder_stages]
        params["enc_pos"] = (torch.randn(
            (cfg.encoder_seq, cfg.d_model), generator=generator,
            device=device, dtype=torch.float32) * 0.02).to(dt)
        params["enc_norm"] = zeros((cfg.d_model,), dt, device=device)
    return params


# ---------------------------------------------------------------------------
# single block forward (full sequence)
# ---------------------------------------------------------------------------

def _effective_window(cfg: ModelConfig, spec: BlockSpec, ctx_len: int) -> int:
    if spec.window:
        return spec.window
    if (cfg.long_context_window
            and ctx_len > cfg.long_context_threshold):
        return cfg.long_context_window
    return 0


def _block_fwd(cfg: ModelConfig, spec: BlockSpec, bp, x, positions,
               enc_out=None, collect_kv: bool = False,
               impl: Optional[str] = None):
    """Returns (x, aux_loss, kv_or_state_for_cache)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kv = None
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    if spec.mixer == "attn":
        window = _effective_window(cfg, spec, x.shape[1])
        out, (k, v) = attn_lib.self_attention(
            bp["attn"], h, positions, n_kv_heads=cfg.n_kv_heads,
            rope_theta=cfg.rope_theta, causal=spec.causal, window=window,
            qk_norm=spec.qk_norm, norm_eps=cfg.norm_eps,
            impl=cfg.attn_impl, block_q=cfg.attn_block_q,
            block_k=cfg.attn_block_k, kernel_impl=impl)
        kv = {"k": k, "v": v}
        x = x + out
        if spec.cross_attn:
            hx = rms_norm(x, bp["norm_x"], cfg.norm_eps)
            enc_kv = attn_lib.encode_kv(bp["attn"], enc_out)
            x = x + attn_lib.cross_attention(bp["attn"], hx, enc_kv,
                                             kernel_impl=impl)
            kv["xk"], kv["xv"] = enc_kv
    else:
        if spec.mixer == "mamba":
            out, kv = mamba_lib.mamba_apply(bp["mamba"], h,
                                            chunk=cfg.ssm_chunk)
        elif spec.mixer == "mlstm":
            out, kv = xlstm_lib.mlstm_apply(bp["mlstm"], h,
                                            chunk=cfg.mlstm_chunk, impl=impl)
        else:
            out, kv = xlstm_lib.slstm_apply(bp["slstm"], h)
        x = x + out

    if spec.mlp == "dense":
        h = rms_norm(x, bp["norm2"], cfg.norm_eps)
        x = x + glu_mlp_apply(bp["mlp"], h, cfg.act)
    elif spec.mlp == "moe":
        h = rms_norm(x, bp["norm2"], cfg.norm_eps)
        out, aux = moe_lib.moe_apply(bp["moe"], h, cfg.top_k,
                                     cfg.capacity_factor, cfg.act)
        x = x + out
    return x, aux, (kv if collect_kv else None)


def _stack(trees):
    """Trees of one structure -> one tree, leaves stacked on a new axis 0."""
    return tree_map(lambda *xs: torch.stack(xs, 0), *trees)


def _checkpointed_block(cfg, spec, bp, x, positions, enc_out, impl):
    """One block under `torch.utils.checkpoint` (the reference's
    `jax.checkpoint`): its activations are recomputed in the backward
    pass.  Checkpointing rests on saved-tensor hooks, which `torch.func`
    transforms refuse, so under one this raises rather than dropping the
    remat.  Returns (x, aux_loss)."""
    if torch._C._functorch.peek_interpreter_stack() is not None:
        raise NotImplementedError(
            "remat=True under a torch.func transform (grad / vmap): "
            "torch.utils.checkpoint cannot nest there; pass remat=False "
            "(see ROADMAP.md Queue 1, item 9)")
    return torch_checkpoint.checkpoint(
        lambda bp_, x_: _block_fwd(cfg, spec, bp_, x_, positions, enc_out,
                                   False, impl)[:2],
        bp, x, use_reentrant=False)


def _run_stages(cfg: ModelConfig, stages_params, stages_cfg, x, positions,
                enc_out=None, collect_kv: bool = False,
                impl: Optional[str] = None, remat: bool = False):
    """Returns (x, total_aux, caches): caches is a list parallel to the
    stages, each {posN: stacked-over-repeats cache} (or None).  remat
    checkpoints each block (not while collecting caches, as in the
    reference)."""
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches: List[Optional[dict]] = []
    for st_params, st in zip(stages_params, stages_cfg):
        per_pos: Dict[str, List] = {f"pos{i}": []
                                    for i in range(len(st.pattern))}
        for r in range(st.repeats):
            for i, spec in enumerate(st.pattern):
                bp = tree_index(st_params[f"pos{i}"], r)
                if remat and not collect_kv:
                    x, aux = _checkpointed_block(cfg, spec, bp, x, positions,
                                                 enc_out, impl)
                else:
                    x, aux, kv = _block_fwd(cfg, spec, bp, x, positions,
                                            enc_out, collect_kv, impl)
                    per_pos[f"pos{i}"].append(kv)
                total_aux = total_aux + aux
        caches.append({k: _stack(v) for k, v in per_pos.items()}
                      if collect_kv else None)
    return x, total_aux, caches


# ---------------------------------------------------------------------------
# public forward passes
# ---------------------------------------------------------------------------

def _embed(params, tokens):
    return params["embed"][tokens.long()]


def _positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None] \
        .expand(b, s)


def encode(cfg: ModelConfig, params, frames, impl: Optional[str] = None):
    """Whisper-style encoder over precomputed frame embeddings (the
    reference's stub frontend): frames (B, T_enc, d) -> (B, T_enc, d)."""
    x = frames + params["enc_pos"][None, : frames.shape[1]]
    positions = _positions(frames.shape[0], frames.shape[1], x.device)
    x, _, _ = _run_stages(cfg, params["encoder"], cfg.encoder_stages, x,
                          positions, impl=impl)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _logits(cfg: ModelConfig, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return x @ params["lm_head"]


def forward(cfg: ModelConfig, params, tokens, frames=None,
            unroll: bool = False, collect_kv: bool = False,
            remat: bool = False, embed_perturbation=None,
            impl: Optional[str] = None):
    """tokens: (B,S) int -> (logits (B,S,V), aux_loss, caches).

    frames: (B, T_enc, d) for encoder-decoder archs (others ignore it,
    as in the reference).  embed_perturbation: optional (B,S,d) added to
    the token embeddings in their dtype (the trilevel robust-HPO
    adversarial variable x2 enters here).  remat checkpoints each block.
    aux_loss is the MoE router loss summed over the blocks.  `unroll` is
    the reference's signature only: the port's layer loop is always a
    Python loop, so it has no effect."""
    del unroll
    x = _embed(params, tokens)
    if embed_perturbation is not None:
        x = x + embed_perturbation.to(x.dtype)
    b, s = tokens.shape
    positions = _positions(b, s, x.device)
    enc_out = None
    if cfg.is_encoder_decoder:
        if frames is None:
            raise ValueError(f"{cfg.name} needs encoder frames")
        enc_out = encode(cfg, params, frames, impl=impl)
    x, aux, caches = _run_stages(cfg, params["stages"], cfg.stages, x,
                                 positions, enc_out, collect_kv, impl, remat)
    return _logits(cfg, params, x), aux, caches


def train_loss(cfg: ModelConfig, params, tokens, frames=None,
               unroll: bool = False, remat: bool = False,
               embed_perturbation=None, impl: Optional[str] = "ref"):
    """Next-token CE + MoE aux loss.

    embed_perturbation, if given, must match the model INPUT length
    (tokens.shape[1] - 1).  The plain math by default (`impl="ref"`): the
    kernels are forward-only; a caller that only evaluates the loss
    under `torch.no_grad()` may pass impl=None to run them."""
    logits, aux, _ = forward(cfg, params, tokens[:, :-1], frames, unroll,
                             remat=remat,
                             embed_perturbation=embed_perturbation,
                             impl=impl)
    ce = softmax_cross_entropy(logits, tokens[:, 1:])
    return ce + cfg.router_aux_coef * aux


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------

def _block_cache_init(cfg: ModelConfig, spec: BlockSpec, batch: int,
                      max_seq: int, dtype, device):
    if spec.mixer == "attn":
        window = _effective_window(cfg, spec, max_seq)
        cap = min(max_seq, window) if window else max_seq
        c = attn_lib.init_kv_cache(batch, cfg.n_kv_heads, cfg.head_dim,
                                   cap, dtype, device=device)
        if spec.cross_attn:
            c["xk"] = torch.zeros((batch, cfg.encoder_seq, cfg.n_kv_heads,
                                   cfg.head_dim), dtype=dtype, device=device)
            c["xv"] = torch.zeros_like(c["xk"])
        return c
    if spec.mixer == "mamba":
        return mamba_lib.init_mamba_state(batch, cfg.d_model,
                                          cfg.ssm_expand, cfg.ssm_d_state,
                                          cfg.ssm_conv, dtype, device=device)
    if spec.mixer == "mlstm":
        return xlstm_lib.init_mlstm_state(batch, cfg.n_heads, cfg.head_dim,
                                          device=device)
    if spec.mixer == "slstm":
        return xlstm_lib.init_slstm_state(batch, cfg.n_heads, cfg.head_dim,
                                          device=device)
    raise ValueError(spec.mixer)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Decode cache for the whole stack, stacked (R, B, ...) per stage."""
    dt = dtype_of(cfg.dtype)
    caches = []
    for st in cfg.stages:
        st_cache = {}
        for i, spec in enumerate(st.pattern):
            one = _block_cache_init(cfg, spec, batch, max_seq, dt, device)
            st_cache[f"pos{i}"] = tree_map(
                lambda a: a[None].expand((st.repeats,) + a.shape).clone(),
                one)
        caches.append(st_cache)
    return caches


def _block_decode(cfg: ModelConfig, spec: BlockSpec, bp, x, cache, cur_pos):
    """x: (B,1,d); cache: this block's cache. Returns (x, new_cache)."""
    h = rms_norm(x, bp["norm1"], cfg.norm_eps)
    if spec.mixer == "attn":
        cap = cache["k"].shape[1]
        window = spec.window or _effective_window(cfg, spec, cap + 1)
        # capacity already encodes the window; pass window for masking
        out, new_cache = attn_lib.decode_attention(
            bp["attn"], h, cache, cur_pos, rope_theta=cfg.rope_theta,
            window=window if window and window <= cap else 0,
            qk_norm=spec.qk_norm, norm_eps=cfg.norm_eps)
        x = x + out
        if spec.cross_attn:
            hx = rms_norm(x, bp["norm_x"], cfg.norm_eps)
            x = x + attn_lib.cross_attention(
                bp["attn"], hx, (cache["xk"], cache["xv"]),
                kernel_impl="ref")
            new_cache["xk"], new_cache["xv"] = cache["xk"], cache["xv"]
    else:
        if spec.mixer == "mamba":
            out, new_cache = mamba_lib.mamba_decode(bp["mamba"], h, cache)
        elif spec.mixer == "mlstm":
            out, new_cache = xlstm_lib.mlstm_decode(bp["mlstm"], h, cache)
        else:
            out, new_cache = xlstm_lib.slstm_decode(bp["slstm"], h, cache)
        x = x + out
    if spec.mlp == "dense":
        hh = rms_norm(x, bp["norm2"], cfg.norm_eps)
        x = x + glu_mlp_apply(bp["mlp"], hh, cfg.act)
    elif spec.mlp == "moe":
        hh = rms_norm(x, bp["norm2"], cfg.norm_eps)
        out, _ = moe_lib.moe_apply(bp["moe"], hh, cfg.top_k,
                                   cfg.capacity_factor, cfg.act)
        x = x + out
    return x, new_cache


def decode_step(cfg: ModelConfig, params, caches, tokens, cur_pos):
    """One serve step: tokens (B,1) int, cur_pos (B,) absolute position.

    Returns (logits (B,1,V), new_caches); `caches` is not modified."""
    x = _embed(params, tokens)
    new_caches = []
    for st_params, st_cache, st in zip(params["stages"], caches, cfg.stages):
        new_st: Dict[str, List] = {f"pos{i}": []
                                   for i in range(len(st.pattern))}
        for r in range(st.repeats):
            for i, spec in enumerate(st.pattern):
                bp = tree_index(st_params[f"pos{i}"], r)
                cc = tree_index(st_cache[f"pos{i}"], r)
                x, nc = _block_decode(cfg, spec, bp, x, cc, cur_pos)
                new_st[f"pos{i}"].append(nc)
        new_caches.append({k: _stack(v) for k, v in new_st.items()})
    return _logits(cfg, params, x), new_caches


def prefill(cfg: ModelConfig, params, tokens, frames=None,
            max_seq: Optional[int] = None, impl: Optional[str] = None):
    """Full-context forward that seeds the decode cache.

    frames: (B, T_enc, d) for encoder-decoder archs: the cross-attention
    caches hold their encoder keys and values.  max_seq: total capacity
    to allocate (prompt + planned generation); defaults to prompt_len +
    1.  Returns (logits, caches) positioned so the next decode_step uses
    cur_pos = tokens.shape[1]."""
    b, s = tokens.shape
    logits, _, kv = forward(cfg, params, tokens, frames, collect_kv=True,
                            impl=impl)
    caches = init_cache(cfg, b, max_seq or (s + 1), device=logits.device)
    positions = _positions(b, s, logits.device)
    out = []
    for st_cache, st_kv, st in zip(caches, kv, cfg.stages):
        st_out = {}
        for i, spec in enumerate(st.pattern):
            blank, got = st_cache[f"pos{i}"], st_kv[f"pos{i}"]
            if spec.mixer == "attn":
                seeded = []
                for r in range(st.repeats):
                    c = attn_lib.seed_kv_cache(
                        {k: blank[k][r] for k in ("k", "v", "pos")},
                        got["k"][r], got["v"][r], positions)
                    if spec.cross_attn:
                        c["xk"], c["xv"] = got["xk"][r], got["xv"][r]
                    seeded.append(c)
                st_out[f"pos{i}"] = _stack(seeded)
            else:
                st_out[f"pos{i}"] = got    # recurrent states are the cache
        out.append(st_out)
    return logits, out


def greedy_sample(logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
