"""The 10 assigned architectures (exact specs from the public pool).
Every entry cites its source in brackets.

Counterpart of `repro/configs/archs.py`; the port keeps its own copy of
the registry (it is data).  `reduced(cfg)` produces the same-family
smoke variant (<=2 pattern periods, d_model<=256, <=4 experts, f32)
used by the CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.models.config import (BlockSpec, ModelConfig, Stage,
                                       uniform_stages)

ARCHS: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        ARCHS[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; have {sorted(ARCHS)}")
    return ARCHS[name]().validate()


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@register("kimi-k2-1t-a32b")
def kimi_k2() -> ModelConfig:
    """Kimi K2 — trillion-param MoE, 384 experts top-8, first layer dense
    [arXiv:2501.kimi2]."""
    return ModelConfig(
        name="kimi-k2-1t-a32b", arch_type="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=2048, vocab_size=163_840, n_experts=384, top_k=8,
        stages=(Stage((BlockSpec(mlp="dense"),), 1),
                Stage((BlockSpec(mlp="moe"),), 60)),
        long_context_window=8_192)


@register("mixtral-8x22b")
def mixtral() -> ModelConfig:
    """Mixtral 8x22B — 8 experts top-2, sliding-window attention
    [arXiv:2401.04088]."""
    return ModelConfig(
        name="mixtral-8x22b", arch_type="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
        d_ff=16384, vocab_size=32_768, n_experts=8, top_k=2,
        stages=uniform_stages(56, BlockSpec(window=4096, mlp="moe")))


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

@register("llama3-405b")
def llama3_405b() -> ModelConfig:
    """Llama-3 405B — GQA, 128k vocab [arXiv:2407.21783]."""
    return ModelConfig(
        name="llama3-405b", arch_type="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_head=128,
        d_ff=53248, vocab_size=128_256,
        stages=uniform_stages(126, BlockSpec()),
        tie_embeddings=False, long_context_window=8_192)


@register("llama3-8b")
def llama3_8b() -> ModelConfig:
    """Llama-3 8B — GQA, 128k vocab [arXiv:2407.21783]."""
    return ModelConfig(
        name="llama3-8b", arch_type="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=14336, vocab_size=128_256,
        stages=uniform_stages(32, BlockSpec()),
        tie_embeddings=False, long_context_window=8_192)


@register("gemma3-12b")
def gemma3_12b() -> ModelConfig:
    """Gemma-3 12B — 5 local(1024) : 1 global attention interleave, 256k
    vocab [hf:google/gemma-3-1b-pt family]."""
    local = BlockSpec(window=1024)
    glob = BlockSpec()
    return ModelConfig(
        name="gemma3-12b", arch_type="dense",
        n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, d_head=256,
        d_ff=15360, vocab_size=262_144, act="gelu",
        stages=(Stage((local, local, local, local, local, glob), 8),))


@register("yi-34b")
def yi_34b() -> ModelConfig:
    """Yi-34B — llama-architecture GQA [arXiv:2403.04652]."""
    return ModelConfig(
        name="yi-34b", arch_type="dense",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
        d_ff=20480, vocab_size=64_000,
        stages=uniform_stages(60, BlockSpec()),
        tie_embeddings=False, long_context_window=8_192)


# ---------------------------------------------------------------------------
# hybrid / ssm
# ---------------------------------------------------------------------------

@register("jamba-v0.1-52b")
def jamba() -> ModelConfig:
    """Jamba v0.1 — Mamba+attention 1:7 interleave, MoE(16e top-2) every
    other layer [arXiv:2403.19887]."""
    pattern = tuple(
        BlockSpec(mixer=("attn" if i == 3 else "mamba"),
                  mlp=("moe" if i % 2 == 1 else "dense"))
        for i in range(8))
    return ModelConfig(
        name="jamba-v0.1-52b", arch_type="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=14336, vocab_size=65_536, n_experts=16, top_k=2,
        ssm_d_state=16, ssm_conv=4, ssm_expand=2,
        stages=(Stage(pattern, 4),))


@register("xlstm-125m")
def xlstm_125m() -> ModelConfig:
    """xLSTM-125M — mLSTM blocks with interleaved sLSTM
    [arXiv:2405.04517]."""
    m = BlockSpec(mixer="mlstm", mlp="none")
    s = BlockSpec(mixer="slstm", mlp="none")
    return ModelConfig(
        name="xlstm-125m", arch_type="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_head=192,
        d_ff=0, vocab_size=50_304,
        stages=(Stage((m, m, m, m, m, s), 2),))


# ---------------------------------------------------------------------------
# vlm / audio
# ---------------------------------------------------------------------------

@register("chameleon-34b")
def chameleon() -> ModelConfig:
    """Chameleon-34B — early-fusion VQ image tokens (ids in the shared
    65536 vocab; the VQ tokenizer is the stubbed frontend), qk-norm
    [arXiv:2405.09818]."""
    return ModelConfig(
        name="chameleon-34b", arch_type="vlm",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=22016, vocab_size=65_536,
        stages=uniform_stages(48, BlockSpec(qk_norm=True)),
        tie_embeddings=False, long_context_window=8_192)


@register("whisper-large-v3")
def whisper() -> ModelConfig:
    """Whisper large-v3 — encoder-decoder; the mel+conv frontend is
    stubbed (input_specs feeds (B, 1500, d) frame embeddings)
    [arXiv:2212.04356]."""
    return ModelConfig(
        name="whisper-large-v3", arch_type="audio",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_head=64,
        d_ff=5120, vocab_size=51_866, act="gelu",
        is_encoder_decoder=True, encoder_seq=1500, frontend="frames",
        stages=uniform_stages(32, BlockSpec(cross_attn=True)),
        encoder_stages=uniform_stages(32, BlockSpec(causal=False)))


# ---------------------------------------------------------------------------
# reduced smoke variants
# ---------------------------------------------------------------------------

def reduced(cfg: ModelConfig) -> ModelConfig:
    """Same family, toy size: one pattern period per stage (<=2 for
    uniform stacks), d_model<=256, <=4 experts, small vocab."""
    def shrink_stage(st: Stage) -> Stage:
        reps = 1 if len(st.pattern) > 1 else min(2, st.repeats)
        return Stage(st.pattern, reps)

    stages = tuple(shrink_stage(st) for st in cfg.stages)
    enc_stages = tuple(shrink_stage(st) for st in cfg.encoder_stages) \
        if cfg.is_encoder_decoder else ()
    n_layers = sum(st.n_layers for st in stages)
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    shrunk = dataclasses.replace(
        cfg, name=cfg.name + "-reduced",
        n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_kv, d_head=64,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 1024),
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_chunk=16, mlstm_chunk=16,
        encoder_seq=16 if cfg.is_encoder_decoder else cfg.encoder_seq,
        stages=stages, encoder_stages=enc_stages,
        dtype="float32")
    return shrunk.validate()
