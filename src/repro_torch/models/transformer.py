"""Decoder stack of the LLM serving path: prefill and greedy decode.

Counterpart of `repro/models/transformer.py` for the blocks the serving
slice needs: attention (dense, GQA, sliding-window, qk-norm), mLSTM and
sLSTM mixers, and the dense GLU MLP.  The parameter tree is the
reference's, `{"embed", "final_norm", "lm_head"?, "stages": [{"posI":
stacked (R, ...)}]}`, so weights carry across one to one
(`repro_torch.convert`).  The layer loop is a Python loop over each
stage's repeats.  Mamba and MoE blocks, cross-attention, the encoder and
the frame frontend raise `NotImplementedError`.

`impl` routes the kernels of prefill's attention and mLSTM chunks like
`ops.cut_eval`: None runs the kernels on CUDA tensors and the plain math
on CPU tensors, "kernel" insists on the kernels, "ref" forces the plain
math anywhere.  Decode is plain torch, as in the reference.

Modes:
  prefill : full-sequence forward that also seeds the decode cache
  decode  : one token per call against the cache (decode_step)
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.models.layers import (dense_init, dtype_of, embed_init,
                                       glu_mlp_apply, glu_mlp_init, rms_norm,
                                       zeros)
from repro_torch.utils.tree import tree_index, tree_map

_LATER = {
    "mamba": "ROADMAP Queue 1, next item 1 (mamba and MoE blocks)",
    "moe": "ROADMAP Queue 1, next item 1 (mamba and MoE blocks)",
    "cross_attn": "ROADMAP Queue 1, next item 2 (Whisper's encoder and "
                  "cross-attention)",
}


def _unported(what: str, key: str):
    raise NotImplementedError(f"{what} is not ported to repro_torch yet: "
                              f"{_LATER[key]}")


def _check_supported(cfg: ModelConfig):
    if cfg.is_encoder_decoder or cfg.frontend == "frames":
        _unported(f"{cfg.name}'s encoder and frame frontend", "cross_attn")
    for spec in cfg.all_layers():
        if spec.mixer == "mamba":
            _unported("the mamba mixer", "mamba")
        if spec.mlp == "moe":
            _unported("the MoE MLP", "moe")
        if spec.cross_attn:
            _unported("cross-attention", "cross_attn")


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
                                       qk_norm=spec.qk_norm, **kw)
    elif spec.mixer == "mlstm":
        p["mlstm"] = xlstm_lib.mlstm_init(generator, d, cfg.n_heads,
                                          cfg.head_dim, dt, **kw)
    elif spec.mixer == "slstm":
        p["slstm"] = xlstm_lib.slstm_init(generator, d, cfg.n_heads,
                                          cfg.head_dim, dt, **kw)
    if spec.mlp == "dense":
        p["mlp"] = glu_mlp_init(generator, d, cfg.d_ff, dt, **kw)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random weights with the reference's distributions, drawn from
    `generator` (which must live on `device`); stacked weights are drawn
    one repeat at a time."""
    cfg.validate()
    _check_supported(cfg)
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
    params["stages"] = [
        {f"pos{i}": _block_init(cfg, spec, generator, device,
                                (st.repeats,))
         for i, spec in enumerate(st.pattern)}
        for st in cfg.stages]
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
               collect_kv: bool = False, impl: Optional[str] = None):
    """Returns (x, kv_or_state_for_cache)."""
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
        if collect_kv:
            kv = {"k": k, "v": v}
    elif spec.mixer == "mlstm":
        out, kv = xlstm_lib.mlstm_apply(bp["mlstm"], h,
                                        chunk=cfg.mlstm_chunk, impl=impl)
    else:
        out, kv = xlstm_lib.slstm_apply(bp["slstm"], h)
    x = x + out
    if spec.mlp == "dense":
        h = rms_norm(x, bp["norm2"], cfg.norm_eps)
        x = x + glu_mlp_apply(bp["mlp"], h, cfg.act)
    return x, (kv if collect_kv else None)


def _stack(trees):
    """Trees of one structure -> one tree, leaves stacked on a new axis 0."""
    return tree_map(lambda *xs: torch.stack(xs, 0), *trees)


def _run_stages(cfg: ModelConfig, stages_params, x, positions,
                collect_kv: bool = False, impl: Optional[str] = None):
    """Returns (x, caches): caches is a list parallel to the stages, each
    {posN: stacked-over-repeats cache} (or None)."""
    caches: List[Optional[dict]] = []
    for st_params, st in zip(stages_params, cfg.stages):
        per_pos: Dict[str, List] = {f"pos{i}": []
                                    for i in range(len(st.pattern))}
        for r in range(st.repeats):
            for i, spec in enumerate(st.pattern):
                bp = tree_index(st_params[f"pos{i}"], r)
                x, kv = _block_fwd(cfg, spec, bp, x, positions, collect_kv,
                                   impl)
                per_pos[f"pos{i}"].append(kv)
        caches.append({k: _stack(v) for k, v in per_pos.items()}
                      if collect_kv else None)
    return x, caches


# ---------------------------------------------------------------------------
# public forward passes
# ---------------------------------------------------------------------------

def _embed(params, tokens):
    return params["embed"][tokens.long()]


def _logits(cfg: ModelConfig, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params["embed"])
    return x @ params["lm_head"]


def forward(cfg: ModelConfig, params, tokens, frames=None,
            collect_kv: bool = False, impl: Optional[str] = None):
    """tokens: (B,S) int -> (logits (B,S,V), aux_loss, caches).  aux_loss
    is the MoE router loss, zero here (no MoE block is ported)."""
    _check_supported(cfg)
    if frames is not None:
        _unported("the frame frontend", "cross_attn")
    x = _embed(params, tokens)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    x, caches = _run_stages(cfg, params["stages"], x, positions, collect_kv,
                            impl)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(cfg, params, x), aux, caches


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------

def _block_cache_init(cfg: ModelConfig, spec: BlockSpec, batch: int,
                      max_seq: int, dtype, device):
    if spec.mixer == "attn":
        window = _effective_window(cfg, spec, max_seq)
        cap = min(max_seq, window) if window else max_seq
        return attn_lib.init_kv_cache(batch, cfg.n_kv_heads, cfg.head_dim,
                                      cap, dtype, device=device)
    if spec.mixer == "mlstm":
        return xlstm_lib.init_mlstm_state(batch, cfg.n_heads, cfg.head_dim,
                                          device=device)
    if spec.mixer == "slstm":
        return xlstm_lib.init_slstm_state(batch, cfg.n_heads, cfg.head_dim,
                                          device=device)
    _unported(f"the {spec.mixer} mixer", spec.mixer)


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
    elif spec.mixer == "mlstm":
        out, new_cache = xlstm_lib.mlstm_decode(bp["mlstm"], h, cache)
    else:
        out, new_cache = xlstm_lib.slstm_decode(bp["slstm"], h, cache)
    x = x + out
    if spec.mlp == "dense":
        hh = rms_norm(x, bp["norm2"], cfg.norm_eps)
        x = x + glu_mlp_apply(bp["mlp"], hh, cfg.act)
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

    max_seq: total capacity to allocate (prompt + planned generation);
    defaults to prompt_len + 1.  Returns (logits, caches) positioned so
    the next decode_step uses cur_pos = tokens.shape[1]."""
    b, s = tokens.shape
    logits, _, kv = forward(cfg, params, tokens, frames, collect_kv=True,
                            impl=impl)
    caches = init_cache(cfg, b, max_seq or (s + 1), device=logits.device)
    positions = torch.arange(s, dtype=torch.int32,
                             device=logits.device)[None].expand(b, s)
    out = []
    for st_cache, st_kv, st in zip(caches, kv, cfg.stages):
        st_out = {}
        for i, spec in enumerate(st.pattern):
            blank, got = st_cache[f"pos{i}"], st_kv[f"pos{i}"]
            if spec.mixer == "attn":
                st_out[f"pos{i}"] = _stack([
                    attn_lib.seed_kv_cache(tree_index(blank, r),
                                           got["k"][r], got["v"][r],
                                           positions)
                    for r in range(st.repeats)])
            else:
                st_out[f"pos{i}"] = got    # recurrent states are the cache
        out.append(st_out)
    return logits, out


def greedy_sample(logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
