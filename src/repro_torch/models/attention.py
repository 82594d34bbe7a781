"""GQA attention: full/sliding-window causal self-attention and the
ring-buffer KV cache for decode.

Counterpart of `repro/models/attention.py`.  `attend` is the dense math
and the flash kernel's oracle (`kernels/ref.py` uses it).  Causal
self-attention over the full sequence (train / prefill) runs the
hand-written flash kernel on CUDA tensors (`ops.flash_attention`),
whatever the config's `attn_impl`; on CPU tensors it runs `attend` or
`attend_chunked` by `attn_impl`, as the reference does.  Decode
attention, one query against the cache, is plain torch, as in the
reference.  Cross-attention (Whisper) is not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, rms_norm, zeros

NEG_INF = -2.0 ** 20  # large-but-finite; avoids NaN from all-masked rows


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def attn_init(generator, d, n_heads, n_kv_heads, head_dim, dtype,
              qk_norm: bool = False, device=None, lead: Sequence[int] = ()):
    kw = dict(device=device, lead=lead)
    p = {"wq": dense_init(generator, (d, n_heads, head_dim), dtype,
                          fan_in=d, **kw),
         "wk": dense_init(generator, (d, n_kv_heads, head_dim), dtype,
                          fan_in=d, **kw),
         "wv": dense_init(generator, (d, n_kv_heads, head_dim), dtype,
                          fan_in=d, **kw),
         "wo": dense_init(generator, (n_heads, head_dim, d), dtype,
                          fan_in=n_heads * head_dim, **kw)}
    if qk_norm:
        p["q_norm"] = zeros((head_dim,), dtype, **kw)
        p["k_norm"] = zeros((head_dim,), dtype, **kw)
    return p


# ---------------------------------------------------------------------------
# core attention math (the kernel oracle)
# ---------------------------------------------------------------------------

def attend(q, k, v, mask=None):
    """q: (B,S,H,hd), k/v: (B,T,Hkv,hd); GQA via head grouping.

    mask: broadcastable to (B, H_or_1, S, T), True = attend.
    """
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k.float()) / math.sqrt(hd)
    if mask is not None:
        m = mask if mask.dim() == 4 else mask[:, None]
        m = m.reshape(b, -1, 1, s, t) if m.shape[1] not in (1, hkv) \
            else m[:, :, None]
        scores = torch.where(m, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def causal_window_mask(q_pos, k_pos, window: int = 0):
    """True where q may attend k: k<=q and (optionally) q-k < window."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window:
        m = m & (k_pos[..., None, :] > q_pos[..., :, None] - window)
    return m


def attend_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                   block_q: int = 1024, block_k: int = 1024):
    """Flash-style streaming attention in plain torch (the reference's
    jnp loop, written as Python loops over q and kv blocks): never
    materializes the (S,T) score matrix."""
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    bq = min(block_q, s)
    bk = min(block_k, t)
    nq, nk = -(-s // bq), -(-t // bk)
    s_pad, t_pad = nq * bq, nk * bk
    pad = torch.nn.functional.pad
    qp = pad(q, (0, 0, 0, 0, 0, s_pad - s))
    kp = pad(k, (0, 0, 0, 0, 0, t_pad - t))
    vp = pad(v, (0, 0, 0, 0, 0, t_pad - t))
    qg = qp.reshape(b, nq, bq, hkv, g, hd).float() / math.sqrt(hd)
    kc = kp.reshape(b, nk, bk, hkv, hd).float()
    vc = vp.reshape(b, nk, bk, hkv, hd).float()
    dev = q.device

    outs = []
    for qi in range(nq):
        q_pos = qi * bq + torch.arange(bq, device=dev)
        m_run = torch.full((b, hkv, g, bq), NEG_INF, device=dev)
        l_run = torch.zeros((b, hkv, g, bq), device=dev)
        acc = torch.zeros((b, hkv, g, bq, hd), device=dev)
        for ki in range(nk):
            k_pos = ki * bk + torch.arange(bk, device=dev)
            sc = torch.einsum("bqkgd,btkd->bkgqt", qg[:, qi], kc[:, ki])
            valid = (k_pos[None, :] < t) & (q_pos[:, None] < s)
            if causal:
                valid &= k_pos[None, :] <= q_pos[:, None]
            if window:
                valid &= k_pos[None, :] > q_pos[:, None] - window
            sc = torch.where(valid, sc, NEG_INF)
            m_new = torch.maximum(m_run, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] \
                + torch.einsum("bkgqt,btkd->bkgqd", p, vc[:, ki])
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))          # (b,bq,hkv,g,hd)
    out = torch.cat(outs, dim=1).reshape(b, s_pad, h, hd)[:, :s]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# full-sequence (train / prefill) self-attention
# ---------------------------------------------------------------------------

def _project(x, w):
    return torch.einsum("bsd,dhk->bshk", x, w)


def self_attention(params, x, positions, *, n_kv_heads, rope_theta,
                   causal: bool = True, window: int = 0,
                   qk_norm: bool = False, norm_eps: float = 1e-6,
                   impl: str = "naive", block_q: int = 1024,
                   block_k: int = 1024, kernel_impl: Optional[str] = None):
    """x: (B,S,d) -> (B,S,d); also returns (k,v) for cache seeding.

    `impl` is the reference's attention implementation off the card
    ("naive" or "chunked").  `kernel_impl` routes causal attention like
    `ops.flash_attention`: None runs the flash kernel on CUDA tensors and
    `impl`'s plain math on CPU tensors, "kernel" insists on the kernel,
    "ref" forces `impl`'s plain math anywhere.  The kernel masks on row
    indices, which are the positions of a full sequence (forward and
    prefill pass `arange(S)`)."""
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if qk_norm:
        q = rms_norm(q, params["q_norm"], norm_eps)
        k = rms_norm(k, params["k_norm"], norm_eps)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    if causal and ops.route(x, kernel_impl) == "kernel":
        o = ops.flash_attention(q, k, v, causal=True, window=window,
                                impl="kernel")
    elif impl == "chunked" and causal:
        o = attend_chunked(q, k, v, causal=causal, window=window,
                           block_q=block_q, block_k=block_k)
    else:
        mask = causal_window_mask(positions, positions, window)[:, None] \
            if causal else None
        o = attend(q, k, v, mask)
    return torch.einsum("bshk,hkd->bsd", o, params["wo"]), (k, v)


# ---------------------------------------------------------------------------
# ring-buffer KV cache (decode)
# ---------------------------------------------------------------------------

def init_kv_cache(batch, n_kv_heads, head_dim, capacity, dtype,
                  device=None):
    """capacity = window for SWA archs, max_seq for full attention."""
    return {
        "k": torch.zeros((batch, capacity, n_kv_heads, head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((batch, capacity, n_kv_heads, head_dim),
                         dtype=dtype, device=device),
        "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                          device=device),
    }


def decode_attention(params, x, cache, cur_pos, *, rope_theta,
                     window: int = 0, qk_norm: bool = False,
                     norm_eps: float = 1e-6):
    """One-token decode: x (B,1,d), cur_pos (B,) absolute position.

    Writes (k,v) at slot cur_pos % capacity (ring), attends over all valid
    slots.  Returns (out (B,1,d), new_cache); the cache passed in is not
    modified."""
    b = x.shape[0]
    cap = cache["k"].shape[1]
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if qk_norm:
        q = rms_norm(q, params["q_norm"], norm_eps)
        k = rms_norm(k, params["k_norm"], norm_eps)
    pos = cur_pos[:, None]                     # (B,1)
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)

    idx = (torch.arange(b, device=x.device), torch.remainder(cur_pos, cap))
    new_k = cache["k"].index_put(idx, k[:, 0])
    new_v = cache["v"].index_put(idx, v[:, 0])
    new_pos = cache["pos"].index_put(idx, cur_pos.to(cache["pos"].dtype))

    valid = (new_pos >= 0) & (new_pos <= cur_pos[:, None])
    if window:
        valid = valid & (new_pos > cur_pos[:, None] - window)
    o = attend(q, new_k, new_v, valid[:, None, None, :])
    out = torch.einsum("bshk,hkd->bsd", o, params["wo"])
    return out, {"k": new_k, "v": new_v, "pos": new_pos}


def seed_kv_cache(cache, k, v, positions):
    """Write a prefill's (k,v) into the ring cache (last `cap` tokens)."""
    cap = cache["k"].shape[1]
    s = k.shape[1]
    take = min(cap, s)
    p_t = positions[:, -take:]
    idx = (torch.arange(k.shape[0], device=k.device)[:, None],
           torch.remainder(p_t, cap))
    return {
        "k": cache["k"].index_put(idx, k[:, -take:]),
        "v": cache["v"].index_put(idx, v[:, -take:]),
        "pos": cache["pos"].index_put(idx, p_t.to(cache["pos"].dtype)),
    }
