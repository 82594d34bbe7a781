"""Mamba selective-SSM sequence mixer (Jamba's recurrent block).

Counterpart of `repro/models/mamba.py`.  Training and prefill run a
chunked parallel scan: a Python loop over chunks carries the (conv,
ssm) state, and inside a chunk a log-depth inclusive scan over the
positions (Hillis-Steele, log2(L) steps of the reference's combine
(a1 a2, a2 b1 + b2)) stands for the reference's
`jax.lax.associative_scan`.  Its products come in another order than
XLA's, so across packages the scan agrees to rounding, not bit for bit.
Decode carries (conv_state, ssm_state) and costs O(1) per token.  All of
it is plain torch, as the reference's is plain jnp.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, zeros


def mamba_init(generator, d, expand: int, d_state: int, d_conv: int, dtype,
               device=None, lead: Sequence[int] = ()):
    di = expand * d
    kw = dict(device=device, lead=lead)
    # S4D-real init: a_log[c, s] = log(s + 1)
    a_log = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32,
                                   device=device)).expand(*lead, di, d_state)
    return {
        "in_proj": dense_init(generator, (d, 2 * di), dtype, fan_in=d, **kw),
        "conv_w": dense_init(generator, (d_conv, di), dtype, fan_in=d_conv,
                             **kw),
        "conv_b": zeros((di,), dtype, **kw),
        "xproj": dense_init(generator, (di, 2 * d_state + 1), dtype,
                            fan_in=di, **kw),
        "dt_bias": torch.full((*lead, di), -4.6, dtype=dtype,
                              device=device),   # softplus^-1(0.01)
        "a_log": a_log.contiguous(),
        "d_skip": torch.ones((*lead, di), dtype=torch.float32,
                             device=device),
        "out_proj": dense_init(generator, (di, d), dtype, fan_in=di, **kw),
    }


def _softplus(x):
    """jax.nn.softplus: log(1 + e^x) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B,S,di), w: (K,di).

    state: (B,K-1,di) carried context (decode/chunk boundary) or None.
    Returns (y, new_state)."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)                   # (B, S+K-1, di)
    y = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(k)) + b
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return y, new_state


def _ssm_params(params, xc):
    """xc: (B,L,di) post-conv activations -> (delta_a, delta_bx, c)."""
    proj = xc @ params["xproj"]
    d_state = (proj.shape[-1] - 1) // 2
    # rank-1 dt: shared scalar per position, per-channel bias, softplus
    dt = _softplus(proj[..., 0][..., None] + params["dt_bias"])
    bmat = proj[..., 1:1 + d_state].float()                   # (B,L,dS)
    cmat = proj[..., 1 + d_state:].float()                    # (B,L,dS)
    a = -torch.exp(params["a_log"])                           # (di,dS)
    dt = dt.float()                                           # (B,L,di)
    delta_a = torch.exp(dt[..., None] * a[None, None])        # (B,L,di,dS)
    delta_bx = (dt * xc.float())[..., None] \
        * bmat[..., None, :]                                  # (B,L,di,dS)
    return delta_a, delta_bx, cmat


def scan_steps(length: int) -> int:
    """The log-depth scan's steps over a chunk of `length` positions."""
    return math.ceil(math.log2(length)) if length > 1 else 0


def _chunk_scan(delta_a, delta_bx, h0):
    """Inclusive scan over axis 1 with carry-in h0, in log2(L) steps:
    step j combines each position with the one 2^j before it,
    (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2).  Returns (h, h_last)."""
    a, b = delta_a, delta_bx
    length = a.shape[1]
    for j in range(scan_steps(length)):
        s = 1 << j
        b = torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1)
        a = torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], dim=1)
    h = a * h0[:, None] + b                               # (B,L,di,dS)
    return h, h[:, -1]


def n_chunks_of(s: int, chunk: int) -> int:
    """The reference's chunking: max(1, S // chunk) chunks of equal
    length, or a ValueError where S does not split so (the reference's
    reshape fails there)."""
    n = max(1, s // chunk)
    if s % n:
        raise ValueError(f"mamba: a sequence of {s} does not split into "
                         f"{n} equal chunks (chunk {chunk}); the reference "
                         "refuses it too")
    return n


def mamba_apply(params, x, chunk: int = 256, state=None
                ) -> Tuple[torch.Tensor, dict]:
    """x: (B,S,d) -> (y (B,S,d), state dict {"conv", "ssm"})."""
    b, s, d = x.shape
    xi, z = torch.chunk(x @ params["in_proj"], 2, dim=-1)   # (B,S,di) each
    di = xi.shape[-1]
    d_state = params["a_log"].shape[1]
    if state is None:
        conv_state = x.new_zeros((b, params["conv_w"].shape[0] - 1, di))
        h0 = torch.zeros((b, di, d_state), dtype=torch.float32,
                         device=x.device)
    else:
        conv_state, h0 = state["conv"], state["ssm"]

    n = n_chunks_of(s, chunk)
    length = s // n
    ys = []
    for c in range(n):
        xc, conv_state = _causal_conv(xi[:, c * length:(c + 1) * length],
                                      params["conv_w"], params["conv_b"],
                                      conv_state)
        xc = F.silu(xc)
        da, dbx, cmat = _ssm_params(params, xc)
        h, h0 = _chunk_scan(da, dbx, h0)
        del da, dbx
        y = torch.einsum("blds,bls->bld", h, cmat)          # (B,L,di)
        del h
        y = y + params["d_skip"] * xc.float()
        ys.append(y.to(x.dtype))
    y = torch.cat(ys, dim=1) * F.silu(z)
    return y @ params["out_proj"], {"conv": conv_state, "ssm": h0}


def mamba_decode(params, x, state) -> Tuple[torch.Tensor, dict]:
    """One-token decode; x: (B,1,d)."""
    xi, z = torch.chunk(x @ params["in_proj"], 2, dim=-1)
    xc, conv_state = _causal_conv(xi, params["conv_w"], params["conv_b"],
                                  state["conv"])
    xc = F.silu(xc)
    da, dbx, cmat = _ssm_params(params, xc)             # (B,1,di,dS)
    h = da[:, 0] * state["ssm"] + dbx[:, 0]             # (B,di,dS)
    y = torch.einsum("bds,bs->bd", h, cmat[:, 0])[:, None]
    y = y + params["d_skip"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    return y @ params["out_proj"], {"conv": conv_state, "ssm": h}


def init_mamba_state(batch, d, expand, d_state, d_conv, dtype, device=None):
    di = expand * d
    return {"conv": torch.zeros((batch, d_conv - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, d_state), dtype=torch.float32,
                               device=device)}
