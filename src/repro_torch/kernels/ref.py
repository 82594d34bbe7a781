"""Plain PyTorch versions of the LLM kernels, in the kernels' layouts.

Counterpart of `repro/kernels/ref.py` `flash_attention_ref` and
`mlstm_chunk_ref`: the CPU route of `ops.flash_attention` /
`ops.mlstm_chunk` and the oracle the CUDA kernels are held to on the
card.  They are the model's own math (`models.attention.attend`,
`models.xlstm.mlstm_chunk_body`), adapted to the kernels' layouts.
"""
from __future__ import annotations

import torch

# module imports: models.attention imports kernels.ops, which imports
# this module, so the functions are looked up when called
from repro_torch.models import attention as _attn
from repro_torch.models import xlstm as _xlstm


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0):
    """q: (B,S,H,hd), k/v: (B,T,Hkv,hd) -> (B,S,H,hd) in q's dtype.

    Causal inputs are masked on absolute positions (key <= query, and
    query - key < window when window > 0); non-causal inputs are not
    masked at all, the window included, as in the reference oracle."""
    s, t = q.shape[1], k.shape[1]
    mask = None
    if causal:
        q_pos = torch.arange(s, device=q.device)[None]
        k_pos = torch.arange(t, device=q.device)[None]
        mask = _attn.causal_window_mask(q_pos, k_pos, window)
        mask = mask.expand((q.shape[0],) + mask.shape[1:])[:, None]
    return _attn.attend(q, k, v, mask)


def mlstm_chunk_ref(q, k, v, li, lf, c, n, m):
    """Same layout as `ops.mlstm_chunk`: q/k/v (B,H,L,hd), li/lf
    (B,H,L,1), state c (B,H,hd,hd) / n (B,H,1,hd) / m (B,H,1,1) ->
    (y (B,H,L,hd) in q's dtype, c', n', m' f32)."""
    def to_blh(a):
        return a.transpose(1, 2)

    state = {"c": c, "n": n[:, :, 0], "m": m[:, :, 0, 0]}
    y, st = _xlstm.mlstm_chunk_body(
        to_blh(q), to_blh(k), to_blh(v), to_blh(li[..., 0]),
        to_blh(lf[..., 0]), state)
    return (to_blh(y).to(q.dtype), st["c"], st["n"][:, :, None],
            st["m"][:, :, None, None])
