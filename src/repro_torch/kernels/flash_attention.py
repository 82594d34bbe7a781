"""Blockwise (flash) GQA attention forward: CUDA kernel wrapper.

Counterpart of `repro/kernels/flash_attention.py` (the Pallas kernel).
q (B,S,H,hd) and k/v (B,T,Hkv,hd), all f32 or all bf16, give the
attention output (B,S,H,hd) in q's dtype, with the causal and
sliding-window masks on absolute positions (see
`ref.flash_attention_ref`, the plain version).  Given CUDA tensors,
`flash_attention` launches the kernel of `csrc/flash_attention.cu` on
the current stream and counts the launch in
`cut_eval.LAUNCHES["flash_attention"]`; given CPU tensors it runs the
plain version.  There is no other route: a CUDA tensor launches the
kernel or raises.  Ragged S and T need no padding.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cut_eval as _kern
from repro_torch.kernels import ref

_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or 0 in t.shape:
            raise ValueError(f"flash_attention: {name} of shape "
                             f"{tuple(t.shape)}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} dtype {t.dtype}; q, "
                            "k and v must all be f32 or all bf16")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    b, _, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} query heads do not group "
                         f"over {k.shape[2]} kv heads")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B,S,H,hd), k/v: (B,T,Hkv,hd) -> (B,S,H,hd) in q's dtype."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    lib = build.load()
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if hd > lib.flash_attention_max_head_dim():
        raise ValueError(f"flash_attention: head dim {hd}, the kernel takes "
                         f"at most {lib.flash_attention_max_head_dim()}")
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        _kern._launch("flash_attention", lib.flash_attention, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      _kern._bf16(q), b, s, t, h, hkv, hd, int(causal),
                      int(window), 1.0 / math.sqrt(hd), _kern._stream(q))
    return out
