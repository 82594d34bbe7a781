"""One chunk of chunkwise-parallel mLSTM: CUDA kernel wrapper.

Counterpart of `repro/kernels/mlstm_chunk.py` (the Pallas kernel).  For
q/k/v (B,H,L,hd) (f32 or bf16, one type), log gates li/lf (B,H,L,1) f32
and the carried state c (B,H,hd,hd), n (B,H,1,hd), m (B,H,1,1) f32, it
returns the chunk's y (B,H,L,hd) in q's dtype and the end-of-chunk state
(c', n', m') in f32 (see `ref.mlstm_chunk_ref`, the plain version).
Given CUDA tensors, `mlstm_chunk` launches the two-launch kernel of
`csrc/mlstm_chunk.cu` on the current stream and counts the call in
`cut_eval.LAUNCHES["mlstm_chunk"]`; given CPU tensors it runs the plain
version.  There is no other route: a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cut_eval as _kern
from repro_torch.kernels import ref

_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, li, lf, c, n, m):
    if q.dim() != 4 or 0 in q.shape:
        raise ValueError(f"mlstm_chunk: q of shape {tuple(q.shape)}")
    b, h, l, hd = q.shape
    want = {"k": (b, h, l, hd), "v": (b, h, l, hd), "li": (b, h, l, 1),
            "lf": (b, h, l, 1), "c": (b, h, hd, hd), "n": (b, h, 1, hd),
            "m": (b, h, 1, 1)}
    got = {"k": k, "v": v, "li": li, "lf": lf, "c": c, "n": n, "m": m}
    for name, t in {"q": q, **got}.items():
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"mlstm_chunk: {name} of shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
        if name in ("q", "k", "v"):
            if t.dtype not in _DTYPES or t.dtype != q.dtype:
                raise TypeError(f"mlstm_chunk: {name} dtype {t.dtype}; q, k "
                                "and v must all be f32 or all bf16")
        elif t.dtype != torch.float32:
            raise TypeError(f"mlstm_chunk: {name} dtype {t.dtype} is not f32")
        if not t.is_contiguous():
            raise ValueError(f"mlstm_chunk: {name} is not contiguous")
        if t.device != q.device:
            raise ValueError(f"mlstm_chunk: {name} on {t.device}, q on "
                             f"{q.device}")


def mlstm_chunk(q, k, v, li, lf, c, n, m):
    """One chunk for all (batch, head) pairs -> (y, c', n', m')."""
    _check(q, k, v, li, lf, c, n, m)
    if q.device.type == "cpu":
        return ref.mlstm_chunk_ref(q, k, v, li, lf, c, n, m)
    lib = build.load()
    b, h, l, hd = q.shape
    if hd > lib.mlstm_chunk_max_head_dim() or l > lib.mlstm_chunk_max_len():
        raise ValueError(f"mlstm_chunk: chunk of {l} with head dim {hd}; the "
                         f"kernel takes at most {lib.mlstm_chunk_max_len()} "
                         f"and {lib.mlstm_chunk_max_head_dim()}")
    with torch.cuda.device(q.device):
        y = torch.empty_like(q)
        c2, n2, m2 = (torch.empty_like(t) for t in (c, n, m))
        _kern._launch("mlstm_chunk", lib.mlstm_chunk,
                      *(t.data_ptr() for t in (q, k, v, li, lf, c, n, m, y,
                                               c2, n2, m2)),
                      _kern._bf16(q), b * h, l, hd, 1.0 / math.sqrt(hd),
                      _kern._stream(q))
    return y, c2, n2, m2
