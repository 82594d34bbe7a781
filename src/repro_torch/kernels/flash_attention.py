"""Blockwise (flash) GQA attention forward: CUDA kernel wrappers.

Counterpart of `repro/kernels/flash_attention.py` (the Pallas kernel).
q (B,S,H,hd) and k/v (B,T,Hkv,hd), all f32 or all bf16, give the
attention output (B,S,H,hd) in q's dtype, with the causal and
sliding-window masks on absolute positions (see
`ref.flash_attention_ref`, the plain version).  Two hand-written kernels
compute it, chosen by `flash_route` from the dtype and head dim alone:

- "flash_attention": bf16 at head dims 64 and 128, on the tensor cores
  (`csrc/flash_attention_sm90.cu`: wgmma, TMA, an mbarrier ring);
- "flash_attention_simt": everything else (f32, where the tensor cores
  would round to TF32, and bf16 at other head dims), on the CUDA cores
  (`csrc/flash_attention.cu`).

Given CUDA tensors, `flash_attention` launches the routed kernel on the
current stream and counts the launch in `cut_eval.LAUNCHES` under the
route's name; given CPU tensors it runs the plain version.  There is no
other route and no fallback: a CUDA tensor launches the routed kernel or
raises.  Ragged S and T need no padding.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cut_eval as _kern
from repro_torch.kernels import ref

_DTYPES = (torch.float32, torch.bfloat16)
# head dims of the tensor-core kernel's template instances
SM90_HEAD_DIMS = (64, 128)


def flash_route(dtype, hd: int) -> str:
    """The kernel that CUDA tensors of this dtype and head dim launch."""
    if dtype == torch.bfloat16 and hd in SM90_HEAD_DIMS:
        return "flash_attention"
    return "flash_attention_simt"


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
    name = flash_route(q.dtype, hd)
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        args = (b, s, t, h, hkv, hd, int(causal), int(window),
                1.0 / math.sqrt(hd), _kern._stream(q))
        if name == "flash_attention":
            # TMA reads from 16-byte-aligned addresses only
            for n, x in (("q", q), ("k", k), ("v", v)):
                if x.data_ptr() % 16:
                    raise ValueError(f"flash_attention: {n} is not 16-byte "
                                     "aligned")
            _kern._launch(name, lib.flash_attention_sm90, q.data_ptr(),
                          k.data_ptr(), v.data_ptr(), out.data_ptr(), *args)
        else:
            if hd > lib.flash_attention_simt_max_head_dim():
                raise ValueError(
                    f"flash_attention: head dim {hd}, the kernel takes at "
                    f"most {lib.flash_attention_simt_max_head_dim()}")
            _kern._launch(name, lib.flash_attention_simt, q.data_ptr(),
                          k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          _kern._bf16(q), *args)
    return out
