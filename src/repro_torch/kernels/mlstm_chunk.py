"""One chunk of chunkwise-parallel mLSTM: CUDA kernel wrapper.

Counterpart of `repro/kernels/mlstm_chunk.py` (the Pallas kernel).  For
q/k/v (B,H,L,hd) (f32 or bf16, one type), log gates li/lf (B,H,L,1) f32
and the carried state c (B,H,hd,hd), n (B,H,1,hd), m (B,H,1,1) f32, it
returns the chunk's y (B,H,L,hd) in q's dtype and the end-of-chunk state
(c', n', m') in f32 (see `ref.mlstm_chunk_ref`, the plain version).
Three hand-written kernels compute it, chosen by `mlstm_route` from the dtype,
head dim and chunk length:

- "mlstm_chunk": bf16 at head dims 64, 128 and 192 and chunks of at
  most 512, on the tensor cores (`csrc/mlstm_chunk_sm90.cu`: wgmma, TMA,
  one launch; its gates live in shared memory);
- "mlstm_chunk_f32": f32 at the same head dims and chunk lengths, on
  the tensor cores (`csrc/mlstm_chunk_sm90_f32.cu`: every product as
  three TF32 products of hi / lo halves, which keeps f32's accuracy; one
  launch);
- "mlstm_chunk_simt": everything else (other head dims or longer
  chunks), on the CUDA cores (`csrc/mlstm_chunk.cu`, two launches).

Given CUDA tensors, `mlstm_chunk` launches the routed kernel on the
current stream and counts the call in `cut_eval.LAUNCHES` under the
route's name; given CPU tensors it runs the plain version.  There is no
other route and no fallback: a CUDA tensor launches the routed kernel or
raises.  Given meta tensors (the dry-run's), it builds and launches
nothing: it reports the routed kernel's `work` to the active counters
(`cut_eval.meta_work`) and returns empty outputs.  Ragged L needs no
padding.  The kernels are forward-only: a
CUDA tensor that a gradient can flow through (one that requires grad in
grad mode, or one inside a `torch.func` transform) raises
(`cut_eval.forward_only`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cut_eval as _kern
from repro_torch.kernels import ref

_DTYPES = (torch.float32, torch.bfloat16)
# head dims of the tensor-core kernels' template instances, and the
# longest chunk they take (kMaxLen of csrc/mlstm_chunk_sm90.cu and
# csrc/mlstm_chunk_sm90_f32.cu)
SM90_HEAD_DIMS = (64, 128, 192)
SM90_MAX_LEN = 512
# the tensor-core routes and their C entries
_TMA_ENTRIES = {"mlstm_chunk": "mlstm_chunk_sm90",
                "mlstm_chunk_f32": "mlstm_chunk_sm90_f32"}


def mlstm_route(dtype, hd: int, l: int) -> str:
    """The kernel that CUDA tensors of this dtype, head dim and chunk
    length launch."""
    if hd in SM90_HEAD_DIMS and l <= SM90_MAX_LEN:
        if dtype == torch.bfloat16:
            return "mlstm_chunk"
        if dtype == torch.float32:
            return "mlstm_chunk_f32"
    return "mlstm_chunk_simt"


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


def work(q_shape, dtype):
    """(FLOPs, bytes) of one chunk (`chip_smoke.mlstm_work`'s counts):
    q k^T and p v over the causal pairs, k^T v, q C and q . n; q/k/v,
    the gates and the state read once, y and the new state written
    once."""
    b, h, l, hd = q_shape
    es = dtype.itemsize
    bh = b * h
    flops = bh * (4 * hd * l * (l + 1) // 2 + 4 * l * hd * hd + 4 * l * hd)
    nbytes = bh * (4 * l * hd * es + 2 * l * 4 + 2 * (hd * hd + hd + 1) * 4)
    return flops, nbytes


def mlstm_chunk(q, k, v, li, lf, c, n, m):
    """One chunk for all (batch, head) pairs -> (y, c', n', m')."""
    _check(q, k, v, li, lf, c, n, m)
    if q.device.type == "cpu":
        return ref.mlstm_chunk_ref(q, k, v, li, lf, c, n, m)
    _kern.forward_only("mlstm_chunk", (q, k, v, li, lf, c, n, m))
    if q.is_meta:
        b, h, l, hd = q.shape
        _kern.meta_work(mlstm_route(q.dtype, hd, l), *work(q.shape, q.dtype))
        return (torch.empty_like(q),
                *(torch.empty_like(t) for t in (c, n, m)))
    lib = build.load()
    b, h, l, hd = q.shape
    name = mlstm_route(q.dtype, hd, l)
    if name == "mlstm_chunk_simt" and (
            hd > lib.mlstm_chunk_simt_max_head_dim()
            or l > lib.mlstm_chunk_simt_max_len()):
        raise ValueError(f"mlstm_chunk: chunk of {l} with head dim {hd}; the "
                         f"{name} kernel takes at most "
                         f"{lib.mlstm_chunk_simt_max_len()} and "
                         f"{lib.mlstm_chunk_simt_max_head_dim()}")
    with torch.cuda.device(q.device):
        y = torch.empty_like(q)
        c2, n2, m2 = (torch.empty_like(t) for t in (c, n, m))
        ptrs = [t.data_ptr() for t in (q, k, v, li, lf, c, n, m, y, c2, n2,
                                       m2)]
        args = (b * h, l, hd, 1.0 / math.sqrt(hd), _kern._stream(q))
        if name in _TMA_ENTRIES:
            # TMA and the 16-byte loads of C (and, in f32, of n) need
            # 16-byte-aligned addresses
            for nm, x in (("q", q), ("k", k), ("v", v), ("c", c), ("n", n)):
                if x.data_ptr() % 16:
                    raise ValueError(f"mlstm_chunk: {nm} is not 16-byte "
                                     "aligned")
            _kern._launch(name, getattr(lib, _TMA_ENTRIES[name]), *ptrs,
                          *args)
        else:
            _kern._launch(name, lib.mlstm_chunk_simt, *ptrs, _kern._bf16(q),
                          *args)
    return y, c2, n2, m2
