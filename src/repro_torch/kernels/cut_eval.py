"""Cut contractions: CUDA kernel wrappers and their plain versions.

    matvec(a, v)  = A @ v      (P,)    the forward cut contraction
    vecmat(g, a)  = g^T A      (D,)    the row reduction (the dv backward)
    rank1(x, y)   = x y^T      (P, D)  the outer product (the da backward)

Counterpart of `repro/kernels/cut_eval.py`.  Each wrapper takes f32 or
bf16 operands (mixed freely) and returns f32, accumulating in f32 as the
TPU kernels do.  A wrapper given CUDA tensors launches its kernel from
`csrc/cut_kernels.cu` on the current stream and counts the launch in
`LAUNCHES`; given CPU tensors it runs the plain version below, which
repeats the TPU kernel body's arithmetic in PyTorch.  There is no other
route: a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import collections
import functools

import torch

from repro_torch.kernels import build

# Kernel launches per wrapper since the last `reset_launches()`.
LAUNCHES: collections.Counter = collections.Counter()

_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    LAUNCHES.clear()


# ---------------------------------------------------------------------------
# plain versions (the CPU route and the on-card oracle)
# ---------------------------------------------------------------------------

def matvec_ref(a, v):
    return (a.float() * v.float()[None, :]).sum(dim=1)


def vecmat_ref(g, a):
    return (g.float()[:, None] * a.float()).sum(dim=0)


def rank1_ref(x, y):
    return x.float()[:, None] * y.float()[None, :]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, first, vec, vec_len):
    """Both operands f32/bf16, contiguous, on one device; `vec` 1-D of
    length `vec_len`."""
    tensors = (first, vec)
    for t in tensors:
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} is not f32 or bf16")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} "
                             "is not contiguous")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: operands on {tensors[0].device} and "
                             f"{t.device}")
    if vec.dim() != 1 or vec.shape[0] != vec_len:
        raise ValueError(f"{name}: vector of shape {tuple(vec.shape)}, "
                         f"expected ({vec_len},)")


def _launch(name, fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def _bf16(t) -> int:
    return int(t.dtype == torch.bfloat16)


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ticket counters of matvec and the fused round, one int32 per (device,
# stream), zeroed once; each kernel's last block resets it to 0 before it
# ends, and calls on one stream never overlap
_TICKETS: dict = {}


def _ticket(t):
    key = (t.device.index, _stream(t))
    ticket = _TICKETS.get(key)
    if ticket is None:
        ticket = _TICKETS[key] = torch.zeros(1, dtype=torch.int32,
                                             device=t.device)
    return ticket


def cut_grid(p: int, d: int, elem_size: int, sms: int):
    """(blocks, columns a block) of the one-launch matvec and vecmat on a
    card of `sms` SMs: at most two blocks per SM, each at least 512
    columns wide and, for more than two rows (the 8-row kernels), at
    least 256 threads x 16 bytes of each row, so every thread has a
    16-byte load (fewer, fuller blocks measured faster in bf16).  The
    width is a multiple of 8, so every block's slice of a D-vector stays
    16-byte aligned."""
    min_cols = 512 if p <= 2 else 256 * 16 // elem_size
    g = min(2 * sms, max(1, -(-d // min_cols)))
    cw = (-(-d // g) + 7) // 8 * 8
    return -(-d // cw), cw


@functools.lru_cache(maxsize=None)
def _cut_grid(device_index: int, p: int, d: int, elem_size: int):
    """`cut_grid` on this device, once per (device, P, D, type)."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return cut_grid(p, d, elem_size, sms)


def matvec(a, v):
    """a: (P, D), v: (D,) -> (P,) f32 raw contraction A @ v."""
    if a.dim() != 2 or a.shape[0] == 0 or a.shape[1] == 0:
        raise ValueError(f"matvec: matrix of shape {tuple(a.shape)}")
    p, d = a.shape
    _check("matvec", a, v, d)
    if a.device.type == "cpu":
        return matvec_ref(a, v)
    lib = build.load()
    with torch.cuda.device(a.device):
        blocks, cw = _cut_grid(a.device.index, p, d, a.element_size())
        partial = torch.empty((p, blocks), dtype=torch.float32,
                              device=a.device)
        out = torch.empty((p,), dtype=torch.float32, device=a.device)
        _launch("matvec", lib.cut_matvec, a.data_ptr(), _bf16(a),
                v.data_ptr(), _bf16(v), partial.data_ptr(),
                _ticket(a).data_ptr(), out.data_ptr(), p, d, blocks, cw,
                _stream(a))
    return out


def vecmat(g, a):
    """g: (P,), a: (P, D) -> (D,) f32 row reduction g^T A."""
    if a.dim() != 2 or a.shape[0] == 0 or a.shape[1] == 0:
        raise ValueError(f"vecmat: matrix of shape {tuple(a.shape)}")
    p, d = a.shape
    _check("vecmat", a, g, p)
    if a.device.type == "cpu":
        return vecmat_ref(g, a)
    lib = build.load()
    with torch.cuda.device(a.device):
        blocks, cw = _cut_grid(a.device.index, p, d, a.element_size())
        out = torch.empty((d,), dtype=torch.float32, device=a.device)
        _launch("vecmat", lib.cut_vecmat, g.data_ptr(), _bf16(g),
                a.data_ptr(), _bf16(a), out.data_ptr(), p, d, blocks, cw,
                _stream(a))
    return out


def rank1(x, y):
    """x: (P,), y: (D,) -> (P, D) f32 outer product x y^T."""
    if x.dim() != 1 or x.shape[0] == 0:
        raise ValueError(f"rank1: x of shape {tuple(x.shape)}")
    p = x.shape[0]
    if y.dim() != 1 or y.shape[0] == 0:
        raise ValueError(f"rank1: y of shape {tuple(y.shape)}")
    d = y.shape[0]
    _check("rank1", x, y, d)
    if x.device.type == "cpu":
        return rank1_ref(x, y)
    lib = build.load()
    with torch.cuda.device(x.device):
        out = torch.empty((p, d), dtype=torch.float32, device=x.device)
        _launch("rank1", lib.cut_rank1, x.data_ptr(), _bf16(x),
                y.data_ptr(), _bf16(y), out.data_ptr(), p, d, _stream(x))
    return out
