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

Each wrapper also takes R problems at once, every operand with a leading
run axis (the sweep engine's; `cut_ad`'s vmap rules call these forms):

    matvec(a (R, P, D), v (R, D))  -> (R, P)
    vecmat(g (R, P), a (R, P, D))  -> (R, D)
    rank1(x (R, P), y (R, D))      -> (R, P, D)

On the card that is one launch of the `*_runs` kernel (counted as
"matvec_runs" etc.), the run index a grid dimension: each run's slice
must be contiguous, and the run stride is free, so an operand broadcast
over the runs by `expand` (stride 0) is never copied.  Each run takes
the single-run grid and kernel body (matvec's with v's slices fetched
ahead of A's loads), so row r is bitwise the single-run kernel on run r.
R = 1 takes the single-run kernel.
"""
from __future__ import annotations

import collections
import functools

import torch

from repro_torch.kernels import build

# Kernel launches per wrapper since the last `reset_launches()`.
LAUNCHES: collections.Counter = collections.Counter()

_DTYPES = (torch.float32, torch.bfloat16)


# Counters of the work a kernel would do on meta tensors: each has
# `kernel_work(name, flops, nbytes)` (`launch.roofline.Counter` adds
# itself while it is active).
WORK_SINKS: list = []


def reset_launches() -> None:
    LAUNCHES.clear()


def meta_work(name: str, flops: int, nbytes: int) -> None:
    """Report a kernel's work on meta tensors, where nothing is built or
    launched, to every active counter."""
    for sink in WORK_SINKS:
        sink.kernel_work(name, flops, nbytes)


# ---------------------------------------------------------------------------
# plain versions (the CPU route and the on-card oracle)
# ---------------------------------------------------------------------------

def matvec_ref(a, v):
    return (a.float() * v.float().unsqueeze(-2)).sum(dim=-1)


def vecmat_ref(g, a):
    return (g.float().unsqueeze(-1) * a.float()).sum(dim=-2)


def rank1_ref(x, y):
    return x.float().unsqueeze(-1) * y.float().unsqueeze(-2)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, first, vec, vec_len, runs=None):
    """Both operands f32/bf16, on one device; `vec` of length `vec_len`,
    1-D, or 2-D with `runs` rows for a batched call.  Each operand's
    slice of a run is contiguous (a single operand: contiguous)."""
    tensors = (first, vec)
    for t in tensors:
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} is not f32 or bf16")
        inner = t if runs is None else t[0]
        if not inner.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} "
                             "is not contiguous"
                             + ("" if runs is None else " within a run"))
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: operands on {tensors[0].device} and "
                             f"{t.device}")
    want = (vec_len,) if runs is None else (runs, vec_len)
    if tuple(vec.shape) != want:
        raise ValueError(f"{name}: vector of shape {tuple(vec.shape)}, "
                         f"expected {want}")


def _matrix(name, a, batched):
    """(P, D) of a matrix operand, (P, D) or (R, P, D) as `batched` says,
    none of them empty."""
    if a.dim() != (3 if batched else 2) or 0 in a.shape:
        raise ValueError(f"{name}: matrix of shape {tuple(a.shape)}")
    return a.shape[-2], a.shape[-1]


def _launch(name, fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    LAUNCHES[name] += 1


def forward_only(name: str, tensors) -> None:
    """Raise if a gradient could flow through any of `tensors`: one that
    requires grad while grad mode is on, or one wrapped by a `torch.func`
    transform.  The attention and mLSTM kernels write raw pointers into
    fresh outputs, so such an output would carry no gradient and the
    kernel's share of it would vanish without an error; they compute
    forwards only, as the reference's Pallas kernels do."""
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    for t in tensors:
        if (t.requires_grad and torch.is_grad_enabled()) or wrapped(t):
            raise RuntimeError(
                f"{name}: the kernel computes a forward only and cannot be "
                "differentiated; run the plain math (impl=\"ref\") under "
                "autograd or torch.func, or call it under torch.no_grad()")


def _bf16(t) -> int:
    return int(t.dtype == torch.bfloat16)


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ticket counters of matvec and the fused round (batched: one per run),
# int32s per (device, stream), zeroed once and grown on demand; each
# kernel's last block resets its counter to 0 before it ends, and calls
# on one stream never overlap
_TICKETS: dict = {}


def _ticket(t, n: int = 1):
    """The first `n` counters of t's device and current stream."""
    key = (t.device.index, _stream(t))
    tickets = _TICKETS.get(key)
    if tickets is None or tickets.numel() < n:
        tickets = _TICKETS[key] = torch.zeros(
            max(n, 2 * (0 if tickets is None else tickets.numel())),
            dtype=torch.int32, device=t.device)
    return tickets[:n]


def _runs_stride(t) -> int:
    """Elements between the runs of a batched operand (0 if shared)."""
    return t.stride(0) if t.shape[0] > 1 else 0


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
    """a: (P, D), v: (D,) -> (P,) f32 raw contraction A @ v; or R runs
    at once, a: (R, P, D), v: (R, D) -> (R, P)."""
    batched = a.dim() == 3
    p, d = _matrix("matvec", a, batched)
    runs = a.shape[0] if batched else None
    _check("matvec", a, v, d, runs)
    if a.device.type == "cpu":
        return matvec_ref(a, v)
    if runs == 1:
        return matvec(a[0], v[0])[None]
    lib = build.load()
    with torch.cuda.device(a.device):
        blocks, cw = _cut_grid(a.device.index, p, d, a.element_size())
        if not batched:
            partial = torch.empty((p, blocks), dtype=torch.float32,
                                  device=a.device)
            out = torch.empty((p,), dtype=torch.float32, device=a.device)
            _launch("matvec", lib.cut_matvec, a.data_ptr(), _bf16(a),
                    v.data_ptr(), _bf16(v), partial.data_ptr(),
                    _ticket(a).data_ptr(), out.data_ptr(), p, d, blocks, cw,
                    _stream(a))
            return out
        partial = torch.empty((runs, p, blocks), dtype=torch.float32,
                              device=a.device)
        out = torch.empty((runs, p), dtype=torch.float32, device=a.device)
        _launch("matvec_runs", lib.cut_matvec_runs, a.data_ptr(), _bf16(a),
                _runs_stride(a), v.data_ptr(), _bf16(v), _runs_stride(v),
                partial.data_ptr(), _ticket(a, runs).data_ptr(),
                out.data_ptr(), runs, p, d, blocks, cw, _stream(a))
    return out


def vecmat(g, a):
    """g: (P,), a: (P, D) -> (D,) f32 row reduction g^T A; or R runs at
    once, g: (R, P), a: (R, P, D) -> (R, D) (rows 16-byte aligned: a
    view of a (R, D rounded up to 4) buffer)."""
    batched = a.dim() == 3
    p, d = _matrix("vecmat", a, batched)
    runs = a.shape[0] if batched else None
    _check("vecmat", a, g, p, runs)
    if a.device.type == "cpu":
        return vecmat_ref(g, a)
    if runs == 1:
        return vecmat(g[0], a[0])[None]
    lib = build.load()
    with torch.cuda.device(a.device):
        blocks, cw = _cut_grid(a.device.index, p, d, a.element_size())
        if not batched:
            out = torch.empty((d,), dtype=torch.float32, device=a.device)
            _launch("vecmat", lib.cut_vecmat, g.data_ptr(), _bf16(g),
                    a.data_ptr(), _bf16(a), out.data_ptr(), p, d, blocks,
                    cw, _stream(a))
            return out
        ld = -(-d // 4) * 4
        out = torch.empty((runs, ld), dtype=torch.float32, device=a.device)
        _launch("vecmat_runs", lib.cut_vecmat_runs, g.data_ptr(), _bf16(g),
                _runs_stride(g), a.data_ptr(), _bf16(a), _runs_stride(a),
                out.data_ptr(), ld, runs, p, d, blocks, cw, _stream(a))
    return out[:, :d]


def rank1(x, y):
    """x: (P,), y: (D,) -> (P, D) f32 outer product x y^T; or R runs at
    once, x: (R, P), y: (R, D) -> (R, P, D)."""
    batched = x.dim() == 2
    if x.dim() != (2 if batched else 1) or 0 in x.shape:
        raise ValueError(f"rank1: x of shape {tuple(x.shape)}")
    if y.dim() != x.dim() or 0 in y.shape:
        raise ValueError(f"rank1: y of shape {tuple(y.shape)}")
    p, d = x.shape[-1], y.shape[-1]
    runs = x.shape[0] if batched else None
    _check("rank1", x, y, d, runs)
    if x.device.type == "cpu":
        return rank1_ref(x, y)
    if runs == 1:
        return rank1(x[0], y[0])[None]
    lib = build.load()
    with torch.cuda.device(x.device):
        if not batched:
            out = torch.empty((p, d), dtype=torch.float32, device=x.device)
            _launch("rank1", lib.cut_rank1, x.data_ptr(), _bf16(x),
                    y.data_ptr(), _bf16(y), out.data_ptr(), p, d,
                    _stream(x))
            return out
        out = torch.empty((runs, p, d), dtype=torch.float32,
                          device=x.device)
        _launch("rank1_runs", lib.cut_rank1_runs, x.data_ptr(), _bf16(x),
                _runs_stride(x), y.data_ptr(), _bf16(y), _runs_stride(y),
                out.data_ptr(), runs, p, d, _stream(x))
    return out
