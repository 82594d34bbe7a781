"""One fused level-2 inner-ADMM cut round: CUDA kernel wrapper and its
plain version.

Counterpart of `repro/kernels/inner_round.py` (the Pallas kernel) and of
`_fused_round_math` / `_fused_round_ref` in `repro/kernels/ops.py`.  For
the cut matrix A (P, D), the flattened point v at the old z2, the
non-cut part of the master gradient `g_other` and the z2-column selector
`mask` (both (D,), zero off the z2 columns), and the cut rows c, active,
s, gamma (P,):

    cv0    = (A v - c) * active
    w      = (gamma + rho2 (cv0 + s) * active) * active
    v_new  = v - eta_z (g_other + (w^T A) * mask)
    cv1    = (A v_new - c) * active
    s'     = max(0, s - eta_s (gamma + rho2 (cv1 + s)) * active) * active
    gamma' = max(0, gamma + eta_dual (cv1 + s')) * active

`fused_cut_round` given CUDA tensors launches the kernel of
`csrc/inner_round.cu` on the current stream, one cooperative launch a
call, and counts it in `cut_eval.LAUNCHES["fused_round"]`; given CPU
tensors it runs the plain version.  There is no other route: a CUDA
tensor launches the kernel or raises.  `round_plan` sizes the launch once
per (device, P, D, type): one or two blocks per SM, each owning a slice
of D whose part of A the kernel holds in shared memory across its one
grid-wide barrier when the slices fit (A is then read from device memory
once), and streams from device memory when they do not.  The autograd
Function around it is `ops.FusedRound`.

R rounds at once take every operand with a leading run axis (A (R, P,
D), the vectors (R, D), the rows (R, P); each run's slice contiguous,
the run stride free, so an operand shared by `expand` is not copied) and
return every output with it.  On the card that is one cooperative launch
of the batched kernel (`LAUNCHES["fused_round_runs"]`), planned for the R
runs together: A stays on chip only where R x blocks fit resident with
their shared memory.  Each run is the single-run kernel at that plan's
partition of D, bit for bit.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cut_eval as _kern


def fused_round_math(mv, vm, a, v, g_other, mask, c, active, s, gamma,
                     eta_z, eta_s, eta_dual, rho2):
    """The round on abstract contractions mv(A, x) = A x and
    vm(g, A) = g^T A: the plain version with plain products, the
    backward of `ops.FusedRound` with the kernel-backed `cut_ad`
    Functions.  `torch.maximum` against a zero tensor splits the gradient
    at ties, as `jnp.maximum` does."""
    zero = torch.zeros_like(s)
    cv0 = (mv(a, v) - c) * active
    viol = (cv0 + s) * active
    w = (gamma + rho2 * viol) * active
    v_new = v - eta_z * (g_other + vm(w, a) * mask)
    cv1 = (mv(a, v_new) - c) * active
    g_s = (gamma + rho2 * (cv1 + s)) * active
    s_new = torch.maximum(zero, s - eta_s * g_s) * active
    gamma_new = torch.maximum(zero, gamma + eta_dual * (cv1 + s_new)) \
        * active
    return v_new, cv1, s_new, gamma_new


def fused_cut_round_ref(a, v, g_other, mask, c, active, s, gamma, *,
                        eta_z, eta_s, eta_dual, rho2):
    """The plain version: the round on the plain cut contractions, f32
    whatever A's type (the CPU route and the on-card oracle)."""
    return fused_round_math(_kern.matvec_ref, _kern.vecmat_ref, a,
                            v.float(), g_other.float(), mask.float(), c,
                            active, s, gamma, eta_z, eta_s, eta_dual, rho2)


# cut rows the kernel takes (csrc/inner_round.cu kMaxRows)
MAX_ROWS = 4096
# mbarriers over A's rows (kMaxPieces)
_MAX_PIECES = 32
# a block spans at least one column per thread (256 threads)
MIN_COLS = 256


class RoundPlan(NamedTuple):
    """One launch of the round: `blocks` blocks of `cw` columns (the last
    may be narrower), A's slices held in shared memory (`on_chip`) or
    streamed, `smem` bytes of dynamic shared memory a block."""
    blocks: int
    cw: int
    on_chip: bool
    smem: int


def _r16(x: int) -> int:
    return -(-x // 16) * 16


def round_smem(p: int, cw: int, elem_size: int, on_chip: bool) -> int:
    """Dynamic shared memory of a block (the kernel's `layout_of`): the
    mbarriers and the weights w, and on chip the slices of v, g_other,
    mask and v_new (cw + 4 floats each) and of A's P rows (cw entries and
    16 bytes each)."""
    rows_per_piece = -(-p // _MAX_PIECES)
    n_pieces = -(-p // rows_per_piece)
    w = _r16(8 * (2 + n_pieces)) if on_chip else 0
    vec = w + _r16(4 * p)
    if not on_chip:
        return vec
    return vec + 16 * (cw + 4) + p * (cw * elem_size + 16)


def round_plan(p: int, d: int, elem_size: int, sms: int,
               occupancy: Callable[[bool, int], int],
               runs: int = 1) -> RoundPlan:
    """The launch for `runs` rounds of A (P, D) with `elem_size`-byte
    entries on a card of `sms` SMs, where `occupancy(on_chip, smem)` is
    the number of blocks of that branch an SM holds with `smem` bytes (0
    if none); `blocks` is per run.  On chip where the runs' slices fit at
    two blocks per SM, else at one; else streaming.  Every block's slice
    starts at a multiple of 8 columns, so the slices of v, g_other, mask
    and v_new stay 16-byte aligned; the cooperative launch needs every
    block of every run resident at once, so a plan that cannot be raises
    here rather than hang the barrier."""
    if not 1 <= p <= MAX_ROWS:
        raise ValueError(f"fused_cut_round: {p} cut rows, the kernel takes "
                         f"1 to {MAX_ROWS}")
    if runs < 1:
        raise ValueError(f"fused_cut_round: {runs} runs")
    for on_chip in (True, False):
        for per_sm in (2, 1):
            g = min(max(1, per_sm * sms // runs), max(1, -(-d // MIN_COLS)))
            cw = (-(-d // g) + 7) // 8 * 8
            blocks = -(-d // cw)
            smem = round_smem(p, cw, elem_size, on_chip)
            if occupancy(on_chip, smem) * sms >= blocks * runs:
                return RoundPlan(blocks, cw, on_chip, smem)
    raise ValueError(f"fused_cut_round: no launch of {runs} x ({p}, {d}) "
                     "fits the card")


@functools.lru_cache(maxsize=None)
def _plan(device_index: int, p: int, d: int, elem_size: int,
          runs: int = 1) -> RoundPlan:
    lib = build.load()
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    with torch.cuda.device(device_index):
        return round_plan(
            p, d, elem_size, sms,
            lambda on_chip, smem: lib.fused_cut_round_occupancy(
                int(elem_size == 2), int(on_chip), smem, int(runs > 1)),
            runs)


def plan_for(a) -> RoundPlan:
    """The launch `fused_cut_round` makes for the CUDA matrix `a`, (P, D)
    or, batched, (R, P, D)."""
    runs = a.shape[0] if a.dim() == 3 else 1
    return _plan(a.device.index, a.shape[-2], a.shape[-1], a.element_size(),
                 runs)


def _check(a, vectors, rows):
    batched = a.dim() == 3
    if a.dim() not in (2, 3) or 0 in a.shape:
        raise ValueError(f"fused_cut_round: matrix of shape "
                         f"{tuple(a.shape)}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_cut_round: matrix dtype {a.dtype} is not "
                        "f32 or bf16")
    p, d = a.shape[-2:]
    lead = tuple(a.shape[:1]) if batched else ()
    for n, group in ((d, vectors), (p, rows)):
        for name, t in group.items():
            if t.dtype != torch.float32:
                raise TypeError(f"fused_cut_round: {name} dtype {t.dtype} "
                                "is not f32")
            if tuple(t.shape) != lead + (n,):
                raise ValueError(f"fused_cut_round: {name} of shape "
                                 f"{tuple(t.shape)}, expected "
                                 f"{lead + (n,)}")
    for name, t in {"a": a, **vectors, **rows}.items():
        if not (t[0] if batched else t).is_contiguous():
            raise ValueError(f"fused_cut_round: {name} is not contiguous"
                             + (" within a run" if batched else ""))
        if t.device != a.device:
            raise ValueError(f"fused_cut_round: {name} on {t.device}, the "
                             f"matrix on {a.device}")


def fused_cut_round(a, v, g_other, mask, c, active, s, gamma, *,
                    eta_z: float, eta_s: float, eta_dual: float,
                    rho2: float, plan: RoundPlan = None):
    """One fused level-2 cut round -> (v_new (D,), cv1, s_new, gamma_new
    (P,)), all f32.  A is f32 or bf16; every other operand f32.  With a
    leading run axis on every operand, R rounds at once.  `plan` replaces
    the planned launch of a single round (e.g. a batched call's, to
    compare one run with it bit for bit)."""
    _check(a, {"v": v, "g_other": g_other, "mask": mask},
           {"c": c, "active": active, "s": s, "gamma": gamma})
    kw = dict(eta_z=eta_z, eta_s=eta_s, eta_dual=eta_dual, rho2=rho2)
    if a.device.type == "cpu":
        return fused_cut_round_ref(a, v, g_other, mask, c, active, s,
                                   gamma, **kw)
    ins = (v, g_other, mask, c, active, s, gamma)
    if a.dim() == 3 and a.shape[0] == 1:
        return tuple(o[None] for o in fused_cut_round(
            a[0], *(t[0] for t in ins), **kw))
    lib = build.load()
    p, d = a.shape[-2:]
    with torch.cuda.device(a.device):
        if a.dim() == 2:
            plan = plan or plan_for(a)
            lead = ()
        else:
            plan = plan_for(a)
            lead = (a.shape[0],)
        runs = a.shape[0] if lead else 1

        def out(n):
            return torch.empty(lead + (n,), dtype=torch.float32,
                               device=a.device)
        scratch = torch.empty(
            (runs * lib.fused_cut_round_scratch(p, plan.blocks),),
            dtype=torch.float32, device=a.device)
        v_new, cv1, s_new, gamma_new = out(d), out(p), out(p), out(p)
        outs = (v_new, cv1, s_new, gamma_new)
        shape = (p, d, plan.blocks, plan.cw, int(plan.on_chip), plan.smem,
                 eta_z, eta_s, eta_dual, rho2, _kern._stream(a))
        if not lead:
            _kern._launch(
                "fused_round", lib.fused_cut_round, a.data_ptr(),
                _kern._bf16(a), *(t.data_ptr() for t in ins),
                scratch.data_ptr(), _kern._ticket(a).data_ptr(),
                *(t.data_ptr() for t in outs), *shape)
        else:
            strides = torch.tensor(
                [_kern._runs_stride(t) for t in (a, *ins)],
                dtype=torch.int64)
            _kern._launch(
                "fused_round_runs", lib.fused_cut_round_runs, a.data_ptr(),
                _kern._bf16(a), *(t.data_ptr() for t in ins),
                strides.data_ptr(), scratch.data_ptr(),
                _kern._ticket(a, runs).data_ptr(),
                *(t.data_ptr() for t in outs), runs, *shape)
    return outs
