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

`fused_cut_round` given CUDA tensors launches the three-launch kernel of
`csrc/inner_round.cu` on the current stream and counts the launch in
`cut_eval.LAUNCHES["fused_round"]`; given CPU tensors it runs the plain
version.  There is no other route: a CUDA tensor launches the kernel or
raises.  The autograd Function around it is `ops.FusedRound`.
"""
from __future__ import annotations

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


def _check(a, vectors, rows):
    if a.dim() != 2 or a.shape[0] == 0 or a.shape[1] == 0:
        raise ValueError(f"fused_cut_round: matrix of shape "
                         f"{tuple(a.shape)}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_cut_round: matrix dtype {a.dtype} is not "
                        "f32 or bf16")
    p, d = a.shape
    for n, group in ((d, vectors), (p, rows)):
        for name, t in group.items():
            if t.dtype != torch.float32:
                raise TypeError(f"fused_cut_round: {name} dtype {t.dtype} "
                                "is not f32")
            if t.dim() != 1 or t.shape[0] != n:
                raise ValueError(f"fused_cut_round: {name} of shape "
                                 f"{tuple(t.shape)}, expected ({n},)")
    for name, t in {"a": a, **vectors, **rows}.items():
        if not t.is_contiguous():
            raise ValueError(f"fused_cut_round: {name} is not contiguous")
        if t.device != a.device:
            raise ValueError(f"fused_cut_round: {name} on {t.device}, the "
                             f"matrix on {a.device}")


def fused_cut_round(a, v, g_other, mask, c, active, s, gamma, *,
                    eta_z: float, eta_s: float, eta_dual: float,
                    rho2: float):
    """One fused level-2 cut round -> (v_new (D,), cv1, s_new, gamma_new
    (P,)), all f32.  A is f32 or bf16; every other operand f32."""
    _check(a, {"v": v, "g_other": g_other, "mask": mask},
           {"c": c, "active": active, "s": s, "gamma": gamma})
    kw = dict(eta_z=eta_z, eta_s=eta_s, eta_dual=eta_dual, rho2=rho2)
    if a.device.type == "cpu":
        return fused_cut_round_ref(a, v, g_other, mask, c, active, s,
                                   gamma, **kw)
    lib = build.load()
    p, d = a.shape
    if p > lib.fused_cut_round_max_rows():
        raise ValueError(f"fused_cut_round: {p} cut rows, the kernel takes "
                         f"at most {lib.fused_cut_round_max_rows()}")
    with torch.cuda.device(a.device):
        def out(n):
            return torch.empty((n,), dtype=torch.float32, device=a.device)
        scratch = out(lib.fused_cut_round_scratch(p, d))
        v_new, cv1, s_new, gamma_new = out(d), out(p), out(p), out(p)
        _kern._launch(
            "fused_round", lib.fused_cut_round, a.data_ptr(),
            _kern._bf16(a), *(t.data_ptr() for t in (
                v, g_other, mask, c, active, s, gamma, scratch, v_new, cv1,
                s_new, gamma_new)),
            p, d, eta_z, eta_s, eta_dual, rho2, _kern._stream(a))
    return v_new, cv1, s_new, gamma_new
