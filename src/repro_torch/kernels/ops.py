"""Public routing point for the cut contraction.

Counterpart of `repro/kernels/ops.py:57 cut_eval`.  The kernel route goes
through the `cut_ad` Functions, so forward, reverse and grad-of-grad all
stay on the CUDA kernels; the epilogue `(- c) * active` is plain torch,
whose autograd supplies dc/dactive.
"""
from __future__ import annotations

from repro_torch.kernels import cut_ad
from repro_torch.kernels import cut_eval as _kern

IMPLS = (None, "kernel", "ref")


def cut_eval(a, v, c, active, impl: str = None):
    """(A @ v - c) * active — the single routing point for cut mat-vecs.

    impl=None runs the kernel on CUDA tensors and the plain version on
    CPU tensors.  impl="kernel" insists on the kernel (raises on the
    CPU); impl="ref" forces the plain version on any device (the oracle
    the tests and the on-card smoke run compare against)."""
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
    if impl is None:
        impl = "kernel" if a.is_cuda else "ref"
    if impl == "ref":
        raw = _kern.matvec_ref(a, v)
    elif not a.is_cuda:
        raise ValueError("impl='kernel' needs CUDA tensors; the CUDA "
                         "kernels do not run on the CPU")
    else:
        raw = cut_ad.MV.apply(a, v)
    return (raw - c) * active
