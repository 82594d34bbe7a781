"""Public routing points for the cut contraction and the fused round.

Counterpart of `repro/kernels/ops.py` `cut_eval` and `fused_cut_round`.
The kernel route of `cut_eval` goes through the `cut_ad` Functions, so
forward, reverse and grad-of-grad all stay on the CUDA kernels; the
epilogue `(- c) * active` is plain torch, whose autograd supplies
dc/dactive.  The kernel route of `fused_cut_round` is `FusedRound`: the
fused kernel on the forward, the same round decomposed onto the `cut_ad`
Functions on every derivative.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cut_ad
from repro_torch.kernels import cut_eval as _kern
from repro_torch.kernels import inner_round as _round

IMPLS = (None, "kernel", "ref")


def cut_eval(a, v, c, active, impl: str = None):
    """(A @ v - c) * active — the single routing point for cut mat-vecs.

    impl=None runs the kernel on CUDA tensors and the plain version on
    CPU tensors.  impl="kernel" insists on the kernel (raises on the
    CPU); impl="ref" forces the plain version on any device (the oracle
    the tests and the on-card smoke run compare against)."""
    if _route(a, impl) == "ref":
        raw = _kern.matvec_ref(a, v)
    else:
        raw = cut_ad.MV.apply(a, v)
    return (raw - c) * active


def _route(a, impl):
    """The route for `impl` on a's device, "kernel" or "ref"; raises on
    an unknown impl and on impl="kernel" off the card."""
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
    if impl is None:
        return "kernel" if a.is_cuda else "ref"
    if impl == "kernel" and not a.is_cuda:
        raise ValueError("impl='kernel' needs CUDA tensors; the CUDA "
                         "kernels do not run on the CPU")
    return impl


def fused_cut_round(a, v, g_other, mask, c, active, s, gamma, *,
                    eta_z: float, eta_s: float, eta_dual: float,
                    rho2: float, impl: str = None):
    """One fused level-2 inner-ADMM cut round -> (v_new, cv1, s_new,
    gamma_new); see `kernels.inner_round`.  Routed like `cut_eval`:
    impl=None runs `FusedRound` (the kernel) on CUDA tensors and the
    plain version on CPU tensors, "kernel" insists on the kernel, "ref"
    forces the plain version on any device."""
    if _route(a, impl) == "ref":
        return _round.fused_cut_round_ref(
            a, v, g_other, mask, c, active, s, gamma, eta_z=eta_z,
            eta_s=eta_s, eta_dual=eta_dual, rho2=rho2)
    return FusedRound.apply(a, v, g_other, mask, c, active, s, gamma,
                            eta_z, eta_s, eta_dual, rho2)


class FusedRound(torch.autograd.Function):
    """The fused round with any-order derivatives.

    Forward: `inner_round.fused_cut_round` (the kernel on CUDA tensors).
    Backward: the same round recomputed from the saved inputs on the
    `cut_ad` MV/VM Functions and differentiated by autograd, the
    counterpart of the reference's `custom_jvp` whose tangents run the
    primitive decomposition (`repro/kernels/ops.py:120-156`).  Under
    `create_graph=True` the recomputation stays attached to the inputs'
    graph, so grad-of-grad runs on the cut kernels too; a gradient with
    respect to A goes through `cut_ad.OUTER`.  The step scalars take no
    gradient."""

    @staticmethod
    def forward(a, v, g_other, mask, c, active, s, gamma, eta_z, eta_s,
                eta_dual, rho2):
        return _round.fused_cut_round(
            a, v, g_other, mask, c, active, s, gamma, eta_z=eta_z,
            eta_s=eta_s, eta_dual=eta_dual, rho2=rho2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:8])
        ctx.steps = inputs[8:]

    @staticmethod
    def backward(ctx, *cts):
        need = ctx.needs_input_grad[:8]
        create = torch.is_grad_enabled()
        # with create_graph the saved inputs keep their history, so the
        # gradients below are differentiable w.r.t. what made them
        ins = [x if create else x.detach().requires_grad_(n)
               for x, n in zip(ctx.saved_tensors, need)]
        wrt = [x for x, n in zip(ins, need) if n]
        with torch.enable_grad():
            # every output depends on every input, so all four carry a
            # graph whenever backward runs
            outs = _round.fused_round_math(
                cut_ad.MV.apply, cut_ad.VM.apply, *ins, *ctx.steps)
            grads = torch.autograd.grad(outs, wrt, cts, create_graph=create)
        it = iter(grads)
        return (*(next(it) if n else None for n in need),
                None, None, None, None)
