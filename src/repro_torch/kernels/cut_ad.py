"""Differentiation-closed autograd Functions over the cut matrix.

    MV(a, v)    = A @ v      (P,)    forward cut values
    VM(g, a)    = g^T A      (D,)    row reduction (the dv backward)
    OUTER(x, y) = x y^T      (P, D)  rank-1 update (the da backward)

Counterpart of `repro/kernels/cut_ad.py`.  Each backward is written in
terms of the other two Functions, mirroring the reference's transpose
rules (cut_ad.py:114-137):

    MV.backward    ct -> da = OUTER(ct, v),  dv = VM(ct, a)
    VM.backward    ct -> dg = MV(a, ct),     da = OUTER(g, ct)
    OUTER.backward ct -> dx = MV(ct, y),     dy = VM(x, ct)

Because a backward calls the Functions themselves, a backward run under
`create_graph=True` records kernel-backed nodes, so grad-of-grad (the
Eq. 23/24 cut refresh) stays on the kernels to any order.  All three emit
f32; cotangents are cast back to the primal's dtype.  The `jvp` and
`vmap` rules arrive with the sweep engine.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cut_eval as _kern


def _like(x, primal):
    return x if x.dtype == primal.dtype else x.to(primal.dtype)


class MV(torch.autograd.Function):
    @staticmethod
    def forward(a, v):
        return _kern.matvec(a, v)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, ct):
        a, v = ctx.saved_tensors
        ct = ct.contiguous()
        da = dv = None
        if ctx.needs_input_grad[0]:
            da = _like(OUTER.apply(ct, v), a)
        if ctx.needs_input_grad[1]:
            dv = _like(VM.apply(ct, a), v)
        return da, dv


class VM(torch.autograd.Function):
    @staticmethod
    def forward(g, a):
        return _kern.vecmat(g, a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, ct):
        g, a = ctx.saved_tensors
        ct = ct.contiguous()
        dg = da = None
        if ctx.needs_input_grad[0]:
            dg = _like(MV.apply(a, ct), g)
        if ctx.needs_input_grad[1]:
            da = _like(OUTER.apply(g, ct), a)
        return dg, da


class OUTER(torch.autograd.Function):
    @staticmethod
    def forward(x, y):
        return _kern.rank1(x, y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, ct):
        x, y = ctx.saved_tensors
        ct = ct.contiguous()
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = _like(MV.apply(ct, y), x)
        if ctx.needs_input_grad[1]:
            dy = _like(VM.apply(x, ct), y)
        return dx, dy

