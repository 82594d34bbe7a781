"""Differentiation-closed autograd Functions over the cut matrix.

    MV(a, v)    = A @ v      (P,)    forward cut values
    VM(g, a)    = g^T A      (D,)    row reduction (the dv backward)
    OUTER(x, y) = x y^T      (P, D)  rank-1 update (the da backward)

Counterpart of `repro/kernels/cut_ad.py`.  Each rule is written in terms
of the three Functions themselves, mirroring the reference's rules
(cut_ad.py:94-137):

    MV.backward    ct -> da = OUTER(ct, v),  dv = VM(ct, a)
    VM.backward    ct -> dg = MV(a, ct),     da = OUTER(g, ct)
    OUTER.backward ct -> dx = MV(ct, y),     dy = VM(x, ct)
    MV.jvp         (da, dv) -> MV(da, v) + MV(a, dv)      (bilinear; VM
                                                          and OUTER alike)

Because every rule calls the Functions, a backward run under
`create_graph=True` or a `torch.func` transform records kernel-backed
nodes, so grad-of-grad (the Eq. 23/24 cut refresh) and forward-over-
reverse stay on the kernels to any order.  All three emit f32;
cotangents are cast back to the primal's dtype.

Each Function takes one problem or R at once, every operand with a
leading run axis (`cut_eval`'s batched forms: one launch for all R).
The `vmap` rules move the vmapped dimension to the front, broadcast an
unbatched operand with `expand` (no copy: the batched kernels take a run
stride of 0), and call the same Function on the batched operands, so
`torch.func.vmap` of anything built on these Functions, derivatives
included, runs one batched launch per contraction, as `jax.vmap` of the
reference's primitives adds a grid axis to the Pallas kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cut_eval as _kern


def _like(x, primal):
    return x if x.dtype == primal.dtype else x.to(primal.dtype)


def batch_front(x, dim, n: int, ndim: int):
    """x with its vmapped dimension `dim` (None: not batched) first and
    `ndim` per-run dimensions contiguous; an unbatched operand is
    broadcast over the n runs by `expand`, at run stride 0."""
    if dim is None:
        return x.contiguous().expand((n,) + tuple(x.shape))
    x = x.movedim(dim, 0)
    if x.dim() != ndim + 1:
        raise ValueError(f"cut_ad: operand of {x.dim() - 1} per-run "
                         f"dimensions, the kernels take {ndim}")
    return x if x[0].is_contiguous() else x.contiguous()


def _sum_tangents(*terms):
    terms = [t for t in terms if t is not None]
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


class _Bilinear(torch.autograd.Function):
    """Saves both operands for the backward and the forward-mode rule."""

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)


class MV(_Bilinear):
    @staticmethod
    def forward(a, v):
        return _kern.matvec(a, v)

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

    @staticmethod
    def jvp(ctx, da, dv):
        a, v = ctx.saved_tensors
        return _sum_tangents(None if da is None else MV.apply(da, v),
                             None if dv is None else MV.apply(a, dv))

    @staticmethod
    def vmap(info, in_dims, a, v):
        n = info.batch_size
        return MV.apply(batch_front(a, in_dims[0], n, 2),
                        batch_front(v, in_dims[1], n, 1)), 0


class VM(_Bilinear):
    @staticmethod
    def forward(g, a):
        return _kern.vecmat(g, a)

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

    @staticmethod
    def jvp(ctx, dg, da):
        g, a = ctx.saved_tensors
        return _sum_tangents(None if dg is None else VM.apply(dg, a),
                             None if da is None else VM.apply(g, da))

    @staticmethod
    def vmap(info, in_dims, g, a):
        n = info.batch_size
        return VM.apply(batch_front(g, in_dims[0], n, 1),
                        batch_front(a, in_dims[1], n, 2)), 0


class OUTER(_Bilinear):
    @staticmethod
    def forward(x, y):
        return _kern.rank1(x, y)

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

    @staticmethod
    def jvp(ctx, dx, dy):
        x, y = ctx.saved_tensors
        return _sum_tangents(None if dx is None else OUTER.apply(dx, y),
                             None if dy is None else OUTER.apply(x, dy))

    @staticmethod
    def vmap(info, in_dims, x, y):
        n = info.batch_size
        return OUTER.apply(batch_front(x, in_dims[0], n, 1),
                           batch_front(y, in_dims[1], n, 1)), 0
