"""mu-weak-convexity utilities (Definitions 3.1/3.2).

Counterpart of `repro/core/weakly_convex.py`.  A differentiable f is
mu-weakly convex iff f + (mu/2)||.||^2 is convex, i.e. the Hessian's
smallest eigenvalue is >= -mu everywhere.  The paper assumes a known mu
for h_I/h_II (Appendix E); `estimate_mu` gives a practical sampled lower
bound from Hessian-vector products, so users can set `Hyper.mu_i/mu_ii`
from data.

Points and directions are trees of tensors (`repro_torch.utils.tree`).
The Hessian-vector product runs forward over reverse, `torch.func.jvp`
of the gradient, as the reference's `jax.jvp(jax.grad(fn))`; through the
cut kernels it takes the `jvp` rules of the `cut_ad` Functions and of
`ops.FusedRound`.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.utils import tree as tree_lib
from repro_torch.utils.tree import (tree_dot, tree_flatten, tree_map,
                                    tree_norm_sq, tree_sub, tree_unflatten)


def curvature_along(fn: Callable, point, direction):
    """d^T H d / ||d||^2 at `point`: the directional derivative of
    grad f along d."""
    point, direction = (tree_map(torch.Tensor.detach, t)
                        for t in (point, direction))
    _, hvp = torch.func.jvp(lambda p: tree_lib.grad(fn, p)[0], (point,),
                            (direction,))
    return tree_dot(direction, hvp) / torch.clamp(
        tree_norm_sq(direction), min=1e-30)


def estimate_mu(fn: Callable, point, generator: torch.Generator,
                n_samples: int = 16, radius: float = 0.5):
    """max(0, -min sampled curvature): a practical mu estimate.

    Samples random directions at random perturbations of `point`, drawn
    from `generator` (on its own device, then moved to each leaf's); a
    valid mu must dominate the most negative curvature of fn."""
    leaves, tdef = tree_flatten(point)

    def normal(leaf):
        return torch.randn(leaf.shape, generator=generator,
                           dtype=leaf.dtype,
                           device=generator.device).to(leaf.device)

    curvs = []
    for _ in range(n_samples):
        d = tree_unflatten(tdef, [normal(l) for l in leaves])
        p = tree_unflatten(tdef, [l.detach() + radius * normal(l)
                                  for l in leaves])
        curvs.append(curvature_along(fn, p, d))
    return torch.clamp(-torch.min(torch.stack(curvs)), min=0.0)


def first_order_gap(fn: Callable, x, x_ref, mu):
    """Def. 3.2 residual: f(x) - [f(x') + <g(x'), x-x'> - mu/2||x-x'||^2].

    Nonnegative for all (x, x') iff fn is mu-weakly convex; the property
    tests use it to check cut validity."""
    x, x_ref = (tree_map(torch.Tensor.detach, t) for t in (x, x_ref))
    f_ref, (g,) = tree_lib.value_and_grad(fn, x_ref)
    d = tree_sub(x, x_ref)
    lin = f_ref + tree_dot(g, d) - 0.5 * mu * tree_norm_sq(d)
    return fn(x) - lin
