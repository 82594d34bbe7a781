"""mu-weak-convexity utilities (Definitions 3.1/3.2).

Counterpart of `repro/core/weakly_convex.py`.  A differentiable f is
mu-weakly convex iff f + (mu/2)||.||^2 is convex, i.e. the Hessian's
smallest eigenvalue is >= -mu everywhere.  The paper assumes a known mu
for h_I/h_II (Appendix E); `estimate_mu` gives a practical sampled lower
bound from Hessian-vector products, so users can set `Hyper.mu_i/mu_ii`
from data.

Points and directions are trees of tensors (`repro_torch.utils.tree`).
The Hessian-vector product runs reverse over reverse, so it goes through
the cut kernels' autograd Functions, which have no forward-mode rule.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.utils.tree import (grad_point, tree_dot, tree_flatten,
                                    tree_grad, tree_map, tree_norm_sq,
                                    tree_sub, tree_unflatten)


def curvature_along(fn: Callable, point, direction):
    """d^T H d / ||d||^2 at `point`: the gradient of <grad f(p), d>."""
    direction = tree_map(torch.Tensor.detach, direction)
    with torch.enable_grad():
        p = grad_point(point)
        g = tree_grad(fn(p), [p], create_graph=True)[0]
        gd = tree_dot(g, direction)
        # a function at most linear in p leaves no graph behind its gradient
        hvp = tree_grad(gd, [p])[0] if gd.requires_grad \
            else tree_map(torch.zeros_like, p)
    return tree_dot(direction, hvp).detach() / torch.clamp(
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
    with torch.enable_grad():
        p = grad_point(x_ref)
        f_ref = fn(p)
        g = tree_grad(f_ref, [p])[0]
    with torch.no_grad():
        d = tree_sub(tree_map(torch.Tensor.detach, x), p)
        lin = f_ref.detach() + tree_dot(g, d) - 0.5 * mu * tree_norm_sq(d)
        return fn(tree_map(torch.Tensor.detach, x)) - lin

