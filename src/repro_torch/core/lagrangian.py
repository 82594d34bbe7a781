"""Augmented / regularized Lagrangians (paper Eqs. 4, 11, 14, 15).

Counterpart of `repro/core/lagrangian.py`.  The per-worker objectives are
summed over a loop on the workers (the reference vmaps them); the
consensus terms are taken over the stacked trees at once.  The cut terms
in `l_p2` / `l_p` contract the stored `(P, D)` matrix through
`cuts.eval_cuts`, so they stay differentiable to second order on the
CUDA kernels through the inner ADMM rollouts.
"""
from __future__ import annotations

import torch

from repro_torch.core import cuts as cuts_lib
from repro_torch.core.types import (FlatCuts, Hyper, InnerState2,
                                    InnerState3, TrilevelProblem,
                                    sum_workers)
from repro_torch.utils.tree import (tree_dot, tree_index, tree_map,
                                    tree_norm_sq)


def _consensus(X, z, phi, kappa):
    """sum_j <phi_j, x_j - z> + kappa/2 ||x_j - z||^2 over stacked X, phi."""
    r = tree_map(lambda x, zz: x - zz[None], X, z)
    return tree_dot(phi, r) + 0.5 * kappa * tree_norm_sq(r)


# ---------------------------------------------------------------------------
# Level-3 augmented Lagrangian (Eq. 4)
# ---------------------------------------------------------------------------

def l_p3(problem: TrilevelProblem, hyper: Hyper, z1, z2, st: InnerState3):
    """sum_j f3_j(z1, z2', x3_j') + <phi_j, x3_j'-z3'> + kappa3/2 ||.||^2."""
    f = sum_workers(problem.n_workers, lambda j: problem.f3(
        problem.worker_data(j), z1, z2, tree_index(st.x3, j)))
    return f + _consensus(st.x3, st.z3, st.phi, hyper.kappa3)


# ---------------------------------------------------------------------------
# Level-2 augmented Lagrangian with I-layer cut terms (Eq. 11)
# ---------------------------------------------------------------------------

def l_p2_base(problem: TrilevelProblem, hyper: Hyper, z1, z3, X3,
              st: InnerState2):
    """The cut-free part of Eq. 11: sum_j f2_j + consensus terms."""
    f = sum_workers(problem.n_workers, lambda j: problem.f2(
        problem.worker_data(j), z1, tree_index(st.x2, j),
        tree_index(X3, j)))
    return f + _consensus(st.x2, st.z2, st.phi, hyper.kappa2)


def l_p2(problem: TrilevelProblem, hyper: Hyper, z1, z3, X3,
         cuts_i: FlatCuts, st: InnerState2):
    """sum_j f2_j + consensus terms + gamma/rho2 terms over the I-polytope.

    The I-layer cut value is evaluated at (X3, z1, z2'=st.z2, z3): the
    cut's a2-block multiplies the *inner* consensus variable z2'."""
    total = l_p2_base(problem, hyper, z1, z3, X3, st)
    cutval = cuts_lib.eval_cuts(cuts_i, z1, st.z2, z3, X2=None, X3=X3,
                                impl=hyper.cut_impl)
    viol = (cutval + st.s) * cuts_i.active
    return total + torch.sum(st.gamma * viol) \
        + 0.5 * hyper.rho2 * torch.sum(viol ** 2)


# ---------------------------------------------------------------------------
# Top-level Lagrangian over the hyper-polyhedral problem (Eq. 14/15)
# ---------------------------------------------------------------------------

def l_p(problem: TrilevelProblem, state_vars, cuts_ii: FlatCuts, lam, theta,
        impl: str = None):
    """L_p (Eq. 14) at explicit variables.

    state_vars = (X1, X2, X3, z1, z2, z3); theta is stacked (N, ...)."""
    X1, X2, X3, z1, z2, z3 = state_vars
    f1_sum = problem.sum_f(problem.f1, X1, X2, X3)
    cons_sum = tree_dot(theta, tree_map(lambda x, z: x - z[None], X1, z1))
    cutval = cuts_lib.eval_cuts(cuts_ii, z1, z2, z3, X2=X2, X3=X3,
                                impl=impl)
    return f1_sum + cons_sum + torch.sum(lam * cutval)


def l_p_hat(problem: TrilevelProblem, hyper: Hyper, t, state_vars,
            cuts_ii: FlatCuts, lam, theta):
    """Regularized Lagrangian (Eq. 15)."""
    base = l_p(problem, state_vars, cuts_ii, lam, theta,
               impl=hyper.cut_impl)
    reg_lam = 0.5 * hyper.c1(t) * torch.sum((lam * cuts_ii.active) ** 2)
    reg_th = 0.5 * hyper.c2(t) * tree_norm_sq(theta)
    return base - reg_lam - reg_th
