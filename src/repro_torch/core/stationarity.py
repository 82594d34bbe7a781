"""Stationarity gap (Definitions 4.1/4.2, Eqs. 26/27).

Counterpart of `repro/core/stationarity.py`.  The cut-dependent terms
read the stored II-polytope operator: one `w @ A` product yields the
z-block gradients and the per-worker b-block sums, and the cut values
come from `cut_eval`.  At record iterations the engine hands over the
step's own products (`aux=`) unless a cut refresh rewrote the polytope.
"""
from __future__ import annotations

import torch

from repro_torch.core import afto as afto_lib
from repro_torch.core import cuts as cuts_lib
from repro_torch.core.types import AFTOState, Hyper, TrilevelProblem
from repro_torch.utils.tree import tree_add, tree_axpy, tree_map, \
    tree_norm_sq


def make_gap_aux(problem: TrilevelProblem, hyper: Hyper, state: AFTOState):
    """The cut products the gap needs: the II-polytope operator and the
    cut values at `state`'s point (the shape `afto_step_aux` returns)."""
    a_flat = state.cuts_ii.a
    cutval = cuts_lib.eval_cuts_flat(
        a_flat,
        cuts_lib.flatten_point(state.cuts_ii.spec, state.z1, state.z2,
                               state.z3, state.X2, state.X3),
        state.cuts_ii.c, state.cuts_ii.active, impl=hyper.cut_impl)
    return {"flat_ii": a_flat, "cutval": cutval}


def stationarity_gap_sq(problem: TrilevelProblem, hyper: Hyper,
                        state: AFTOState, aux=None):
    """|| grad G^t ||^2 of the *unregularized* L_p (Eq. 26).

    aux, when given, must be `make_gap_aux`-shaped products valid at
    `state`."""
    if aux is None:
        aux = make_gap_aux(problem, hyper, state)
    lam_a = state.lam * state.cuts_ii.active
    spec = state.cuts_ii.spec
    # one product: a-block gradients for the master z's plus the
    # per-worker b-block sums (lam is shared across workers here)
    ga1, ga2, ga3, gb2, gb3 = cuts_lib.cut_weighted_coeff_flat(
        spec, aux["flat_ii"], lam_a)

    # worker blocks
    g1_f, g2_f, g3_f = afto_lib.local_f1_grads(
        problem, state.X1, state.X2, state.X3)
    g1 = tree_add(g1_f, state.theta)
    g2 = tree_add(g2_f, gb2)
    g3 = tree_add(g3_f, gb3)
    gap = tree_norm_sq(g1) + tree_norm_sq(g2) + tree_norm_sq(g3)

    # projected consensus-dual residuals, all workers at once
    stepped = tree_map(lambda th, x, z: th + hyper.eta_theta * (x - z[None]),
                       state.theta, state.X1, state.z1)
    proj = afto_lib.proj_theta(stepped, hyper)
    gap = gap + tree_norm_sq(tree_map(
        lambda a, b: (a - b) / hyper.eta_theta, state.theta, proj))

    # master z blocks
    theta_sum = tree_map(lambda th: torch.sum(th, dim=0), state.theta)
    gz1 = tree_axpy(-1.0, theta_sum, ga1)
    gap = gap + tree_norm_sq(gz1) + tree_norm_sq(ga2) + tree_norm_sq(ga3)

    # projected dual residuals (Eq. 27)
    lam_res = (state.lam - afto_lib.proj_lambda(
        state.lam + hyper.eta_lambda * aux["cutval"], hyper)) \
        / hyper.eta_lambda
    return gap + torch.sum((lam_res * state.cuts_ii.active) ** 2)
