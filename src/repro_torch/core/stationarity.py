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


def make_gap_aux(problem: TrilevelProblem, hyper: Hyper, state: AFTOState,
                 mesh=None):
    """The cut products the gap needs: the II-polytope operator and the
    cut values at `state`'s point (the shape `afto_step_aux` returns).
    On a worker mesh the b-column part of the cut values is summed over
    the mesh (`cuts.eval_cuts_worker_split`)."""
    a_flat = state.cuts_ii.a
    if mesh is not None:
        cutval = cuts_lib.eval_cuts_worker_split(
            state.cuts_ii, state.z1, state.z2, state.z3, state.X2,
            state.X3, mesh, label="gap_aux")
    else:
        cutval = cuts_lib.eval_cuts_flat(
            a_flat,
            cuts_lib.flatten_point(state.cuts_ii.spec, state.z1, state.z2,
                                   state.z3, state.X2, state.X3),
            state.cuts_ii.c, state.cuts_ii.active, impl=hyper.cut_impl)
    return {"flat_ii": a_flat, "cutval": cutval}


def stationarity_gap_sq(problem: TrilevelProblem, hyper: Hyper,
                        state: AFTOState, aux=None, mesh=None):
    """|| grad G^t ||^2 of the *unregularized* L_p (Eq. 26).

    aux, when given, must be `make_gap_aux`-shaped products valid at
    `state`.  On a worker `mesh` the per-worker blocks are taken
    shard-locally and only their scalar sum and the theta-sum cross the
    mesh (`core.sharded.gap_sharded`)."""
    if mesh is not None:
        from repro_torch.core import sharded
        return sharded.gap_sharded(sharded.Local(problem, hyper, mesh),
                                   state, aux)
    if aux is None:
        aux = make_gap_aux(problem, hyper, state)
    gap, theta_sum, ga = gap_workers(problem, hyper, state, aux["flat_ii"])
    return gap_master(problem, hyper, state, gap, theta_sum, ga,
                      aux["cutval"])


def gap_workers(problem: TrilevelProblem, hyper: Hyper, state: AFTOState,
                flat_ii):
    """The workers' blocks of the gap: (the squared norms of the worker
    gradient blocks and the projected consensus-dual residuals, the sum
    of the consensus duals, the a-block cut gradients), each a partial
    sum over a shard's workers on a worker mesh."""
    lam_a = state.lam * state.cuts_ii.active
    spec = state.cuts_ii.spec
    # one product: a-block gradients for the master z's plus the
    # per-worker b-block sums (lam is shared across workers here)
    ga1, ga2, ga3, gb2, gb3 = cuts_lib.cut_weighted_coeff_flat(
        spec, flat_ii, lam_a)

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
    theta_sum = tree_map(lambda th: torch.sum(th, dim=0), state.theta)
    return gap, theta_sum, (ga1, ga2, ga3)


def gap_master(problem: TrilevelProblem, hyper: Hyper, state: AFTOState,
               gap, theta_sum, ga, cutval):
    """The master's blocks of the gap given `gap_workers`' sums over every
    worker and the cut values at `state`'s point."""
    ga1, ga2, ga3 = ga
    # master z blocks
    gz1 = tree_axpy(-1.0, theta_sum, ga1)
    gap = gap + tree_norm_sq(gz1) + tree_norm_sq(ga2) + tree_norm_sq(ga3)

    # projected dual residuals (Eq. 27)
    lam_res = (state.lam - afto_lib.proj_lambda(
        state.lam + hyper.eta_lambda * cutval, hyper)) / hyper.eta_lambda
    return gap + torch.sum((lam_res * state.cuts_ii.active) ** 2)
