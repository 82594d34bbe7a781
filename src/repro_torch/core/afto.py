"""AFTO: the asynchronous federated master-worker iteration (Alg. 1).

Counterpart of `repro/core/afto.py`.  One `afto_step` is Eqs. 16-21 at a
given active-worker mask; `cut_refresh` is the T_pre-periodic
hyper-polytope update (Eqs. 23-25).  Both return a new state and leave
their argument untouched; who is active when lives in
`repro_torch.core.scheduler` on the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.core import cuts as cuts_lib
from repro_torch.core import inner as inner_lib
from repro_torch.core.types import (AFTOState, Hyper, InnerState2,
                                    InnerState3, StaleView, TrilevelProblem)
from repro_torch.utils import tree as tree_lib
from repro_torch.utils.tree import (tree_add, tree_axpy, tree_flatten,
                                    tree_map, tree_zeros_like)


# ---------------------------------------------------------------------------
# projections (Eq. 20/21)
# ---------------------------------------------------------------------------

def _sqrt(x):
    """sqrt of a hyper field: a float, or a 0-d tensor under a sweep."""
    return torch.sqrt(x) if torch.is_tensor(x) else math.sqrt(x)


def proj_lambda(lam, hyper: Hyper):
    hi = _sqrt(hyper.alpha4)
    # torch.clamp takes two numbers or two tensors
    lo = torch.zeros_like(lam) if torch.is_tensor(hi) else 0.0
    return torch.clamp(lam, lo, hi)


def proj_theta(theta, hyper: Hyper):
    r = _sqrt(hyper.alpha5) / hyper.d1
    return tree_map(lambda th: torch.clamp(th, -r, r), theta)


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

def _stack_n(tpl, n):
    return tree_map(lambda x: x[None].expand((n,) + tuple(x.shape))
                    .contiguous(), tpl)


def init_state(problem: TrilevelProblem, hyper: Hyper) -> AFTOState:
    """The t = 0 state on the device of the problem's initial point."""
    n, p = hyper.n_workers, hyper.p_max
    z1, z2, z3 = problem.x1_init, problem.x2_init, problem.x3_init
    dev = tree_flatten(z1)[0][0].device
    X1, X2, X3 = (_stack_n(z1, n), _stack_n(z2, n), _stack_n(z3, n))

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return AFTOState(
        X1=X1, X2=X2, X3=X3, z1=z1, z2=z2, z3=z3,
        theta=tree_zeros_like(X1), lam=zeros(p),
        cuts_i=cuts_lib.empty_cuts(p, n, z1, z2, z3),
        cuts_ii=cuts_lib.empty_cuts(p, n, z1, z2, z3),
        gamma_k=zeros(p),
        inner3=InnerState3(x3=X3, z3=z3, phi=tree_zeros_like(X3)),
        inner2=InnerState2(x2=X2, z2=z2, phi=tree_zeros_like(X2),
                           s=zeros(p), gamma=zeros(p)),
        stale=StaleView(z1=_stack_n(z1, n), z2=_stack_n(z2, n),
                        z3=_stack_n(z3, n), lam=zeros(n, p),
                        theta=tree_zeros_like(X1),
                        t_hat=zeros(n, dtype=torch.int32)),
        t=zeros(dtype=torch.int32))


# ---------------------------------------------------------------------------
# one master iteration (Eqs. 16-21)
# ---------------------------------------------------------------------------

def afto_step(problem: TrilevelProblem, hyper: Hyper, state: AFTOState,
              active) -> AFTOState:
    """Eq. 16 (masked worker updates at stale views) + Eqs. 17-21 (master).

    active: (N,) {0,1} float mask of workers whose update arrives now."""
    return afto_step_aux(problem, hyper, state, active)[0]


def local_f1_grads(problem: TrilevelProblem, X1, X2, X3) -> Tuple:
    """grad f1(data_j, .) at each worker's local point, stacked over the
    worker axis: the federated payload of one master iteration.  Worker
    terms are independent, so one gradient of sum_j f1 w.r.t. the stacked
    (X1, X2, X3) gives every worker's row."""
    return tree_lib.grad(lambda *xs: problem.sum_f(problem.f1, *xs),
                         X1, X2, X3)


def afto_step_aux(problem: TrilevelProblem, hyper: Hyper, state: AFTOState,
                  active, mesh=None) -> Tuple[AFTOState, dict]:
    """`afto_step` plus the step's cut products (the II-polytope operator
    and the cut values at the post-step point), which the stationarity gap
    reuses at record iterations while the polytope is unchanged.

    mesh, when set, is the `launch.mesh.WorkerMesh` of a sharded run:
    `state` / `problem.data` / `active` then carry only this shard's
    workers, the polytopes its local columns (`fed.sharding.
    shard_state`), and the only traffic over the mesh is one sum of the
    theta-sum and the cut scalars' b-part (`core.sharded`)."""
    if mesh is not None:
        from repro_torch.core import sharded
        return sharded.afto_step_sharded(
            sharded.Local(problem, hyper, mesh), state, active)
    grads = local_f1_grads(problem, state.X1, state.X2, state.X3)
    return afto_step_from_grads(problem, hyper, state, active, grads)


def _bmask(active, x):
    """Broadcast the (N,) mask against a leaf with leading worker axis."""
    return active.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)


def afto_step_from_grads(problem: TrilevelProblem, hyper: Hyper,
                         state: AFTOState, active, f1_grads
                         ) -> Tuple[AFTOState, dict]:
    """The master half of Eq. 16-21 given the worker f1-grads stack
    triple of `local_f1_grads` (rows of inactive workers are masked)."""
    X, ga, theta_sum = step_workers(problem, hyper, state, active, f1_grads)
    fc = state.cuts_ii
    X2, X3 = X[1], X[2]
    return step_master(
        problem, hyper, state, active, X, ga, theta_sum,
        lambda z1, z2, z3: cuts_lib.eval_cuts_flat(
            fc.a, cuts_lib.flatten_point(fc.spec, z1, z2, z3, X2, X3),
            fc.c, fc.active, impl=hyper.cut_impl))


def step_workers(problem: TrilevelProblem, hyper: Hyper, state: AFTOState,
                 active, f1_grads):
    """The workers' part of a step: Eq. 16's masked updates (X1, X2, X3),
    the master's a-block cut gradients (ga1, ga2, ga3) from one w @ A
    product, and the sum of the consensus duals over the workers (a
    shard's partial sum on a worker mesh)."""
    g1_f, g2_f, g3_f = f1_grads

    # consensus dual term (stale own theta) and cut terms (stale lambda)
    g1 = tree_add(g1_f, state.stale.theta)
    g2 = tree_add(g2_f, cuts_lib.cut_coeff_per_worker(
        state.cuts_ii, state.stale.lam, "b2"))
    g3 = tree_add(g3_f, cuts_lib.cut_coeff_per_worker(
        state.cuts_ii, state.stale.lam, "b3"))

    def masked_step(X, g, eta):
        return tree_map(lambda x, gg: x - eta * _bmask(active, x) * gg, X, g)

    X1 = masked_step(state.X1, g1, hyper.eta_x)
    X2 = masked_step(state.X2, g2, hyper.eta_x)
    X3 = masked_step(state.X3, g3, hyper.eta_x)

    # the a-block gradients for z1/z2/z3 come out of one w @ A product
    lam_a = state.lam * state.cuts_ii.active
    ga1, ga2, ga3, _, _ = cuts_lib.cut_weighted_coeff_flat(
        state.cuts_ii.spec, state.cuts_ii.a, lam_a)
    theta_sum = tree_map(lambda th: torch.sum(th, dim=0), state.theta)
    return (X1, X2, X3), (ga1, ga2, ga3), theta_sum


def step_master(problem: TrilevelProblem, hyper: Hyper, state: AFTOState,
                active, X, ga, theta_sum, cut_values
                ) -> Tuple[AFTOState, dict]:
    """The master's part of a step (Eqs. 17-21) after `step_workers`:
    `theta_sum` is the sum over every worker, and `cut_values(z1, z2,
    z3)` gives the II-layer cut values at the new point."""
    t = state.t
    X1, X2, X3 = X
    ga1, ga2, ga3 = ga

    # ---- master Gauss-Seidel primal updates (Eqs. 17-19)
    gz1 = tree_axpy(-1.0, theta_sum, ga1)
    z1 = tree_axpy(-hyper.eta_z, gz1, state.z1)
    z2 = tree_axpy(-hyper.eta_z, ga2, state.z2)
    z3 = tree_axpy(-hyper.eta_z, ga3, state.z3)

    # ---- dual updates with projection (Eqs. 20/21)
    cutval = cut_values(z1, z2, z3)
    lam = proj_lambda(
        state.lam + hyper.eta_lambda * (cutval - hyper.c1(t) * state.lam),
        hyper) * state.cuts_ii.active
    c2 = hyper.c2(t)
    theta = proj_theta(tree_map(
        lambda th, x, z: th + hyper.eta_theta * ((x - z[None]) - c2 * th),
        state.theta, X1, z1), hyper)

    # ---- refresh stale views of the (now-active) workers
    def snap(stale_stack, fresh):
        return tree_map(
            lambda s, f: torch.where(_bmask(active, s) > 0,
                                     f[None].to(s.dtype), s),
            stale_stack, fresh)

    stale = StaleView(
        z1=snap(state.stale.z1, z1),
        z2=snap(state.stale.z2, z2),
        z3=snap(state.stale.z3, z3),
        lam=torch.where(active[:, None] > 0, lam[None, :], state.stale.lam),
        theta=tree_map(lambda s, f: torch.where(_bmask(active, s) > 0, f, s),
                       state.stale.theta, theta),
        t_hat=torch.where(active > 0, t + 1, state.stale.t_hat))

    new_state = dataclasses.replace(
        state, X1=X1, X2=X2, X3=X3, z1=z1, z2=z2, z3=z3,
        theta=theta, lam=lam, stale=stale, t=t + 1)
    return new_state, {"flat_ii": state.cuts_ii.a, "cutval": cutval}


# ---------------------------------------------------------------------------
# cut refresh (Eqs. 23-25, Alg. 1 middle block)
# ---------------------------------------------------------------------------

def cut_refresh(problem: TrilevelProblem, hyper: Hyper,
                state: AFTOState) -> AFTOState:
    """Generate one I-layer and one II-layer mu-cut at the current point,
    then drop inactive cuts.  Runs every t_pre master iterations, t < t1."""
    t = state.t

    # warm-start the inner states at the current outer point (duals kept)
    inner3 = InnerState3(x3=state.X3, z3=state.z3, phi=state.inner3.phi)

    # ---- I-layer cut (Eq. 23) at (X3, z1, z2, z3)
    h0_i, (gX3, gz3, gz1, gz2) = tree_lib.value_and_grad(
        lambda X3, z3, z1, z2: inner_lib.h_i(problem, hyper, X3, z3, z1, z2,
                                             inner3),
        state.X3, state.z3, state.z1, state.z2)
    # derivation-correct bound (see the reference cuts.py docstring)
    bound_i = hyper.alpha1 + hyper.alpha2 \
        + (hyper.n_workers + 1) * hyper.alpha3
    coeffs_i, c_i = cuts_lib.make_cut(
        h0_i,
        {"a1": gz1, "a2": gz2, "a3": gz3, "b3": gX3},
        {"a1": state.z1, "a2": state.z2, "a3": state.z3, "b3": state.X3},
        hyper.eps_i, hyper.mu_i, bound_i)
    cuts_i = cuts_lib.add_cut(state.cuts_i, coeffs_i, c_i, t)

    # ---- level-2 rollout under the updated I-polytope (for h_II and the
    #      gamma-based drop rule)
    inner2 = InnerState2(x2=state.X2, z2=state.z2, phi=state.inner2.phi,
                         s=state.inner2.s * cuts_i.active,
                         gamma=state.inner2.gamma * cuts_i.active)

    # ---- II-layer cut (Eq. 24) at (X2, X3, z1, z2, z3)
    h0_ii, (gX2, gz2b, gz1b, gz3b, gX3b) = tree_lib.value_and_grad(
        lambda X2, z2, z1, z3, X3: inner_lib.h_ii(
            problem, hyper, X2, z2, z1, z3, X3, cuts_i, inner2),
        state.X2, state.z2, state.z1, state.z3, state.X3)
    bound_ii = hyper.alpha1 + (hyper.n_workers + 1) * (hyper.alpha2
                                                       + hyper.alpha3)
    coeffs_ii, c_ii = cuts_lib.make_cut(
        h0_ii,
        {"a1": gz1b, "a2": gz2b, "a3": gz3b, "b2": gX2, "b3": gX3b},
        {"a1": state.z1, "a2": state.z2, "a3": state.z3,
         "b2": state.X2, "b3": state.X3},
        hyper.eps_ii, hyper.mu_ii, bound_ii)
    cuts_ii = cuts_lib.add_cut(state.cuts_ii, coeffs_ii, c_ii, t)

    # run the inner-2 rollout once to obtain gamma^K for the drop rule
    inner2_k = inner_lib.rollout2(problem, hyper, state.z1, state.z3,
                                  state.X3, cuts_i, inner2)
    gamma_k = inner2_k.gamma

    # ---- drop inactive cuts (Eq. 25); never drop the cut just added
    fresh_i = (cuts_i.age == t).float()
    cuts_i = cuts_lib.drop_inactive(cuts_i, gamma_k + fresh_i)
    fresh_ii = (cuts_ii.age == t).float()
    cuts_ii = cuts_lib.drop_inactive(cuts_ii, state.lam + fresh_ii)

    lam = state.lam * cuts_ii.active
    inner3_k = inner_lib.rollout3(problem, hyper, state.z1, state.z2,
                                  inner3)

    return dataclasses.replace(
        state, cuts_i=cuts_i, cuts_ii=cuts_ii, lam=lam, gamma_k=gamma_k,
        inner3=inner3_k, inner2=inner2_k)
