"""K-round federated ADMM rollouts: the phi_I / phi_II estimates (Eqs. 5-12).

Counterpart of `repro/core/inner.py`.  Each communication round is one
Jacobi ADMM sweep:
  workers  : x' <- x' - eta_x * grad_x L_p          (Eq. 5)
  master   : z' <- z' - eta_z * grad_z L_p          (Eq. 6, at the *old* x)
  master   : dual ascent at the new primal point    (Eq. 7)
Both gradients of a round are taken at the same (old) point, so one
`torch.func.grad` call gives them: the partial derivatives w.r.t. the
round's (x, z) at that point, whatever the duals and the outer variables
were computed from.  `h_I` / `h_II` (Eqs. 9/12) are differentiated w.r.t.
the outer variables *through* the rollout by an outer transform, which
each round's gradient stays differentiable by, as `jax.grad` nests in
the reference; the rollouts that only produce a state (the drop rule and
the warm start in `cut_refresh`) run under no outer transform.  The
rollouts start from their `init` as a constant (the reference's
`lax.stop_gradient`), and run under `torch.func.vmap` as they are.
"""
from __future__ import annotations

import torch

from repro_torch.core import cuts as cuts_lib
from repro_torch.core import lagrangian as lag
from repro_torch.core.types import (FlatCuts, Hyper, InnerState2,
                                    InnerState3, TrilevelProblem)
from repro_torch.kernels import ops
from repro_torch.utils import tree as tree_lib
from repro_torch.utils.tree import (tree_axpy, tree_map, tree_norm_sq,
                                    tree_sub)


def _dual_step(phi, x_new, z_new, eta):
    """phi_j + eta (x_j - z) over the stacked workers."""
    return tree_map(lambda p, x, z: p + eta * (x - z[None]),
                    phi, x_new, z_new)


def _const(st):
    """An inner state as a constant of any enclosing derivative."""
    return type(st)(**{k: tree_map(torch.Tensor.detach, v)
                       for k, v in vars(st).items()})


# ---------------------------------------------------------------------------
# level 3
# ---------------------------------------------------------------------------

def rollout3(problem: TrilevelProblem, hyper: Hyper, z1, z2,
             init: InnerState3) -> InnerState3:
    """K rounds of Eq. 5-7, differentiable w.r.t. (z1, z2)."""
    st = _const(init)
    for _ in range(hyper.k_inner):
        g_x, g_z = tree_lib.grad(
            lambda x3, z3: lag.l_p3(problem, hyper, z1, z2,
                                    InnerState3(x3=x3, z3=z3, phi=st.phi)),
            st.x3, st.z3)
        x3_new = tree_axpy(-hyper.eta_x, g_x, st.x3)
        z3_new = tree_axpy(-hyper.eta_z, g_z, st.z3)
        phi_new = _dual_step(st.phi, x3_new, z3_new, hyper.eta_dual_inner)
        st = InnerState3(x3=x3_new, z3=z3_new, phi=phi_new)
    return st


def h_i(problem: TrilevelProblem, hyper: Hyper,
        X3, z3, z1, z2, init: InnerState3):
    """h_I({x3_j}, z1, z2', z3) = ||[{x3_j}; z3] - phi_I(z1, z2')||^2."""
    est = rollout3(problem, hyper, z1, z2, init)
    return tree_norm_sq(tree_sub(X3, est.x3)) \
        + tree_norm_sq(tree_sub(z3, est.z3))


# ---------------------------------------------------------------------------
# level 2
# ---------------------------------------------------------------------------

def _rollout2_fused(problem: TrilevelProblem, hyper: Hyper, z1, z3, X3,
                    cuts_i: FlatCuts, init: InnerState2) -> InnerState2:
    """The `hyper.use_fused_inner` round body: the cut algebra of a
    round (weights, masked z2 descent, re-evaluation, slack and gamma
    steps) in one `ops.fused_cut_round`, which reads A twice where the
    plain body reads it three times.  The cut-free part (per-worker f2,
    consensus terms, phi ascent) stays in `lag.l_p2_base`; its x2/z2
    gradients equal the full `l_p2` ones minus the cut term the fused
    op applies.  Differentiable to any order through `ops.FusedRound`.
    """
    spec = cuts_i.spec
    st = _const(init)
    # 1 on z2's columns of the flattened point, 0 elsewhere (z1, z3 and
    # X3 do not move within the rollout)
    mask = cuts_lib.flatten_point(
        spec, None, tree_map(torch.ones_like, st.z2), None, None, None)
    for _ in range(hyper.k_inner):
        g_x, g_z = tree_lib.grad(
            lambda x2, z2: lag.l_p2_base(
                problem, hyper, z1, z3, X3,
                InnerState2(x2=x2, z2=z2, phi=st.phi, s=st.s,
                            gamma=st.gamma)),
            st.x2, st.z2)
        x2_new = tree_axpy(-hyper.eta_x, g_x, st.x2)
        v_new, _cv1, s_new, gamma_new = ops.fused_cut_round(
            cuts_i.a, cuts_lib.flatten_point(spec, z1, st.z2, z3, None, X3),
            cuts_lib.flatten_point(spec, None, g_z, None, None, None),
            mask, cuts_i.c, cuts_i.active, st.s, st.gamma,
            eta_z=hyper.eta_z, eta_s=hyper.eta_s,
            eta_dual=hyper.eta_dual_inner, rho2=hyper.rho2,
            impl=hyper.cut_impl)
        z2_new = cuts_lib.unflatten_coeff(spec, v_new)[1]
        phi_new = _dual_step(st.phi, x2_new, z2_new, hyper.eta_dual_inner)
        st = InnerState2(x2=x2_new, z2=z2_new, phi=phi_new, s=s_new,
                         gamma=gamma_new)
    return st


def rollout2(problem: TrilevelProblem, hyper: Hyper, z1, z3, X3,
             cuts_i: FlatCuts, init: InnerState2) -> InnerState2:
    """K rounds of Jacobi ADMM on Eq. 11 (with slack/cut multipliers),
    differentiable w.r.t. (z1, z3, X3).  With `hyper.use_fused_inner`
    each round's cut algebra runs in the fused round
    (`_rollout2_fused`); the body below is its parity oracle."""
    if hyper.use_fused_inner:
        return _rollout2_fused(problem, hyper, z1, z3, X3, cuts_i, init)
    zero = torch.zeros_like(cuts_i.active)
    st = _const(init)
    for _ in range(hyper.k_inner):
        g_x, g_z = tree_lib.grad(
            lambda x2, z2: lag.l_p2(
                problem, hyper, z1, z3, X3, cuts_i,
                InnerState2(x2=x2, z2=z2, phi=st.phi, s=st.s,
                            gamma=st.gamma)),
            st.x2, st.z2)
        x2_new = tree_axpy(-hyper.eta_x, g_x, st.x2)
        z2_new = tree_axpy(-hyper.eta_z, g_z, st.z2)

        # the reference evaluates these cut values twice at the same
        # point (slack step, then dual step); once is the same number
        cutval = cuts_lib.eval_cuts(cuts_i, z1, z2_new, z3, X3=X3,
                                    impl=hyper.cut_impl)
        # slack: projected descent, s >= 0 (only on active cut slots);
        # torch.maximum splits the gradient at ties as jnp.maximum does
        g_s = (st.gamma + hyper.rho2 * (cutval + st.s)) * cuts_i.active
        s_new = torch.maximum(zero, st.s - hyper.eta_s * g_s) \
            * cuts_i.active
        phi_new = _dual_step(st.phi, x2_new, z2_new, hyper.eta_dual_inner)
        gamma_new = torch.maximum(
            zero, st.gamma + hyper.eta_dual_inner * (cutval + s_new)) \
            * cuts_i.active
        st = InnerState2(x2=x2_new, z2=z2_new, phi=phi_new, s=s_new,
                         gamma=gamma_new)
    return st


def h_ii(problem: TrilevelProblem, hyper: Hyper,
         X2, z2, z1, z3, X3, cuts_i: FlatCuts, init: InnerState2):
    """h_II({x2_j},{x3_j},z) = ||[{x2_j}; z2] - phi_II(z1, z3, {x3_j})||^2."""
    est = rollout2(problem, hyper, z1, z3, X3, cuts_i, init)
    return tree_norm_sq(tree_sub(X2, est.x2)) \
        + tree_norm_sq(tree_sub(z2, est.z2))
