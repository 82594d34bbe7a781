"""Worker-mesh sharded AFTO: the step, the gap and the cut refresh
(Eqs. 23-25) with the workers split over a mesh of processes.

Counterpart of `repro/core/sharded.py`.  Each shard (a rank of a
`launch.mesh.WorkerMesh`) carries n_loc = N / n_shards workers' variable
stacks (X1/X2/X3, theta, stale views, inner x and duals), its workers'
rows of `problem.data`, and a local polytope of the replicated
a-columns plus its workers' b-columns (`fed.sharding.shard_state`).
Master variables (z1/z2/z3, lam, the cuts' c/active/age, t) are
replicated: every shard computes them from the same numbers.  The step
needs one sum over the mesh (the theta-sum and the cut scalars' b-part,
which the reference psums separately), the recorded gap one more.

The refresh's inner ADMM rollouts (Eqs. 5-12) run shard-locally: each
round's worker updates touch only local x-stacks, and the master
z-updates sum the shards' gradient partials (the paper's K
communication rounds).  The mu-cut coefficients need d h_I / d(z1, z2)
and d h_II / d(z1, z3, {x3_j}) through those rollouts, and a collective
inside a `torch.func` transform is taken for the identity (its
derivative, another sum, is lost), so the rollout VJPs are assembled by
hand from shard-local `torch.func.vjp` calls, as the reference does:

  * forward rounds split into a local worker part, a replicated master
    part, and the summed aggregates that connect them;
  * the backward rounds transpose each part locally and insert the one
    sum the true adjoint needs: of the cotangent that flowed through a
    per-worker use of a replicated value;
  * an input used both per worker and by the replicated master algebra
    (z1 in h_II: the worker objectives and the a1-columns) rides two
    channels: the per-worker one is summed, the replicated one counted
    once.

Every sum over the mesh (`WorkerMesh.all_reduce`) sits between the
transformed pieces, never inside one.  The pieces run through a `Local`,
which calls them once for one run, or under `torch.func.vmap` over a
sweep's runs (`core.engine.run_swept(mesh=)`): the vmap covers the local
parts of each stage, and the sums act on the stacked (R, ...)
aggregates between stages.  The per-worker cut coefficients (b-blocks)
and the gradients w.r.t. each worker's own variables stay shard-local;
only z-sized partials and (P,)-sized cut scalars cross the mesh, which
`traffic_record` counts byte for byte.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils._pytree as pytree

from repro_torch.core import afto as afto_lib
from repro_torch.core import cuts as cuts_lib
from repro_torch.core import lagrangian as lag
from repro_torch.core import stationarity as stat_lib
from repro_torch.core.types import (AFTOState, FlatCuts, Hyper,
                                    InnerState2, InnerState3)
from repro_torch.launch.mesh import WORKER_AXIS
from repro_torch.utils import tree as tree_lib
from repro_torch.utils.tree import (tree_add, tree_axpy, tree_dot, tree_map,
                                    tree_norm_sq, tree_sub, tree_zeros_like)


def _in_dims(arg):
    return pytree.tree_map(lambda x: 0 if torch.is_tensor(x) else None, arg)


class Local:
    """How a shard runs its local pieces.

    `local(fn, *args)` is `fn(problem, hyper, *args)` for one run; for a
    sweep (`batched`), `fn` is vmapped over the leading run axis of every
    tensor in `args`, with each run's swept hyper `values` and its
    `data` rows.  `local.reduce(label=tree, ...)` sums over the mesh,
    outside any transform."""

    def __init__(self, problem, hyper: Hyper, mesh, batched: bool = False,
                 values=None, data=None):
        self.problem, self.hyper, self.mesh = problem, hyper, mesh
        self.batched = batched
        self.values = dict(values or {})
        self.data = data

    def __call__(self, fn, *args):
        if not self.batched:
            return fn(self.problem, self.hyper, *args)

        def one(vals, run_data, *a):
            prob = self.problem if run_data is None else \
                dataclasses.replace(self.problem, data=run_data)
            return fn(prob, dataclasses.replace(self.hyper, **vals), *a)

        dims = (0 if self.values else None,
                None if self.data is None else 0) \
            + tuple(_in_dims(a) for a in args)
        return torch.func.vmap(one, in_dims=dims)(self.values, self.data,
                                                  *args)

    def reduce(self, **parts):
        return self.mesh.all_reduce(**parts)


# ---------------------------------------------------------------------------
# the step (Eqs. 16-21) and the recorded gap
# ---------------------------------------------------------------------------

def _step_local(problem, hyper, state, active):
    grads = afto_lib.local_f1_grads(problem, state.X1, state.X2, state.X3)
    X, ga, theta_sum = afto_lib.step_workers(problem, hyper, state, active,
                                             grads)
    return X, ga, theta_sum, cuts_lib.b_cols_matvec(state.cuts_ii, X[1],
                                                    X[2])


def _step_master(problem, hyper, state, active, X, ga, theta_sum, b_agg):
    fc = state.cuts_ii
    return afto_lib.step_master(
        problem, hyper, state, active, X, ga, theta_sum,
        lambda z1, z2, z3: cuts_lib.worker_split_values(fc, z1, z2, z3,
                                                        b_agg))


def afto_step_sharded(local: Local, state: AFTOState, active):
    """`afto.afto_step_aux` on a shard: one sum over the mesh, of the
    theta-sum (for the z1 update) and the b-column cut scalars."""
    X, ga, theta_sum, b_part = local(_step_local, state, active)
    theta_sum, b_agg = local.reduce(step=(theta_sum, b_part))["step"]
    return local(_step_master, state, active, X, ga, theta_sum, b_agg)


def _gap_local_b(problem, hyper, state):
    return (stat_lib.gap_workers(problem, hyper, state, state.cuts_ii.a),
            cuts_lib.b_cols_matvec(state.cuts_ii, state.X2, state.X3))


def _cut_values(problem, hyper, state, b_agg):
    return cuts_lib.worker_split_values(state.cuts_ii, state.z1, state.z2,
                                        state.z3, b_agg)


def gap_sharded(local: Local, state: AFTOState, aux=None):
    """`stationarity.stationarity_gap_sq` on a shard: the worker blocks'
    squared norms and the theta-sum are summed over the mesh; without
    the step's `aux` (a refresh rewrote the polytope) the cut values'
    b-part rides the same collective ("gap_aux")."""
    if aux is None:
        (gap, theta_sum, ga), b_part = local(_gap_local_b, state)
        red = local.reduce(gap=(gap, theta_sum), gap_aux=b_part)
        cutval = local(_cut_values, state, red["gap_aux"])
    else:
        gap, theta_sum, ga = local(stat_lib.gap_workers, state,
                                   aux["flat_ii"])
        red = local.reduce(gap=(gap, theta_sum))
        cutval = aux["cutval"]
    gap, theta_sum = red["gap"]
    return local(stat_lib.gap_master, state, gap, theta_sum, ga, cutval)


def record_sharded(local: Local, state: AFTOState, metrics_fn=None,
                   aux=None) -> dict:
    """One history row on a shard (`engine.record`): the gap over the
    whole federation; `metrics_fn` sees the shard-local state."""
    vals = {"gap_sq": gap_sharded(local, state, aux)}
    vals.update(local(_counts_and_metrics, state, metrics_fn))
    return vals


def _counts_and_metrics(problem, hyper, state, metrics_fn):
    vals = {"n_cuts_i": torch.sum(state.cuts_i.active),
            "n_cuts_ii": torch.sum(state.cuts_ii.active)}
    if metrics_fn is not None:
        vals.update(metrics_fn(state))
    return vals


# ---------------------------------------------------------------------------
# level-3 rollout (Eqs. 5-7), sharded forward + hand-assembled VJP
# ---------------------------------------------------------------------------
#
# Round decomposition (st = InnerState3(x3 local, z3 replicated, phi
# local); l_p3 over the LOCAL workers only):
#   agg  = sum over the mesh of d l_p3_loc / d z3        [master uplink]
#   z3'  = z3 - eta_z * agg                              [replicated]
#   x3'  = x3 - eta_x * d l_p3_loc / d x3                [shard-local]
#   phi' = phi + eta_dual * (x3' - z3')                  [shard-local]

def _l_p3_local(problem, hyper, z1, z2, x3, z3, phi):
    """Eq. 4 summed over THIS shard's workers (`lagrangian.l_p3` on the
    local stacks) as a function of explicit arguments."""
    return lag.l_p3(problem, hyper, z1, z2,
                    InnerState3(x3=x3, z3=z3, phi=phi))


def _roll3_stats(problem, hyper, z1, z2, x3, z3, phi):
    """The shard's partial d l_p3 / d z3 at the old round point."""
    return tree_lib.grad(lambda z3_: _l_p3_local(
        problem, hyper, z1, z2, x3, z3_, phi), z3)[0]


def _dual_step(hyper, phi, x_new, z_new):
    return tree_map(lambda p, x, z: p + hyper.eta_dual_inner * (x - z[None]),
                    phi, x_new, z_new)


def _roll3_worker(problem, hyper, z1, z2, x3, z3_old, phi, z3_new):
    g_x = tree_lib.grad(lambda x3_: _l_p3_local(
        problem, hyper, z1, z2, x3_, z3_old, phi), x3)[0]
    x3n = tree_axpy(-hyper.eta_x, g_x, x3)
    return x3n, _dual_step(hyper, phi, x3n, z3_new)


def _r3_stats(problem, hyper, z1, z2, st):
    return _roll3_stats(problem, hyper, z1, z2, st.x3, st.z3, st.phi)


def _r3_round(problem, hyper, z1, z2, st, agg):
    z3n = tree_axpy(-hyper.eta_z, agg, st.z3)
    x3n, phin = _roll3_worker(problem, hyper, z1, z2, st.x3, st.z3, st.phi,
                              z3n)
    return InnerState3(x3=x3n, z3=z3n, phi=phin)


def rollout3_sharded_fwd(local: Local, z1, z2, init: InnerState3):
    """K sharded rounds of Eqs. 5-7: (final state, residuals), the
    residuals each round's state and its summed aggregate, so the VJP
    runs no forward collective again."""
    st, residuals = init, []
    for _ in range(local.hyper.k_inner):
        agg = local.reduce(refresh=local(_r3_stats, z1, z2, st))["refresh"]
        residuals.append((st, agg))
        st = local(_r3_round, z1, z2, st, agg)
    return st, residuals


def _r3_bwd_worker(problem, hyper, z1, z2, st_r, agg, ct):
    z3n = tree_axpy(-hyper.eta_z, agg, st_r.z3)
    _, vjp = torch.func.vjp(
        lambda z1_, z2_, x3, z3_old, phi, z3_new: _roll3_worker(
            problem, hyper, z1_, z2_, x3, z3_old, phi, z3_new),
        z1, z2, st_r.x3, st_r.z3, st_r.phi, z3n)
    return vjp((ct.x3, ct.phi))


def _r3_bwd_stats(problem, hyper, z1, z2, st_r, ct_z3, d_z3n_w, d_z3old_w):
    # master transpose: z3' = z3 - eta_z * agg
    ct_z3n = tree_add(ct_z3, d_z3n_w)
    ct_agg = tree_map(lambda g: -hyper.eta_z * g, ct_z3n)
    _, vjp = torch.func.vjp(
        lambda z1_, z2_, x3, z3_old, phi: _roll3_stats(
            problem, hyper, z1_, z2_, x3, z3_old, phi),
        z1, z2, st_r.x3, st_r.z3, st_r.phi)
    d_z1s, d_z2s, d_x3s, d_z3old_s, d_phis = vjp(ct_agg)
    return ct_z3n, (d_z1s, d_z2s, d_x3s, d_phis), \
        tree_add(d_z3old_w, d_z3old_s)


def _r3_bwd_merge(problem, hyper, ct_z3n, d_z3old, worker, stats, acc):
    d_z1w, d_z2w, d_x3, d_phi = worker
    d_z1s, d_z2s, d_x3s, d_phis = stats
    az1, az2 = acc
    ct = InnerState3(x3=tree_add(d_x3, d_x3s),
                     z3=tree_add(ct_z3n, d_z3old),
                     phi=tree_add(d_phi, d_phis))
    return ct, (tree_add(az1, tree_add(d_z1w, d_z1s)),
                tree_add(az2, tree_add(d_z2w, d_z2s)))


def _zeros(problem, hyper, tree):
    return tree_zeros_like(tree)


def rollout3_sharded_vjp(local: Local, z1, z2, residuals, ct_final):
    """d(rollout3)/d(z1, z2) against `ct_final` (its x3/phi shard-local,
    its z3 replicated).  Each backward round transposes the worker and
    stats pieces locally and sums over the mesh exactly the cotangent
    that crossed a per-worker use of a replicated value; z1/z2 enter
    only through per-worker objectives, so their cotangents take one
    final sum."""
    ct = ct_final
    acc = local(_zeros, (z1, z2))
    for st_r, agg in reversed(residuals):
        d_z1w, d_z2w, d_x3, d_z3old_w, d_phi, d_z3n_w = local(
            _r3_bwd_worker, z1, z2, st_r, agg, ct)
        d_z3n_w = local.reduce(refresh=d_z3n_w)["refresh"]
        ct_z3n, stats, d_z3old = local(_r3_bwd_stats, z1, z2, st_r, ct.z3,
                                       d_z3n_w, d_z3old_w)
        d_z3old = local.reduce(refresh=d_z3old)["refresh"]
        ct, acc = local(_r3_bwd_merge, ct_z3n, d_z3old,
                        (d_z1w, d_z2w, d_x3, d_phi), stats, acc)
    # the initial state's cotangent is dropped: the rollout starts from
    # its init as a constant
    return tuple(local.reduce(refresh=acc)["refresh"])


# ---------------------------------------------------------------------------
# level-2 rollout (Eq. 11), sharded forward + hand-assembled VJP
# ---------------------------------------------------------------------------
#
# Beyond level 3: the I-polytope cut terms.  The cut value splits as
# a-part(z1, z2', z3) + sum over the mesh of b-part(X3_loc), where the
# b-part does not change over the rounds (X3 is a rollout input), so it
# is ONE pre-aggregate `b_agg`; the a-part and the (gamma, s) multiplier
# algebra are replicated master computation whose z2 gradient has the
# closed form sum_l (gamma_l + rho2 viol_l) active_l a2_l, which keeps
# every transform here free of collectives.

def _cut_b_partial(cuts_i: FlatCuts, X3):
    """This shard's b-column part of the I-cut values (the per-worker
    cut scalars of Eq. 11; layer-I cuts carry no b2 coefficients)."""
    return cuts_lib.b_cols_matvec(cuts_i, None, X3)


def _roll2_master(hyper, cuts_i, z1, z3, b_agg, z2, s, gamma, agg1):
    """The replicated master algebra of one Eq. 11 round: the z2 step
    (the summed worker partials + the closed-form cut gradient at the
    OLD z2), then the slack and multiplier updates at the new z2."""
    zero = torch.zeros_like(s)
    cutval_old = cuts_lib.worker_split_values(cuts_i, z1, z2, z3, b_agg)
    viol_old = (cutval_old + s) * cuts_i.active
    g_cut = cuts_lib.cut_weighted_coeff(
        cuts_i, gamma + hyper.rho2 * viol_old, "a2")
    z2n = tree_axpy(-hyper.eta_z, tree_add(agg1, g_cut), z2)

    cutval = cuts_lib.worker_split_values(cuts_i, z1, z2n, z3, b_agg)
    g_s = (gamma + hyper.rho2 * (cutval + s)) * cuts_i.active
    sn = torch.maximum(zero, s - hyper.eta_s * g_s) * cuts_i.active
    gamman = torch.maximum(
        zero, gamma + hyper.eta_dual_inner * (cutval + sn)) * cuts_i.active
    return z2n, sn, gamman


def _l_p2_worker_local(problem, hyper, z1, x2, z2, phi, X3):
    """The per-worker part of Eq. 11 over THIS shard's workers (the
    cut-free `lagrangian.l_p2_base`)."""
    return lag.l_p2_base(problem, hyper, z1, None, X3,
                         InnerState2(x2=x2, z2=z2, phi=phi, s=None,
                                     gamma=None))


def _roll2_stats(problem, hyper, z1, x2, z2, phi, X3):
    """The shard's partial d l_p2_worker / d z2 at the old round point."""
    return tree_lib.grad(lambda z2_: _l_p2_worker_local(
        problem, hyper, z1, x2, z2_, phi, X3), z2)[0]


def _roll2_worker(problem, hyper, z1, x2, z2_old, phi, X3, z2_new):
    g_x = tree_lib.grad(lambda x2_: _l_p2_worker_local(
        problem, hyper, z1, x2_, z2_old, phi, X3), x2)[0]
    x2n = tree_axpy(-hyper.eta_x, g_x, x2)
    return x2n, _dual_step(hyper, phi, x2n, z2_new)


def _r2_b(problem, hyper, cuts_i, X3):
    return _cut_b_partial(cuts_i, X3)


def _r2_stats(problem, hyper, z1, X3, st):
    return _roll2_stats(problem, hyper, z1, st.x2, st.z2, st.phi, X3)


def _r2_round(problem, hyper, z1, z3, X3, cuts_i, b_agg, st, agg1):
    z2n, sn, gamman = _roll2_master(hyper, cuts_i, z1, z3, b_agg, st.z2,
                                    st.s, st.gamma, agg1)
    x2n, phin = _roll2_worker(problem, hyper, z1, st.x2, st.z2, st.phi, X3,
                              z2n)
    return InnerState2(x2=x2n, z2=z2n, phi=phin, s=sn, gamma=gamman)


def rollout2_sharded_fwd(local: Local, z1, z3, X3, cuts_i: FlatCuts,
                         init: InnerState2):
    """K sharded rounds of Eq. 11: (final state, residuals, b_agg), the
    residuals each round's state and its summed agg1."""
    b_agg = local.reduce(refresh=local(_r2_b, cuts_i, X3))["refresh"]
    st, residuals = init, []
    for _ in range(local.hyper.k_inner):
        agg1 = local.reduce(refresh=local(_r2_stats, z1, X3, st))["refresh"]
        residuals.append((st, agg1))
        st = local(_r2_round, z1, z3, X3, cuts_i, b_agg, st, agg1)
    return st, residuals, b_agg


def _r2_bwd_worker(problem, hyper, z1, z3, X3, cuts_i, b_agg, st_r, agg1,
                   ct):
    z2n = _roll2_master(hyper, cuts_i, z1, z3, b_agg, st_r.z2, st_r.s,
                        st_r.gamma, agg1)[0]
    _, vjp = torch.func.vjp(
        lambda z1_, x2, z2_old, phi, X3_, z2_new: _roll2_worker(
            problem, hyper, z1_, x2, z2_old, phi, X3_, z2_new),
        z1, st_r.x2, st_r.z2, st_r.phi, X3, z2n)
    return vjp((ct[0], ct[1]))


def _r2_bwd_master(problem, hyper, z1, z3, X3, cuts_i, b_agg, st_r, agg1,
                   ct, d_z2n_w, d_z2old_w):
    _, ct_phi, (ct_z2, ct_s, ct_gamma) = ct
    # master transpose (replicated computation, counted once)
    ct_z2n = tree_add(ct_z2, d_z2n_w)
    _, m_vjp = torch.func.vjp(
        lambda z1_, z3_, bagg_, z2, s, gamma, agg1_: _roll2_master(
            hyper, cuts_i, z1_, z3_, bagg_, z2, s, gamma, agg1_),
        z1, z3, b_agg, st_r.z2, st_r.s, st_r.gamma, agg1)
    (d_z1m, d_z3m, d_bagg, d_z2old_m, d_s, d_gamma,
     ct_agg1) = m_vjp((ct_z2n, ct_s, ct_gamma))
    _, s_vjp = torch.func.vjp(
        lambda z1_, x2, z2, phi, X3_: _roll2_stats(
            problem, hyper, z1_, x2, z2, phi, X3_),
        z1, st_r.x2, st_r.z2, st_r.phi, X3)
    d_z1s, d_x2s, d_z2old_s, d_phis, d_x3s = s_vjp(ct_agg1)
    return ((d_z1m, d_z3m, d_bagg, d_z2old_m, d_s, d_gamma),
            (d_z1s, d_x2s, d_phis, d_x3s), tree_add(d_z2old_w, d_z2old_s))


def _r2_bwd_merge(problem, hyper, d_z2old, worker, master, stats, acc):
    d_z1w, d_x2, d_phi, d_x3w = worker
    d_z1m, d_z3m, d_bagg, d_z2old_m, d_s, d_gamma = master
    d_z1s, d_x2s, d_phis, d_x3s = stats
    az1v, az1r, az3r, ax3, abagg = acc
    ct = (tree_add(d_x2, d_x2s), tree_add(d_phi, d_phis),
          (tree_add(d_z2old_m, d_z2old), d_s, d_gamma))
    return ct, (tree_add(az1v, tree_add(d_z1w, d_z1s)),
                tree_add(az1r, d_z1m),
                tree_add(az3r, d_z3m),
                tree_add(ax3, tree_add(d_x3w, d_x3s)),
                abagg + d_bagg)


def _r2_bwd_x3(problem, hyper, cuts_i, X3, ax3, abagg):
    # b_agg = the sum over the mesh of the local b-contraction(X3): the
    # replicated cotangent flows back to every shard's own columns in full
    _, b_vjp = torch.func.vjp(lambda X3_: _cut_b_partial(cuts_i, X3_), X3)
    return tree_add(ax3, b_vjp(abagg)[0])


def _r2_acc0(problem, hyper, z1, z3, X3, b_agg):
    return (tree_zeros_like(z1), tree_zeros_like(z1), tree_zeros_like(z3),
            tree_zeros_like(X3), torch.zeros_like(b_agg))


def rollout2_sharded_vjp(local: Local, z1, z3, X3, cuts_i, residuals, b_agg,
                         ct_final: InnerState2):
    """d(rollout2)/d(z1, z3, X3) against `ct_final`.

    z1 is used per worker (f2) AND by the replicated a1-column algebra,
    so its cotangent accumulates on two channels: the per-worker one is
    summed over the mesh, the replicated one counted once.  z3 appears
    only in the a3-columns (replicated); X3 only in per-worker terms and
    the b-column pre-aggregate (both shard-local)."""
    ct = (ct_final.x2, ct_final.phi,
          (ct_final.z2, ct_final.s, ct_final.gamma))
    acc = local(_r2_acc0, z1, z3, X3, b_agg)
    for st_r, agg1 in reversed(residuals):
        d_z1w, d_x2, d_z2old_w, d_phi, d_x3w, d_z2n_w = local(
            _r2_bwd_worker, z1, z3, X3, cuts_i, b_agg, st_r, agg1, ct)
        d_z2n_w = local.reduce(refresh=d_z2n_w)["refresh"]
        master, stats, d_z2old = local(
            _r2_bwd_master, z1, z3, X3, cuts_i, b_agg, st_r, agg1, ct,
            d_z2n_w, d_z2old_w)
        d_z2old = local.reduce(refresh=d_z2old)["refresh"]
        ct, acc = local(_r2_bwd_merge, d_z2old, (d_z1w, d_x2, d_phi, d_x3w),
                        master, stats, acc)
    az1v, az1r, az3r, ax3, abagg = acc
    ct_x3 = local(_r2_bwd_x3, cuts_i, X3, ax3, abagg)
    az1v = local.reduce(refresh=az1v)["refresh"]
    ct_z1 = local(lambda p, h, a, b: tree_add(a, b), az1v, az1r)
    return ct_z1, az3r, ct_x3


# ---------------------------------------------------------------------------
# mu-cut constants with worker-split blocks
# ---------------------------------------------------------------------------

_B_KEYS = ("b2", "b3")


def _cut_sums(grads, point):
    """(replicated, shard-partial) <g, v0> and ||v0||^2 of `make_cut`:
    a-block terms are replicated, worker-block terms shard-partial."""
    zero = torch.zeros((), dtype=torch.float32,
                       device=tree_lib.tree_leaves(point)[0].device)
    gv_rep = sq_rep = gv_loc = sq_loc = zero
    for k, g in grads.items():
        if k in _B_KEYS:
            gv_loc = gv_loc + tree_dot(g, point[k])
            sq_loc = sq_loc + tree_norm_sq(point[k])
        else:
            gv_rep = gv_rep + tree_dot(g, point[k])
            sq_rep = sq_rep + tree_norm_sq(point[k])
    return (gv_rep, sq_rep), torch.stack([gv_loc, sq_loc])


def make_cut_sharded(h0, grads, point, eps, mu, bound_alpha, loc):
    """`cuts.make_cut` given `_cut_sums`' replicated sums in `point` order
    and `loc`, its shard-partial [<g, v0>, ||v0||^2] summed over the
    mesh."""
    (gv_rep, sq_rep), _ = _cut_sums(grads, point)
    gv0 = gv_rep + loc[0]
    v0_sq = sq_rep + loc[1]
    c = eps + mu * (bound_alpha + v0_sq) - h0 + gv0
    return grads, c


# ---------------------------------------------------------------------------
# the sharded cut refresh (Eqs. 23-25)
# ---------------------------------------------------------------------------

def _inner3(problem, hyper, state):
    return InnerState3(x3=state.X3, z3=state.z3, phi=state.inner3.phi)


def _cut_i_local(problem, hyper, state, est3):
    dx3 = tree_sub(state.X3, est3.x3)
    dz3 = tree_sub(state.z3, est3.z3)
    ct3 = InnerState3(x3=tree_map(lambda d: -2.0 * d, dx3),
                      z3=tree_map(lambda d: -2.0 * d, dz3),
                      phi=tree_zeros_like(est3.phi))
    return dx3, dz3, ct3


def _grads_i(state, dx3, dz3, gz1, gz2):
    grads = {"a1": gz1, "a2": gz2,
             "a3": tree_map(lambda d: 2.0 * d, dz3),       # replicated
             "b3": tree_map(lambda d: 2.0 * d, dx3)}       # shard-local
    point = {"a1": state.z1, "a2": state.z2, "a3": state.z3,
             "b3": state.X3}
    return grads, point


def _cut_i_sums(problem, hyper, state, dx3, dz3, gz1, gz2):
    grads, point = _grads_i(state, dx3, dz3, gz1, gz2)
    return torch.cat([tree_norm_sq(dx3).reshape(1),
                      _cut_sums(grads, point)[1]])


def _bound_i(hyper):
    # the derivation-correct bound of the reference (cuts.py docstring)
    return hyper.alpha1 + hyper.alpha2 + (hyper.n_workers + 1) * hyper.alpha3


def _bound_ii(hyper):
    return hyper.alpha1 + (hyper.n_workers + 1) * (hyper.alpha2
                                                   + hyper.alpha3)


def _add_cut_i(problem, hyper, state, dx3, dz3, gz1, gz2, sums):
    grads, point = _grads_i(state, dx3, dz3, gz1, gz2)
    h0 = sums[0] + tree_norm_sq(dz3)
    coeffs, c = make_cut_sharded(h0, grads, point, hyper.eps_i, hyper.mu_i,
                                 _bound_i(hyper), sums[1:])
    cuts_i = cuts_lib.add_cut(state.cuts_i, coeffs, c, state.t)
    # the level-2 rollout warm-starts under the updated I-polytope
    inner2 = InnerState2(x2=state.X2, z2=state.z2, phi=state.inner2.phi,
                         s=state.inner2.s * cuts_i.active,
                         gamma=state.inner2.gamma * cuts_i.active)
    return cuts_i, inner2


def _cut_ii_local(problem, hyper, state, est2):
    dx2 = tree_sub(state.X2, est2.x2)
    dz2 = tree_sub(state.z2, est2.z2)
    ct2 = InnerState2(x2=tree_map(lambda d: -2.0 * d, dx2),
                      z2=tree_map(lambda d: -2.0 * d, dz2),
                      phi=tree_zeros_like(est2.phi),
                      s=torch.zeros_like(est2.s),
                      gamma=torch.zeros_like(est2.gamma))
    return dx2, dz2, ct2


def _grads_ii(state, dx2, dz2, gz1b, gz3b, gX3b):
    grads = {"a1": gz1b, "a2": tree_map(lambda d: 2.0 * d, dz2),
             "a3": gz3b, "b2": tree_map(lambda d: 2.0 * d, dx2),
             "b3": gX3b}
    point = {"a1": state.z1, "a2": state.z2, "a3": state.z3,
             "b2": state.X2, "b3": state.X3}
    return grads, point


def _cut_ii_sums(problem, hyper, state, dx2, dz2, gz1b, gz3b, gX3b):
    grads, point = _grads_ii(state, dx2, dz2, gz1b, gz3b, gX3b)
    return torch.cat([tree_norm_sq(dx2).reshape(1),
                      _cut_sums(grads, point)[1]])


def _finish_refresh(problem, hyper, state, cuts_i, dx2, dz2, gz1b, gz3b,
                    gX3b, sums, est3, est2):
    t = state.t
    grads, point = _grads_ii(state, dx2, dz2, gz1b, gz3b, gX3b)
    h0 = sums[0] + tree_norm_sq(dz2)
    coeffs, c = make_cut_sharded(h0, grads, point, hyper.eps_ii,
                                 hyper.mu_ii, _bound_ii(hyper), sums[1:])
    cuts_ii = cuts_lib.add_cut(state.cuts_ii, coeffs, c, t)
    # the warm-started rollouts above are Eq. 8/12's inner estimates
    gamma_k = est2.gamma
    # drop inactive cuts (Eq. 25); never drop the cut just added
    fresh_i = (cuts_i.age == t).float()
    cuts_i = cuts_lib.drop_inactive(cuts_i, gamma_k + fresh_i)
    fresh_ii = (cuts_ii.age == t).float()
    cuts_ii = cuts_lib.drop_inactive(cuts_ii, state.lam + fresh_ii)
    return dataclasses.replace(
        state, cuts_i=cuts_i, cuts_ii=cuts_ii, lam=state.lam * cuts_ii.active,
        gamma_k=gamma_k, inner3=est3, inner2=est2)


def refresh_sharded(local: Local, state: AFTOState) -> AFTOState:
    """`afto.cut_refresh` on a shard, through `local`: the same math,
    trajectories equal to the single-device refresh to f32 tolerance.
    `problem.data` and every stacked leaf carry this shard's workers and
    the polytopes are the local column views.

    The h_I / h_II gradients w.r.t. the shard's OWN worker variables
    ({x3_j} for Eq. 23, {x2_j} / {x3_j} for Eq. 24) are closed-form or
    transposed locally: each worker computes its own b-block cut
    coefficients, the paper's federated cut generation; the z-block
    (a-column) coefficients come from the hand-assembled rollout VJPs."""
    # ---- I-layer cut (Eq. 23) at (X3, z1, z2, z3), inner state warm
    est3, res3 = rollout3_sharded_fwd(local, state.z1, state.z2,
                                      local(_inner3, state))
    dx3, dz3, ct3 = local(_cut_i_local, state, est3)
    gz1, gz2 = rollout3_sharded_vjp(local, state.z1, state.z2, res3, ct3)
    sums = local.reduce(refresh=local(_cut_i_sums, state, dx3, dz3, gz1,
                                      gz2))["refresh"]
    cuts_i, inner2 = local(_add_cut_i, state, dx3, dz3, gz1, gz2, sums)

    # ---- level-2 rollout under the updated I-polytope
    est2, res2, b_agg = rollout2_sharded_fwd(local, state.z1, state.z3,
                                             state.X3, cuts_i, inner2)

    # ---- II-layer cut (Eq. 24) at (X2, X3, z1, z2, z3)
    dx2, dz2, ct2 = local(_cut_ii_local, state, est2)
    gz1b, gz3b, gX3b = rollout2_sharded_vjp(
        local, state.z1, state.z3, state.X3, cuts_i, res2, b_agg, ct2)
    sums = local.reduce(refresh=local(_cut_ii_sums, state, dx2, dz2, gz1b,
                                      gz3b, gX3b))["refresh"]
    return local(_finish_refresh, state, cuts_i, dx2, dz2, gz1b, gz3b, gX3b,
                 sums, est3, est2)


def cut_refresh_sharded(problem, hyper: Hyper, state: AFTOState, mesh
                        ) -> AFTOState:
    """`afto.cut_refresh` for one run on a worker mesh (`refresh_sharded`
    through a single-run `Local`)."""
    return refresh_sharded(Local(problem, hyper, mesh), state)


# ---------------------------------------------------------------------------
# communication accounting (the bytes the mesh sums)
# ---------------------------------------------------------------------------

def traffic_record(spec, hyper: Hyper) -> dict:
    """Bytes each shard all-reduces per step, per refresh and per recorded
    gap (f32): an exact count of the sums the sharded engine performs
    (cut scalars, z-sized gradient partials, scalar norms); the worker
    stacks, b-columns and data stay shard-local.  A recorded gap right
    after a refresh adds one (P,) sum of cut scalars ("gap_aux"), since
    the step's cut values no longer hold."""
    na = cuts_lib.n_a_leaves(spec)
    z1 = sum(spec.sizes[:spec.nleaves[0]])
    z2 = sum(spec.sizes[spec.nleaves[0]:spec.nleaves[0] + spec.nleaves[1]])
    z3 = sum(spec.sizes[spec.nleaves[0] + spec.nleaves[1]:na])
    p = hyper.p_max
    k = hyper.k_inner
    # afto_step_sharded: the theta-sum and the cut scalars' b-part
    step = 4 * (p + z1)
    # refresh_sharded, in execution order:
    #   rollout3 fwd            k rounds x z3-sized agg
    #   rollout3 vjp            k rounds x 2 z3-sized cotangent sums
    #                           + final z1 + z2 accumulator sums
    #   h0_i / make_cut_i       1 + 2 scalars
    #   rollout2 fwd            1 b_agg (P,) + k rounds x z2-sized agg1
    #   rollout2 vjp            k rounds x 2 z2-sized cotangent sums
    #                           + final z1 accumulator sum
    #   h0_ii / make_cut_ii     1 + 2 scalars
    refresh = 4 * (3 * k * z3 + 3 * k * z2 + 2 * z1 + z2 + p + 6)
    # record: the worker-norm scalar + the theta-sum
    gap = 4 * (1 + z1)
    return {"step_bytes": step, "refresh_bytes": refresh,
            "gap_bytes": gap, "gap_aux_bytes": 4 * p}
