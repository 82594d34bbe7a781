"""The federated LLM step and cut refresh with the workers split over a
worker mesh: shard-local pieces and the sums between them.

The reference gets this partition from GSPMD: `launch/train.py
_worker_mesh_put` shards the worker-stacked state over a one-axis
"data" mesh and the compiler partitions `fed/trilevel_llm.py` around it.
PyTorch has no such compiler, so this module is the port's own, the
counterpart for the LLM path of `core/sharded.py`.  A shard (a rank of
a `launch.mesh.WorkerMesh`, wrapped in a `Shard`) holds the layout of
`fed.sharding.shard_fed_state`: its n_loc = N / n_shards workers' rows
of X1 / X2 / X3, theta, the stale views and z2, its workers' columns of
the polytopes' b2 / b3 blocks, and every other leaf replicated.  Every
replicated leaf is computed by every shard from the same numbers, so
the shards hold it bit for bit alike.

The step (`afto_llm_step_sharded`) crosses the mesh once ("step"): the
theta sum of gz1, the cut values' worker part (b2 . X2 + b3 . X3, and
a2 . z2 in exact mode, one (P,) partial) and, in sketch mode, the sketch
of z2 (`fed.sketch` blocks; on the card a fixed-point integer sum at a
scale the shards agree on first, so the sum is the whole's sketch bit
for bit).  The worker updates, the b-block contractions and z2's rows
stay local.

The refresh (`cut_refresh_llm_sharded`) runs the rollouts shard-locally
and sums ("refresh") what crosses workers:

  * rollout3's master gradient, -sum_j(dual_j + kappa3 (x_j - z3)), a
    z3-sized f32 sum each inner round (the paper's K communication
    rounds);
  * rollout2's I-cut values, a (P,) partial each round (the gamma / s
    updates are replicated);
  * h_I's and h_II's X-parts and the new cuts' <g, v0> / ||v0||^2 over
    the worker blocks, scalars;
  * the a2 block of each new cut: in sketch mode the shards' partial
    sketches of gZ2, in exact mode an all-gather into the replicated
    a2 of the reference's layout.

The mu-cut coefficients need the rollouts' derivatives w.r.t. (z1, Z2)
and (z1, z3, X3), second-order AD through rounds that take gradients.
A collective inside a `torch.func` transform is taken for the identity
(`WorkerMesh.all_reduce` refuses to run there), so the rollout VJPs are
assembled by hand, as `core/sharded.py` assembles the small problems':
each round's worker piece and master piece run under `torch.func.vjp`
(their VJPs kept from the forward), and the backward sums over the mesh
exactly the cotangents that crossed a per-worker use of a replicated
value (z3 in the rollout3 rounds, gamma in the rollout2 rounds, z1 in
both).  An input used per worker and by the replicated master algebra
(z1 in rollout2: f2 and the a1 columns) rides two channels, the
per-worker one summed and the replicated one counted once.  The first
backward round needs no sum but z1's: its other cotangents reach only
the rollout's initial state, a constant.  `first_order_cuts` skips the
VJPs, as the reference's stop-gradient does.  `llm_traffic` counts the
bytes each label moves.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict

import torch

from repro_torch.fed import trilevel_llm as fed
from repro_torch.fed.sharding import _as_bits, _from_bits, n_local
from repro_torch.fed.sketch import (block_amax, fixed_point,
                                    fixed_point_sums, from_fixed_point,
                                    shared_scale, sketch_rows,
                                    unsketch_rows)
from repro_torch.fed.trilevel_llm import FedHyper, FedLLMState, N_PHI
from repro_torch.utils import tree as tree_lib
from repro_torch.utils.tree import (tree_add, tree_dot, tree_leaves,
                                    tree_map, tree_norm_sq, tree_sub,
                                    tree_zeros_like, weak)


@dataclasses.dataclass
class Shard:
    """One rank's view of the mesh: `mesh` (a `launch.mesh.WorkerMesh`)
    over the federation's `n_workers` workers, of which this rank holds
    the `n_local` from `start` on."""
    mesh: Any
    n_workers: int

    def __post_init__(self):
        if not self.mesh.member:
            raise ValueError("this process is not a shard of the mesh")
        n_local(self.n_workers, self.mesh.size)

    @property
    def n_local(self) -> int:
        return self.n_workers // self.mesh.size

    @property
    def start(self) -> int:
        return self.mesh.rank * self.n_local

    def reduce(self, label: str, tree):
        """`tree` summed over the mesh, its bytes charged to `label`."""
        return self.mesh.all_reduce(**{label: tree})[label]

    def gather(self, x: torch.Tensor, label: str):
        """Every shard's `x`, concatenated in shard order along dim 0."""
        parts = self.mesh.all_gather(_as_bits(x), label=label)
        return torch.cat([_from_bits(p, x) for p in parts])


def _sum_with_sketch(shard: Shard, label: str, parts, block, seed: int,
                     r: int):
    """(`parts` summed over the mesh, the sketch of the worker-stacked
    tree whose rows the shards' `block`s are), in one all-reduce.  On
    the card the shards first agree on the fixed point's scale (an
    all-gather of each block's largest magnitude) and sum integers: the
    sum is the whole's sketch bit for bit."""
    dev = tree_leaves(block)[0].device
    if not fixed_point(dev):
        return shard.reduce(label, (parts, sketch_rows(
            block, seed, r, start=shard.start)))
    amax = shard.gather(block_amax(block), label)
    n = shard.mesh.size * sum(x.numel() for x in tree_leaves(block))
    scale, finite = shared_scale(amax, n)
    finite = finite.all().reshape(1)
    acc = fixed_point_sums(block, seed, r, shard.start, scale, finite)
    parts, acc = shard.reduce(label, (parts, acc))
    return parts, from_fixed_point(acc, scale, finite)


# ---------------------------------------------------------------------------
# cut algebra on a shard
# ---------------------------------------------------------------------------

def _a2_rows(start: int, n_local: int, a2):
    """The shard's workers' columns of an exact-mode a2 block (P, N, ...)
    (replicated in the reference's layout)."""
    return tree_map(lambda a: a.narrow(1, start, n_local), a2)


def _contract_a2_rows(shard: Shard, hyper: FedHyper, cuts, weights_p,
                      z2, seed: int):
    """The shard's rows of `trilevel_llm._contract_a(..., "a2", z2)`."""
    w = weights_p * cuts.active
    if hyper.cut_mode == "sketch":
        return unsketch_rows(z2, torch.einsum("p,pr->r", w, cuts.a2),
                                seed, start=shard.start)
    return tree_map(
        lambda aa: torch.tensordot(w, aa.float(),
                                   dims=([0], [0])).to(aa.dtype),
        _a2_rows(shard.start, shard.n_local, cuts.a2))


def _worker_cut_part(start: int, hyper: FedHyper, cuts, z2, X2, X3,
                     seed: int, with_a2: bool):
    """(P,) f32: the shard's part of the cut values, b2 . X2 + b3 . X3
    over its workers, plus a2 . z2 over its rows if `with_a2`."""
    if hyper.cut_mode == "sketch":
        r = hyper.sketch_r
        part = torch.einsum("pnr,nr->p", cuts.b2,
                            sketch_rows(X2, seed, r, batch_dims=1)) \
            + torch.einsum("pnr,nr->p", cuts.b3,
                           sketch_rows(X3, seed, r, batch_dims=1))
        if with_a2:
            part = cuts.a2 @ sketch_rows(z2, seed, r, start=start) + part
        return part
    part = fed._dot_stacked_pn(cuts.b2, X2) + fed._dot_stacked_pn(cuts.b3, X3)
    if with_a2:
        part = fed._dot_stacked_p(
            _a2_rows(start, X2.shape[0], cuts.a2), z2) + part
    return part


def _cut_values(hyper: FedHyper, cuts, z1, z3, part, s_z2, seed: int):
    """`trilevel_llm.eval_llm_cuts` from the summed worker `part` and, in
    sketch mode, z2's summed sketch `s_z2` (None when `part` holds the
    a2 term)."""
    val = torch.einsum("pd,d->p", cuts.a1, z1)
    if hyper.cut_mode == "sketch":
        if s_z2 is not None:
            val = val + cuts.a2 @ s_z2
        val = val + cuts.a3 @ sketch_rows(z3, seed, hyper.sketch_r) \
            + part
    else:
        val = val + fed._dot_stacked_p(cuts.a3, z3) + part
    return (val - cuts.c) * cuts.active


# ---------------------------------------------------------------------------
# the step (Eqs. 16-21)
# ---------------------------------------------------------------------------

def afto_llm_step_sharded(shard: Shard, cfg, hyper: FedHyper,
                          state: FedLLMState, batch: Dict[str, Any],
                          active: torch.Tensor) -> FedLLMState:
    """`trilevel_llm.afto_llm_step` on a shard: `state` is its block
    (`fed.sharding.shard_fed_state`), `batch` and `active` its workers'
    rows.  One sum over the mesh ("step")."""
    seed = hyper.seed_ii
    X1, X2, X3 = fed._step_workers(cfg, hyper, state, batch, active)
    z2 = fed._z_step(hyper, state.z2, _contract_a2_rows(
        shard, hyper, state.cuts, state.lam, state.z2, seed))
    z3 = fed._z_step(hyper, state.z3, fed._contract_a(
        hyper, state.cuts, state.lam, "a3", state.z3, seed))
    sketched = hyper.cut_mode == "sketch"
    part = _worker_cut_part(shard.start, hyper, state.cuts, z2, X2, X3,
                            seed, with_a2=not sketched)
    parts = (torch.sum(state.theta, dim=0), part)
    if sketched:
        parts, s_z2 = _sum_with_sketch(shard, "step", parts, z2, seed,
                                       hyper.sketch_r)
    else:
        parts, s_z2 = shard.reduce("step", parts), None
    theta_sum, part = parts
    gz1 = -theta_sum + torch.einsum("p,pd->d",
                                    state.lam * state.cuts.active,
                                    state.cuts.a1)
    z1 = state.z1 - hyper.eta_z * gz1
    cutval = _cut_values(hyper, state.cuts, z1, z3, part, s_z2, seed)
    return fed._step_duals(hyper, state, active, cutval, X1, X2, X3, z1,
                           z2, z3)


# ---------------------------------------------------------------------------
# level-3 rollout (Eqs. 5-7): forward, and its VJP assembled by hand
# ---------------------------------------------------------------------------
#
# One round, duals f32 (st: X3 local, z3 replicated, duals local):
#   s    = sum over the mesh of sum_local (dual + kappa3 (x - z3))
#   z3'  = z3 + eta_z s                              [master, replicated]
#   X3'  = X3 - eta_x grad_w(f3 + <dual, w - z3> + kappa3/2 |w - z3|^2)
#   dual'= dual + eta_dual (X3' - z3')               [worker, local]

def _r3_stats(hyper: FedHyper, X3, duals, z3):
    """The shard's part of sum_j (dual_j + kappa3 (x_j - z3)), f32."""
    return tree_map(lambda d, x, z: torch.sum(
        d + hyper.kappa3 * (x.float() - z.float()[None]), dim=0),
        duals, X3, z3)


def _r3_master(hyper: FedHyper, z3, s):
    # the reference's gz = -sum_j(...), then z3 - eta_z gz
    return fed._z_step(hyper, z3, tree_map(torch.neg, s))


def _r3_worker(cfg, hyper: FedHyper, batch, X3, duals, z3_old, z3_new, z1,
               Z2):
    def local(w_, p_j, d_j, dual_j):
        cons = tree_dot(dual_j, tree_sub(w_, z3_old)) \
            + 0.5 * hyper.kappa3 * tree_norm_sq(tree_sub(w_, z3_old))
        return fed.f3_loss(cfg, z1, p_j, w_, d_j, hyper) + cons

    g = fed._stacked_grad(local, X3, Z2, batch, duals)
    X3_new = tree_map(
        lambda x, gg: x - weak(hyper.eta_x, x) * gg.to(x.dtype), X3, g)
    duals = tree_map(
        lambda d, x, z: d + hyper.eta_dual_inner
        * (x.float() - z.float()[None]), duals, X3_new, z3_new)
    return X3_new, duals


def _rollout3(shard: Shard, cfg, hyper: FedHyper, z1, Z2, X3, z3, batch,
              keep: bool):
    """K sharded rounds: (X3_K, z3_K, rounds), `rounds` each round's
    inputs and its pieces' VJPs when `keep` (for `_rollout3_vjp`)."""
    duals = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                           device=x.device), X3)
    rounds = []
    for _ in range(hyper.k_inner):
        s = shard.reduce("refresh", _r3_stats(hyper, X3, duals, z3))
        worker = partial(_r3_worker, cfg, hyper, batch)
        if keep:
            z3_new, m_vjp = torch.func.vjp(partial(_r3_master, hyper), z3, s)
            (X3_new, duals_new), w_vjp = torch.func.vjp(
                worker, X3, duals, z3, z3_new, z1, Z2)
            rounds.append((X3, duals, z3, m_vjp, w_vjp))
        else:
            z3_new = _r3_master(hyper, z3, s)
            X3_new, duals_new = worker(X3, duals, z3, z3_new, z1, Z2)
        X3, z3, duals = X3_new, z3_new, duals_new
    return X3, z3, rounds


def _sum_f32(shard: Shard, tree):
    """A replicated value's per-worker cotangents summed over the mesh in
    f32, back in their dtype."""
    total = shard.reduce("refresh", tree_map(lambda x: x.float(), tree))
    return tree_map(lambda s, x: s.to(x.dtype), total, tree)


def _rollout3_vjp(shard: Shard, hyper: FedHyper, rounds, ct_X3, ct_z3, z1,
                  Z2):
    """d(rollout3)/d(z1, Z2) against the cotangents of (X3_K, z3_K): z1
    summed over the mesh, Z2 the shard's rows."""
    ct_duals = tree_zeros_like(rounds[-1][1])
    acc_z1, acc_Z2 = torch.zeros_like(z1), tree_zeros_like(Z2)
    for i in range(len(rounds) - 1, -1, -1):
        X3, duals, z3_old, m_vjp, w_vjp = rounds[i]
        cX3_w, cd_w, cz3o_w, cz3n_w, c_z1, c_Z2 = w_vjp((ct_X3, ct_duals))
        acc_z1, acc_Z2 = acc_z1 + c_z1, tree_add(acc_Z2, c_Z2)
        if i == 0:
            break       # the rest reaches only the initial state
        ct_z3n = tree_add(ct_z3, _sum_f32(shard, cz3n_w))
        cz3o_m, ct_s = m_vjp(ct_z3n)
        # every shard's stats part feeds the summed s: each takes its
        # cotangent whole
        _, s_vjp = torch.func.vjp(partial(_r3_stats, hyper), X3, duals,
                                  z3_old)
        cX3_s, cd_s, cz3o_s = s_vjp(ct_s)
        ct_z3 = tree_add(cz3o_m, _sum_f32(shard, tree_add(cz3o_w, cz3o_s)))
        ct_X3, ct_duals = tree_add(cX3_w, cX3_s), tree_add(cd_w, cd_s)
    return shard.reduce("refresh", acc_z1), acc_Z2


# ---------------------------------------------------------------------------
# level-2 rollout (the inner ADMM under the I-polytope)
# ---------------------------------------------------------------------------

def _r2_worker(cfg, hyper: FedHyper, batch, start: int, cuts_i, X2, Z2,
               gamma, z1, X3):
    """One round's worker half: the ascent step on the shard's x2
    blocks, its z2 rows, and its part of the I-cut values at them."""
    seed = hyper.seed_i

    def local(p_, w_j, d_j, z2_j):
        cons = 0.5 * hyper.kappa3 * torch.sum(
            torch.square((p_ - z2_j).float()))
        return fed.f2_loss(cfg, z1, p_, w_j, d_j, hyper) + cons

    g = fed._stacked_grad(local, X2, X3, batch, Z2)
    g_cut = fed._contract_b(hyper, cuts_i, gamma[None].expand(
        (X2.shape[0],) + tuple(gamma.shape)), "b2", X2[0], seed)
    X2_new = X2 - weak(hyper.eta_x, X2) * (g + g_cut).to(X2.dtype)
    Z2_new = Z2 - weak(hyper.eta_z * hyper.kappa3, Z2) * (Z2 - X2)
    part = _worker_cut_part(start, hyper, cuts_i, Z2_new, X2_new, X3, seed,
                            with_a2=True)
    return X2_new, Z2_new, part


def _r2_master(hyper: FedHyper, cuts_i, s, gamma, part, z1, z3):
    """One round's replicated half: the slack and multiplier updates at
    the summed cut values."""
    cutval = _cut_values(hyper, cuts_i, z1, z3, part, None, hyper.seed_i)
    s = torch.clamp(s - hyper.eta_x * (gamma + cutval + s), min=0.0) \
        * cuts_i.active
    gamma = torch.clamp(gamma + hyper.eta_dual_inner * (cutval + s),
                        min=0.0) * cuts_i.active
    return s, gamma


def _rollout2(shard: Shard, cfg, hyper: FedHyper, z1, z3, X2, Z2, X3,
              batch, cuts_i, keep: bool):
    """K sharded rounds: (X2_K, Z2_K, gamma_K, rounds)."""
    gamma = torch.zeros_like(cuts_i.c)
    s = torch.zeros_like(cuts_i.c)
    worker = partial(_r2_worker, cfg, hyper, batch, shard.start, cuts_i)
    master = partial(_r2_master, hyper, cuts_i)
    rounds = []
    for _ in range(hyper.k_inner):
        if keep:
            (X2_new, Z2_new, part), w_vjp = torch.func.vjp(
                worker, X2, Z2, gamma, z1, X3)
        else:
            X2_new, Z2_new, part = worker(X2, Z2, gamma, z1, X3)
        part = shard.reduce("refresh", part)
        if keep:
            (s, gamma), m_vjp = torch.func.vjp(master, s, gamma, part, z1,
                                               z3)
            rounds.append((w_vjp, m_vjp))
        else:
            s, gamma = master(s, gamma, part, z1, z3)
        X2, Z2 = X2_new, Z2_new
    return X2, Z2, gamma, rounds


def _rollout2_vjp(shard: Shard, rounds, ct_X2, ct_Z2, z1, z3, X3, c):
    """d(rollout2)/d(z1, z3, X3) against the cotangents of (X2_K, Z2_K)
    (gamma_K is an aux output; `c` a (P,) leaf of the polytope): z1 on
    two channels, z3 replicated, X3 the shard's workers."""
    ct_s = ct_gamma = torch.zeros_like(c)
    acc_z1_rep, acc_z1_w = torch.zeros_like(z1), torch.zeros_like(z1)
    acc_z3, acc_X3 = tree_zeros_like(z3), tree_zeros_like(X3)
    for i in range(len(rounds) - 1, -1, -1):
        w_vjp, m_vjp = rounds[i]
        c_s, cg_m, c_part, cz1_m, cz3_m = m_vjp((ct_s, ct_gamma))
        # the summed part's cotangent is every shard's part's, whole
        cX2, cZ2, cg_w, cz1_w, cX3_w = w_vjp((ct_X2, ct_Z2, c_part))
        acc_z1_rep, acc_z1_w = acc_z1_rep + cz1_m, acc_z1_w + cz1_w
        acc_z3, acc_X3 = tree_add(acc_z3, cz3_m), tree_add(acc_X3, cX3_w)
        if i == 0:
            break       # the rest reaches only the initial state
        ct_gamma = cg_m + shard.reduce("refresh", cg_w)
        ct_s, ct_X2, ct_Z2 = c_s, cX2, cZ2
    return acc_z1_rep + shard.reduce("refresh", acc_z1_w), acc_z3, acc_X3


# ---------------------------------------------------------------------------
# the cut refresh (Eqs. 23-25)
# ---------------------------------------------------------------------------

_WORKER_BLOCKS = ("a2", "b2", "b3")


def _add_cut_sharded(shard: Shard, hyper: FedHyper, cuts, grads, point,
                     h_local, h_rep, eps, mu, bound, t, seed: int):
    """`trilevel_llm._add_llm_cut` on a shard: h0's and the cut
    constant's worker terms (the a2, b2 and b3 blocks, whose rows the
    shards hold) summed over the mesh, with the a2 row summed as a
    sketch or gathered whole."""
    dev = cuts.c.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    gv_rep = sq_rep = gv_loc = sq_loc = zero
    for k in grads:
        gv = tree_dot(grads[k], point[k])
        sq = tree_norm_sq(point[k])
        if k in _WORKER_BLOCKS:
            gv_loc, sq_loc = gv_loc + gv, sq_loc + sq
        else:
            gv_rep, sq_rep = gv_rep + gv, sq_rep + sq
    parts = torch.stack([h_local, gv_loc, sq_loc])
    if hyper.cut_mode == "sketch":
        sums, a2 = _sum_with_sketch(shard, "refresh", parts, grads["a2"],
                                    seed, hyper.sketch_r)
    else:
        sums = shard.reduce("refresh", parts)
        a2 = tree_map(lambda g: shard.gather(g, "refresh"), grads["a2"])
    h0 = sums[0] + h_rep
    c = eps + mu * (bound + sq_rep + sums[2]) - h0 + (gv_rep + sums[1])
    return fed._write_cut(hyper, cuts, dict(grads, a2=a2), fed._cut_slot(
        cuts), c, t, seed, sketched=("a2",) if hyper.cut_mode == "sketch"
        else ())


def _sq_dist(a, b):
    return tree_norm_sq(tree_sub(a, b))


def _sq_dist32(a, b):
    return torch.sum(torch.square((a - b).float()))


def cut_refresh_llm_sharded(shard: Shard, cfg, hyper: FedHyper,
                            state: FedLLMState, batch) -> FedLLMState:
    """`trilevel_llm.cut_refresh_llm` on a shard (`state` its block,
    `batch` its workers' rows); every sum over the mesh is "refresh".
    h_I / h_II's gradients w.r.t. the shard's own worker variables and
    z2 rows are local; the replicated blocks come from the hand-assembled
    rollout VJPs."""
    t, n = state.t, hyper.n_workers
    keep = not hyper.first_order_cuts

    # ---- I-layer cut (Eq. 23): h_I = ||[X3; z3] - rollout3(z1, Z2)||^2
    X3_k, z3_k, rounds = _rollout3(shard, cfg, hyper, state.z1, state.z2,
                                   state.X3, state.z3, batch, keep)
    hx, (gX3, ct_X3) = tree_lib.value_and_grad(_sq_dist, state.X3, X3_k)
    hz, (gz3, ct_z3) = tree_lib.value_and_grad(_sq_dist, state.z3, z3_k)
    if keep:
        gz1, gZ2 = _rollout3_vjp(shard, hyper, rounds, ct_X3, ct_z3,
                                 state.z1, state.z2)
    else:
        gz1, gZ2 = torch.zeros_like(state.z1), torch.zeros_like(state.z2)
    del rounds, X3_k, z3_k
    cuts_i = _add_cut_sharded(
        shard, hyper, state.cuts_i,
        {"a1": gz1, "a2": gZ2, "a3": gz3, "b3": gX3},
        {"a1": state.z1, "a2": state.z2, "a3": state.z3, "b3": state.X3},
        hx, hz, hyper.eps_i, hyper.mu_i, (n + 3) * hyper.alpha, t,
        hyper.seed_i)

    # ---- II-layer cut (Eq. 24): h_II = ||[X2; Z2] - rollout2(...)||^2
    X2_k, Z2_k, gamma_k, rounds = _rollout2(
        shard, cfg, hyper, state.z1, state.z3, state.X2, state.z2,
        state.X3, batch, cuts_i, keep)
    hx, (gX2, ct_X2) = tree_lib.value_and_grad(_sq_dist32, state.X2, X2_k)
    hz, (gZ2, ct_Z2) = tree_lib.value_and_grad(_sq_dist32, state.z2, Z2_k)
    if keep:
        gz1b, gz3b, gX3b = _rollout2_vjp(shard, rounds, ct_X2, ct_Z2,
                                         state.z1, state.z3, state.X3,
                                         cuts_i.c)
    else:
        gz1b, gz3b, gX3b = (torch.zeros_like(state.z1),
                            tree_zeros_like(state.z3),
                            tree_zeros_like(state.X3))
    del rounds, X2_k, Z2_k
    cuts_ii = _add_cut_sharded(
        shard, hyper, state.cuts,
        {"a1": gz1b, "a2": gZ2, "a3": gz3b, "b2": gX2, "b3": gX3b},
        {"a1": state.z1, "a2": state.z2, "a3": state.z3, "b2": state.X2,
         "b3": state.X3},
        hx + hz, torch.zeros_like(hx), hyper.eps_ii, hyper.mu_ii,
        (2 * n + 2) * hyper.alpha, t, hyper.seed_ii)
    return fed._drop_inactive(state, cuts_i, cuts_ii, gamma_k)


# ---------------------------------------------------------------------------
# communication accounting
# ---------------------------------------------------------------------------

def llm_traffic(cfg, hyper: FedHyper, n_shards: int, b_local: int,
                seq: int, device="cpu", x2_dtype=torch.bfloat16
                ) -> Dict[str, Any]:
    """The bytes each shard moves per step ("step") and per refresh
    ("refresh") on an `n_shards` mesh for a model of `cfg`, per-worker
    batches of (b_local, seq) tokens on `device`, the perturbation X2 /
    z2 in `x2_dtype` (bf16 in `init_fed_state`): an exact count of the
    sums above, by term.  Worker rows, b-blocks and data stay local.

    step     theta sum (N_PHI) + the cut values' worker part (P), f32;
             sketch mode adds z2's sketch: r f32 on the CPU, r int64
             plus each shard's scale (8 bytes an all-gathered shard) on
             the card
    refresh  rollout3: K z3-sized f32 sums forward, 2 (K - 1) back and
             z1's (N_PHI); rollout2: K (P,) sums forward, K - 1 back and
             z1's; each cut: 3 scalars and its a2 row (as the step's
             sketch, or in exact mode z2 gathered whole); no backward
             sums with `first_order_cuts`."""
    from repro_torch.models import transformer as tfm

    params = tfm.init_params(cfg, torch.Generator(), device="meta")
    z3 = sum(x.numel() for x in tree_leaves(params))
    n_loc = n_local(hyper.n_workers, n_shards)
    p, k, r = hyper.p_max, hyper.k_inner, hyper.sketch_r
    z2_elem = torch.empty((), dtype=x2_dtype).element_size()
    if hyper.cut_mode == "sketch":
        a2_row = 4 * r if not fixed_point(device) \
            else 8 * r + 8 * n_shards
    else:
        a2_row = n_loc * n_shards * b_local * (seq - 1) * cfg.d_model \
            * z2_elem
    step = 4 * (N_PHI + p) + (a2_row if hyper.cut_mode == "sketch" else 0)
    back = not hyper.first_order_cuts
    terms = {
        "rollout3 forward": 4 * k * z3,
        "rollout3 backward": back * (4 * 2 * (k - 1) * z3 + 4 * N_PHI),
        "rollout2 forward": 4 * k * p,
        "rollout2 backward": back * (4 * (k - 1) * p + 4 * N_PHI),
        "cuts": 2 * (4 * 3 + a2_row),
    }
    return {"step_bytes": step, "refresh_bytes": sum(terms.values()),
            "refresh_terms": terms, "z3_elements": z3}
