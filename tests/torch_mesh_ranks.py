"""Rank-side cases of `test_torch_sharded.py`, run by `spawn_mesh`.

Each rank process imports this module and `repro_torch` only (no jax, no
reference package).  `run_cases(mesh, inputs, names)` runs the named
cases on the rank's shard and returns {name: result}: host values (CPU
tensors, numpy arrays, dicts), compared in the pytest process against
the reference and across ranks.  Inputs (problem data, arrival
schedules, stream batches) come from the reference as numpy.
"""
from __future__ import annotations

import dataclasses
import tempfile

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch import convert
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core import (RunSpec, Schedule, StragglerConfig, afto,
                              inner, run, run_chunked, run_scanned,
                              run_swept)
from repro_torch.core import cuts as cuts_lib
from repro_torch.core import sharded, stationarity
from repro_torch.core.types import Hyper, InnerState3, TrilevelProblem
from repro_torch.data import ShardedLoader
from repro_torch.fed import sharding as shd
from repro_torch.utils import tree as tree_lib

DEVICE = "cpu"


def quad_problem(data, device=DEVICE) -> TrilevelProblem:
    """`conftest.make_quadratic_problem`'s objectives on its data."""
    data = {k: torch.tensor(np.asarray(v), device=device)
            for k, v in data.items()}
    n, dim = data["b"].shape

    def f1(d, x1, x2, x3):
        return torch.sum((x1 - d["A"] @ x3 - d["b"]) ** 2)

    def f2(d, x1, x2, x3):
        return torch.sum((x2 + x3) ** 2) + 0.1 * torch.sum(x2 ** 2)

    def f3(d, x1, x2, x3):
        return torch.sum((x3 - x1) ** 2) + 0.1 * torch.sum((x3 - x2) ** 2)

    def zeros():
        return torch.zeros(dim, device=device)

    return TrilevelProblem(f1=f1, f2=f2, f3=f3, data=data, n_workers=n,
                           x1_init=zeros(), x2_init=zeros(), x3_init=zeros())


def hyper(**kw) -> Hyper:
    """`conftest.make_hyper`."""
    base = dict(n_workers=4, s_active=3, tau=5, k_inner=3, p_max=6,
                t_pre=5, t1=100, eta_x=0.05, eta_z=0.05, d1=3)
    base.update(kw)
    return Hyper(**base)


def schedule(arrays) -> Schedule:
    return Schedule(active=np.asarray(arrays["active"]),
                    sim_time=np.asarray(arrays["sim_time"]),
                    max_staleness=np.asarray(arrays["max_staleness"]))


def host(tree):
    """A result as CPU tensors / numpy (histories stay numpy)."""
    return pytree.tree_map(
        lambda x: x.detach().cpu() if torch.is_tensor(x) else x, tree)


def z1_norm(state):
    return {"z1_norm_sq": torch.sum(state.z1 ** 2)}


def leaves_equal(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def histories_equal(a, b, skip=("host_time",)) -> bool:
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) for k in a if k not in skip)


def _traffic(mesh, fn):
    mesh.reset_traffic()
    out = fn()
    return out, dict(mesh.traffic), dict(mesh.calls)


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def case_scan(mesh, inp):
    """The main 40-iteration scan, recorded every iteration, with the
    all-reduced bytes; then the same run again (bitwise)."""
    prob = quad_problem(inp["data"])
    sched = schedule(inp["sched40"])
    res, traffic, calls = _traffic(mesh, lambda: run_scanned(
        prob, hyper(), sched, metrics_fn=z1_norm, metrics_every=1,
        mesh=mesh))
    again = run_scanned(prob, hyper(), sched, metrics_fn=z1_norm,
                        metrics_every=1, mesh=mesh)
    return dict(state=host(res.state), history=res.history,
                traffic=traffic, calls=calls,
                repeat_equal=leaves_equal(res.state, again.state)
                and histories_equal(res.history, again.history))


def case_evict(mesh, inp):
    prob = quad_problem(inp["data"])
    res = run_scanned(prob, hyper(s_active=2, tau=4, k_inner=2, p_max=2,
                                  t_pre=2), schedule(inp["evict30"]),
                      metrics_every=1, mesh=mesh)
    return dict(state=host(res.state), history=res.history)


def case_chunks(mesh, inp):
    """Chunks of 13 with a checkpoint at every boundary, and a run resumed
    from the step-26 checkpoint, each against the unchunked run."""
    prob = quad_problem(inp["data"])
    sched = schedule(inp["sched40"])
    hy = hyper()
    full = run_scanned(prob, hy, sched, metrics_every=1, mesh=mesh)
    with tempfile.TemporaryDirectory() as tmp:
        def hook(state, t_abs):
            save_checkpoint(tmp, state, t_abs, keep=4)

        chunked = run_chunked(prob, hy, sched, 13, chunk_hook=hook,
                              metrics_every=1, mesh=mesh)
        resumed_state = load_checkpoint(tmp, afto.init_state(prob, hy),
                                        step=26)
    resumed = run_scanned(prob, hy, sched.slice(26, 40), metrics_every=1,
                          state=resumed_state, mesh=mesh)
    tail = {k: v[26:] for k, v in full.history.items()}
    resumed_hist = dict(resumed.history, t=resumed.history["t"] + 26)
    return dict(
        chunked_equal=leaves_equal(chunked.state, full.state)
        and histories_equal(chunked.history, full.history),
        resumed_equal=leaves_equal(resumed.state, full.state)
        and histories_equal(resumed_hist, tail))


def case_runspec(mesh, inp):
    """`run(RunSpec(mesh=))` on scan, chunked scan and sweep."""
    prob = quad_problem(inp["data"])
    sched = schedule(inp["sched20"])
    spec = RunSpec(problem=prob, hyper=hyper(), schedule=sched,
                   metrics_every=5, mesh=mesh, device=DEVICE)
    scan = run(spec)
    direct = run_scanned(prob, hyper(), sched, metrics_every=5, mesh=mesh)
    chunked = run(dataclasses.replace(spec, chunk_size=7))
    cfg = StragglerConfig(n_workers=4, s_active=3, tau=5, n_stragglers=1,
                          straggler_slowdown=5.0, seed=0)
    sweep = run(dataclasses.replace(spec, engine="sweep", schedule=None,
                                    n_iterations=20, scheduler=cfg,
                                    seeds=(0, 1)))
    return dict(scan_history=scan.history,
                scan_is_direct=leaves_equal(scan.state, direct.state),
                chunked_equal=leaves_equal(chunked.state, scan.state),
                sweep_gap=sweep.history["gap_sq"],
                sweep_state=host(sweep.state))


def case_sweep(mesh, inp):
    prob = quad_problem(inp["data"])
    res, traffic, _ = _traffic(mesh, lambda: run_swept(
        prob, hyper(), [schedule(s) for s in inp["sweep25"]],
        metrics_every=5, mesh=mesh))
    return dict(state=host(res.state), history=res.history, traffic=traffic)


def case_sweep_hypers(mesh, inp):
    prob = quad_problem(inp["data"])
    scheds = [schedule(s) for s in inp["sweep15"]]
    sw = run_swept(prob, hyper(), scheds, metrics_every=5, mesh=mesh,
                   sweep_hypers={"eta_z": [0.05, 0.01]})
    states = tree_lib.tree_map(
        lambda x: torch.stack([x, x]), afto.init_state(prob, hyper()))
    sw2 = run_swept(prob, hyper(), scheds, metrics_every=5, states=states,
                    mesh=mesh)
    return dict(gap=sw.history["gap_sq"], state=host(sw.state),
                gap_states=sw2.history["gap_sq"])


def case_stream(mesh, inp):
    prob = quad_problem(inp["data"])
    res = run_scanned(prob, hyper(), schedule(inp["sched20"]),
                      metrics_every=5, mesh=mesh,
                      data=convert.stream_from_reference(inp["batches"]))
    return dict(state=host(res.state), history=res.history)


def case_stream_sweep(mesh, inp):
    prob = quad_problem(inp["data"])
    res = run_swept(prob, hyper(), [schedule(s) for s in inp["sweep12"]],
                    metrics_every=4, mesh=mesh,
                    data=convert.stream_from_reference(inp["batches"]))
    return dict(state=host(res.state), history=res.history)


def case_loader(mesh, inp):
    loader = ShardedLoader(inp["arrays"], 6, seed=4, mesh=mesh)
    return [[{k: v.numpy() for k, v in b.items()} for b in loader]
            for _epoch in range(2)]


def _live_state(prob, hy, seed=0):
    """A global state with live cuts on both layers, positive level-2
    multipliers and slacks, and a violated I-cut, so every branch of the
    level-2 cut algebra carries a derivative."""
    g = torch.Generator().manual_seed(seed)
    st = afto.init_state(prob, hy)
    masks = torch.rand((6, hy.n_workers), generator=g) > 0.3
    for it in range(6):
        st = afto.afto_step(prob, hy, st, masks[it].float())
        if it == 3:
            st = afto.cut_refresh(prob, hy, st)

    def rand_coeffs(b2):
        out = {k: torch.randn(3, generator=g) for k in ("a1", "a2", "a3")}
        out["b3"] = torch.randn((hy.n_workers, 3), generator=g) * 0.5
        if b2:
            out["b2"] = torch.randn((hy.n_workers, 3), generator=g) * 0.5
        return out

    cuts_i = cuts_lib.add_cut(st.cuts_i, rand_coeffs(False), -1.0, st.t)
    cuts_ii = cuts_lib.add_cut(st.cuts_ii, rand_coeffs(True), 0.5, st.t)
    p = hy.p_max
    inner2 = dataclasses.replace(
        st.inner2, s=torch.rand(p, generator=g) * cuts_i.active,
        gamma=(torch.rand(p, generator=g) + 0.5) * cuts_i.active)
    return dataclasses.replace(
        st, cuts_i=cuts_i, cuts_ii=cuts_ii, inner2=inner2,
        lam=(torch.rand(p, generator=g) + 0.1) * cuts_ii.active)


def case_refresh(mesh, inp):
    """The hand-assembled rollout VJPs and `cut_refresh_sharded` against
    the unsharded `torch.func` derivatives and refresh."""
    prob = quad_problem(inp["data"])
    hy = hyper()
    st = _live_state(prob, hy)
    n = mesh.size
    w = mesh.rank
    local = shd.shard_state(st, w, n)
    lprob = shd.shard_problem(prob, w, n)
    loc = sharded.Local(lprob, hy, mesh)
    spec_i, spec_ii = st.cuts_i.spec, st.cuts_ii.spec

    with torch.no_grad():
        # level 3: d h_I / d(z1, z2) by hand vs torch.func
        inner3 = InnerState3(x3=st.X3, z3=st.z3, phi=st.inner3.phi)
        _, (_, _, gz1, gz2) = tree_lib.value_and_grad(
            lambda X3, z3, z1, z2: inner.h_i(prob, hy, X3, z3, z1, z2,
                                             inner3),
            st.X3, st.z3, st.z1, st.z2)
        est3, res3 = sharded.rollout3_sharded_fwd(
            loc, local.z1, local.z2, sharded._inner3(lprob, hy, local))
        _, _, ct3 = sharded._cut_i_local(lprob, hy, local, est3)
        sz1, sz2 = sharded.rollout3_sharded_vjp(loc, local.z1, local.z2,
                                                res3, ct3)

        # level 2 under the live I-polytope: d h_II / d(z1, z3, X3)
        inner2 = dataclasses.replace(st.inner2, x2=st.X2, z2=st.z2)
        _, (_, _, gz1b, gz3b, gX3b) = tree_lib.value_and_grad(
            lambda X2, z2, z1, z3, X3: inner.h_ii(
                prob, hy, X2, z2, z1, z3, X3, st.cuts_i, inner2),
            st.X2, st.z2, st.z1, st.z3, st.X3)
        linner2 = dataclasses.replace(local.inner2, x2=local.X2,
                                      z2=local.z2)
        est2, res2, b_agg = sharded.rollout2_sharded_fwd(
            loc, local.z1, local.z3, local.X3, local.cuts_i, linner2)
        _, _, ct2 = sharded._cut_ii_local(lprob, hy, local, est2)
        sz1b, sz3b, sX3b = sharded.rollout2_sharded_vjp(
            loc, local.z1, local.z3, local.X3, local.cuts_i, res2, b_agg,
            ct2)
        sX3b = torch.cat(mesh.all_gather(sX3b))

        want = afto.cut_refresh(prob, hy, st)
        got = shd.gather_state(
            sharded.cut_refresh_sharded(lprob, hy, local, mesh), mesh,
            spec_i, spec_ii)
        roundtrip = shd.unshard_state(
            [shd.shard_state(st, v, n) for v in range(n)], spec_i, spec_ii)

        # one step and the gap through the entry points' mesh= branches
        mask = torch.tensor([1.0, 0.0, 1.0, 1.0])
        n_loc = hy.n_workers // n
        want_st, want_aux = afto.afto_step_aux(prob, hy, st, mask)
        got_st, got_aux = afto.afto_step_aux(
            lprob, hy, local, mask[w * n_loc:(w + 1) * n_loc], mesh=mesh)
        step = dict(
            want=(host(want_st), want_aux["cutval"],
                  stationarity.stationarity_gap_sq(prob, hy, want_st),
                  stationarity.make_gap_aux(prob, hy, want_st)["cutval"]),
            got=(host(shd.gather_state(got_st, mesh, spec_i, spec_ii)),
                 got_aux["cutval"],
                 stationarity.stationarity_gap_sq(lprob, hy, got_st,
                                                  mesh=mesh),
                 stationarity.make_gap_aux(lprob, hy, got_st,
                                           mesh=mesh)["cutval"]),
            gap_with_aux=stationarity.stationarity_gap_sq(
                lprob, hy, got_st, aux=got_aux, mesh=mesh))
    return dict(
        step=step,
        vjp3=((gz1, gz2), (sz1, sz2)),
        vjp2=((gz1b, gz3b, gX3b), (sz1b, sz3b, sX3b)),
        refresh=(host(want), host(got)),
        gamma_live=float(st.inner2.gamma.max()),
        roundtrip_equal=leaves_equal(roundtrip, st))


def card_case(mesh, data, sched):
    """The main scan on the mesh's device (the card): the result on the
    host, its all-reduced bytes and the port's kernel launches (none: the
    sharded path contracts the cuts with plain products)."""
    from repro_torch.kernels import cut_eval

    prob = quad_problem(data, device=mesh.device)
    cut_eval.reset_launches()
    res, traffic, _ = _traffic(mesh, lambda: run_scanned(
        prob, hyper(), schedule(sched), metrics_every=5, mesh=mesh))
    return dict(state=host(res.state), history=res.history, traffic=traffic,
                launches=dict(cut_eval.LAUNCHES), device=str(mesh.device))


def failing_rank(mesh):
    """Rank 1 fails; rank 0 waits for it in a collective."""
    if mesh.rank == 1:
        raise ValueError("no such case")
    mesh.broadcast_object(None, src=1)


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def run_cases(mesh, inputs, names):
    torch.manual_seed(0)
    return {name: CASES[name](mesh, inputs) for name in names}
