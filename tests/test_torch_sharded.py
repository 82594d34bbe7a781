"""The port's worker-mesh sharded engine (`repro_torch.core.sharded`,
`fed.sharding`, `launch.mesh`, `run_scanned` / `run_chunked` /
`run_swept(mesh=)`, `RunSpec(mesh=)`, `ShardedLoader(mesh=)`) on gloo
ranks on the CPU, against the reference.

The ranks are processes started by the port's own launcher
(`launch.mesh.spawn_mesh`) and import only `repro_torch`
(`tests/torch_mesh_ranks.py` holds their cases); each spawn of 2 or 4
ranks runs many cases, and the tests below read its results.  The
reference runs here, in the pytest process, single-device and on its
8 fake CPU devices (`tests/conftest.py`), and hands its inputs over as
numpy.

Tolerances are the reference's own (tests/test_sharded_engine.py:40-56,
tests/test_stream.py:63-67, 236-310): states within rtol 5e-5 / atol
1e-6, histories within rtol 5e-4 / atol 1e-6, cut counts, `t`,
`sim_time` and `max_staleness` exact; streamed runs at rtol 1e-4 on
states and 1e-3 on `gap_sq`.  Within the port: every rank returns the
same state and history bit for bit, a repeated, chunked or resumed run
is bitwise the sharded run, and the bytes all-reduced per step, refresh
and recorded gap equal `traffic_record` exactly.  The hand-assembled
rollout VJPs and refresh are held to the port's unsharded `torch.func`
ones at the rollout-state tolerance (rtol 1e-5 / atol 1e-6).
"""
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from conftest import (make_hyper, make_quadratic_problem, make_schedules,
                      make_straggler_cfg)
from repro.core import afto as jax_afto
from repro.core import run_scanned as jax_run_scanned
from repro.core import run_swept as jax_run_swept
from repro.core import sharded as jax_sharded
from repro.core.scheduler import StragglerScheduler as JaxScheduler
from repro.data import loader as jax_loader
from repro.data import stream as jax_stream
from repro.launch.mesh import make_worker_mesh as jax_worker_mesh
from repro_torch.core import RunSpec, afto, run, run_scanned
from repro_torch.core import sharded
from repro_torch.core.scheduler import Schedule
from repro_torch.data import ShardedLoader
from repro_torch.fed import sharding as shd
from repro_torch.fed.runtime.membership import make_views
from repro_torch.launch import mesh as mesh_lib
from test_torch_core import assert_trees_close, port_hyper, quad_problems

STATE = dict(rtol=5e-5, atol=1e-6)
HIST = dict(rtol=5e-4, atol=1e-6)
STREAM = dict(rtol=1e-4, atol=1e-6)
ROLLOUT = dict(rtol=1e-5, atol=1e-6)
TESTS = Path(__file__).resolve().parent
SPAWN_TIMEOUT = 240.0

# the cases each mesh width runs in one spawn
CASES = {2: ("scan", "evict", "chunks", "runspec", "sweep", "sweep_hypers",
             "stream", "stream_sweep", "loader", "refresh"),
         4: ("scan", "evict", "chunks", "runspec", "sweep", "stream")}
DIM = 3


def _arrays(s):
    return {"active": np.asarray(s.active),
            "sim_time": np.asarray(s.sim_time),
            "max_staleness": np.asarray(s.max_staleness)}


def _jax_sample(key):
    ka, kb = jax.random.split(key)
    return {"A": jax.random.normal(ka, (DIM, DIM)) * 0.3,
            "b": jax.random.normal(kb, (DIM,))}


def _jax_stream():
    return jax_stream.make_stream(_jax_sample, 4, 0)


def _loader_arrays():
    rng = np.random.default_rng(0)
    return {"x": rng.normal(size=(23, 3)).astype(np.float32),
            "y": np.arange(23, dtype=np.int64)}


def _inputs():
    """Everything the ranks get, from the reference as numpy."""
    jp = make_quadratic_problem()
    sched40 = JaxScheduler(make_straggler_cfg()).precompute(40)
    evict30 = JaxScheduler(make_straggler_cfg(
        s_active=2, tau=4, n_stragglers=2, straggler_slowdown=10.0,
        seed=3)).precompute(30)
    js = _jax_stream()
    return {
        "data": {k: np.asarray(v) for k, v in jp.data.items()},
        "sched40": _arrays(sched40), "sched20": _arrays(sched40.slice(0, 20)),
        "evict30": _arrays(evict30),
        "sweep25": [_arrays(s) for s in make_schedules(25, (0, 1, 2))],
        "sweep15": [_arrays(s) for s in make_schedules(15, (0, 0))],
        "sweep12": [_arrays(s) for s in make_schedules(12, (0, 1))],
        "batches": [jax.tree.map(np.asarray, jax_stream.next_batch(js, it))
                    for it in range(25)],
        "arrays": _loader_arrays(),
    }


_RANKS = {}


def ranks(w):
    """Every rank's results of the width-w spawn.  The first call starts
    the spawns of both widths side by side; each runs once per module."""
    if not _RANKS:
        inputs = _inputs()
        pool = ThreadPoolExecutor(len(CASES))
        for width, names in CASES.items():
            _RANKS[width] = pool.submit(
                mesh_lib.spawn_mesh, "torch_mesh_ranks:run_cases", width,
                device="cpu", args=(inputs, names),
                pythonpath=[str(TESTS)], timeout=SPAWN_TIMEOUT)
        pool.shutdown(wait=False)
    return _RANKS[w].result(timeout=2 * SPAWN_TIMEOUT)


# one reference problem and metric, so its compiled trajectories are
# shared by the tests (the reference caches them per problem object)
_JP = make_quadratic_problem()


def _z1_norm(state):
    return {"z1_norm_sq": jax.numpy.sum(state.z1 ** 2)}


def _assert_history(got, want, keys=("gap_sq",), tol=HIST):
    assert list(got["t"]) == list(np.asarray(want["t"]))
    for k in keys:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), **tol)
    for k in ("n_cuts_i", "n_cuts_ii", "sim_time", "max_staleness"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def _leaves_equal(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _fake_mesh(size=2, axis="worker", rank=0):
    """A mesh handle that no collective is reached with (validation)."""
    return mesh_lib.WorkerMesh(group=None, rank=rank, size=size,
                               axis_name=axis, device=torch.device("cpu"))


# ---------------------------------------------------------------------------
# scans against the reference, through refresh / eviction / stragglers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", (2, 4))
def test_sharded_scan_matches_reference(w):
    """Recorded every iteration: a per-step check of the gap, the cut
    counts and a master metric through refreshes and straggler masks,
    against the reference's single-device scan and its `mesh=` scan."""
    got = ranks(w)[0]["scan"]
    sched = JaxScheduler(make_straggler_cfg()).precompute(40)
    for kw in ({}, {"mesh": jax_worker_mesh(w)}):
        want = jax_run_scanned(_JP, make_hyper(), sched, metrics_fn=_z1_norm,
                               metrics_every=1, **kw)
        assert_trees_close(got["state"], want.state, **STATE)
        _assert_history(got["history"], want.history)
        np.testing.assert_allclose(got["history"]["z1_norm_sq"],
                                   np.asarray(want.history["z1_norm_sq"]),
                                   rtol=5e-5, atol=1e-7)


@pytest.mark.parametrize("w", (2, 4))
def test_sharded_scan_through_eviction(w):
    """p_max=2 and a refresh every 2 iterations force slot evictions and
    Eq. 25 drops while heavy stragglers mask most workers."""
    got = ranks(w)[0]["evict"]
    hyper = make_hyper(s_active=2, tau=4, k_inner=2, p_max=2, t_pre=2)
    sched = JaxScheduler(make_straggler_cfg(
        s_active=2, tau=4, n_stragglers=2, straggler_slowdown=10.0,
        seed=3)).precompute(30)
    want = jax_run_scanned(_JP, hyper, sched, metrics_every=1)
    assert_trees_close(got["state"], want.state, **STATE)
    _assert_history(got["history"], want.history)
    assert int(got["state"].cuts_ii.age.max()) >= 2 * hyper.p_max


@pytest.mark.parametrize("w", (2, 4))
def test_shards_return_the_same_result_bitwise(w):
    """Every rank returns the same global state and history, bit for bit
    (the replicated leaves were equal on every shard: `gather_state`
    raises otherwise), and a repeated run is its first run."""
    out = ranks(w)
    for case in ("scan", "evict"):
        for r in out[1:]:
            assert _leaves_equal(r[case]["state"], out[0][case]["state"])
            for k, v in out[0][case]["history"].items():
                if k != "host_time":
                    np.testing.assert_array_equal(r[case]["history"][k], v)
    assert all(r["scan"]["repeat_equal"] for r in out)


@pytest.mark.parametrize("w", (2, 4))
def test_all_reduced_bytes_equal_traffic_record(w):
    """The bytes each rank all-reduced in the 40-iteration scan (40 steps,
    8 refreshes, 40 recorded gaps, 8 of them after a refresh) and in the
    sweep of 3 (25 steps, 5 refreshes, 5 records) equal the record."""
    spec = afto.init_state(quad_problems()[1], port_hyper()).cuts_ii.spec
    rec = sharded.traffic_record(spec, port_hyper())
    jspec = jax.eval_shape(lambda: jax_afto.init_state(
        make_quadratic_problem(), make_hyper())).cuts_ii.spec
    want = jax_sharded.traffic_record(jspec, make_hyper())
    for k in ("step_bytes", "refresh_bytes", "gap_bytes"):
        assert rec[k] == want[k]
    for r in ranks(w):
        t = r["scan"]["traffic"]
        assert t["step"] == 40 * rec["step_bytes"]
        assert t["refresh"] == 8 * rec["refresh_bytes"]
        assert t["gap"] == 40 * rec["gap_bytes"]
        assert t["gap_aux"] == 8 * rec["gap_aux_bytes"]
        # one collective a step and a record; 6 K + 5 a refresh
        assert r["scan"]["calls"]["step"] == 40
        assert r["scan"]["calls"]["refresh"] == 8 * (6 * 3 + 5)
        t = r["sweep"]["traffic"]
        assert t["step"] == 3 * 25 * rec["step_bytes"]
        assert t["refresh"] == 3 * 5 * rec["refresh_bytes"]
        assert t["gap"] == 3 * 5 * rec["gap_bytes"]
        assert t["gap_aux"] == 3 * 5 * rec["gap_aux_bytes"]


@pytest.mark.parametrize("w", (2, 4))
def test_chunked_and_resumed_sharded_runs_are_bitwise(w):
    """Chunks of 13 (a checkpoint written at every boundary from the
    assembled global state) and a run resumed from the step-26
    checkpoint equal the unchunked sharded run bit for bit."""
    for r in ranks(w):
        assert r["chunks"]["chunked_equal"]
        assert r["chunks"]["resumed_equal"]


# ---------------------------------------------------------------------------
# RunSpec, sweeps, streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", (2, 4))
def test_runspec_mesh_routes_scan_chunks_and_sweep(w):
    got = ranks(w)[0]["runspec"]
    assert got["scan_is_direct"] and got["chunked_equal"]
    sched = JaxScheduler(make_straggler_cfg()).precompute(20)
    want = jax_run_scanned(_JP, make_hyper(), sched, metrics_every=5,
                           mesh=jax_worker_mesh(w))
    _assert_history(got["scan_history"], want.history)
    sw = jax_run_swept(_JP, make_hyper(), make_schedules(20, (0, 1)),
                       metrics_every=5)
    np.testing.assert_allclose(got["sweep_gap"], np.asarray(
        sw.history["gap_sq"]), **HIST)
    assert_trees_close(got["sweep_state"], sw.state, **STATE)


@pytest.mark.parametrize("engine", ["eager", "async"])
def test_runspec_mesh_refused_for_eager_and_async(engine):
    _, tp = quad_problems()
    with pytest.raises(ValueError, match="mesh"):
        run(RunSpec(problem=tp, hyper=port_hyper(), engine=engine,
                    n_iterations=2, mesh=_fake_mesh(), device="cpu"))


@pytest.mark.parametrize("w", (2, 4))
def test_sharded_sweep_matches_reference(w):
    got = ranks(w)[0]["sweep"]
    want = jax_run_swept(_JP, make_hyper(), make_schedules(25, (0, 1, 2)),
                         metrics_every=5)
    assert_trees_close(got["state"], want.state, **STATE)
    np.testing.assert_allclose(got["history"]["gap_sq"],
                               np.asarray(want.history["gap_sq"]), **HIST)
    np.testing.assert_array_equal(got["history"]["n_cuts_ii"],
                                  np.asarray(want.history["n_cuts_ii"]))


def test_sharded_sweep_hypers_and_states():
    """Per-run hyper scalars and caller-stacked states ride the sharded
    sweep; each row matches the reference's scan of that row."""
    got = ranks(2)[0]["sweep_hypers"]
    scheds = make_schedules(15, (0, 0))
    for r, eta_z in enumerate((0.05, 0.01)):
        want = jax_run_scanned(_JP, make_hyper(eta_z=eta_z), scheds[r],
                               metrics_every=5)
        np.testing.assert_allclose(got["gap"][r],
                                   np.asarray(want.history["gap_sq"]),
                                   **HIST)
        assert_trees_close(pytree.tree_map(lambda x: x[r], got["state"]),
                           want.state, **STATE)
    np.testing.assert_allclose(got["gap_states"][0], got["gap"][0], **HIST)


@pytest.mark.parametrize("w", (2, 4))
def test_streamed_sharded_scan_matches_reference(w):
    """Each shard draws its own global rows of the reference's batches
    (at offset rank * n_local, keyed by each row's consumption time)."""
    got = ranks(w)[0]["stream"]
    sched = JaxScheduler(make_straggler_cfg()).precompute(20)
    want = jax_run_scanned(_JP, make_hyper(), sched, metrics_every=5,
                           data=_jax_stream())
    assert_trees_close(got["state"], want.state, **STREAM)
    _assert_history(got["history"], want.history,
                    tol=dict(rtol=1e-3, atol=1e-6))


def test_streamed_sharded_sweep_matches_reference():
    """Against the reference's streamed sweep, to which its streamed
    sharded sweep is held (tests/test_stream.py:289-310)."""
    got = ranks(2)[0]["stream_sweep"]
    want = jax_run_swept(_JP, make_hyper(), make_schedules(12, (0, 1)),
                         metrics_every=4, data=_jax_stream())
    assert_trees_close(got["state"], want.state, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got["history"]["gap_sq"],
                               np.asarray(want.history["gap_sq"]),
                               rtol=1e-3, atol=1e-6)


# ---------------------------------------------------------------------------
# the hand-assembled derivatives
# ---------------------------------------------------------------------------

def _assert_close(got, want, tol):
    for g, x in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), x.numpy(), **tol)


def test_hand_assembled_rollout_vjps_match_torch_func():
    """d h_I / d(z1, z2) and d h_II / d(z1, z3, X3) through the sharded
    rollouts on 2 ranks (a violated I-cut and positive multipliers, so
    the level-2 cut algebra carries a derivative) against `torch.func`
    through the unsharded rollouts."""
    for r in ranks(2):
        res = r["refresh"]
        assert res["gamma_live"] > 0
        want, got = res["vjp3"]
        _assert_close(got, want, ROLLOUT)
        want, got = res["vjp2"]
        _assert_close(got, want, ROLLOUT)


def test_sharded_refresh_matches_unsharded_refresh():
    """`cut_refresh_sharded` on 2 ranks, gathered, against the port's
    unsharded refresh: cut coefficients, `c`, `gamma_k`, the drop masks
    and the inner states."""
    for r in ranks(2):
        want, got = r["refresh"]["refresh"]
        for name in ("cuts_i", "cuts_ii"):
            _assert_close(getattr(got, name).a, getattr(want, name).a,
                          ROLLOUT)
            _assert_close(getattr(got, name).c, getattr(want, name).c,
                          ROLLOUT)
            assert torch.equal(getattr(got, name).active,
                               getattr(want, name).active)
            assert torch.equal(getattr(got, name).age,
                               getattr(want, name).age)
        _assert_close(got.gamma_k, want.gamma_k, ROLLOUT)
        _assert_close((got.inner2, got.inner3, got.lam),
                      (want.inner2, want.inner3, want.lam), ROLLOUT)
        assert r["refresh"]["roundtrip_equal"]


def test_step_and_gap_entry_points_take_a_mesh():
    """`afto_step_aux(mesh=)`, `make_gap_aux(mesh=)` and
    `stationarity_gap_sq(mesh=)` on each rank's shard of a live state,
    against the unsharded step and gap: the post-step state, the cut
    values and the gap (with and without the step's products)."""
    for r in ranks(2):
        step = r["refresh"]["step"]
        _assert_close(step["got"], step["want"], ROLLOUT)
        _assert_close(step["gap_with_aux"], step["want"][2], ROLLOUT)


def test_all_reduce_refuses_inside_torch_func():
    mesh = _fake_mesh()
    x = torch.ones(3)
    with pytest.raises(RuntimeError, match="torch.func"):
        torch.func.grad(lambda v: mesh.all_reduce(s=v)["s"].sum())(x)
    with pytest.raises(RuntimeError, match="torch.func"):
        torch.func.vmap(lambda v: mesh.all_reduce(s=v)["s"])(x[:, None])


# ---------------------------------------------------------------------------
# layout, schedules, loader, launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", (1, 2, 4))
def test_shard_state_is_make_views_and_roundtrips(n_shards):
    """`shard_state` is `make_views`' block as a state; `unshard_state`
    inverts it bit for bit; `afto_state_specs` splits exactly the leaves
    `make_views` slices."""
    _, tp = quad_problems()
    st = afto.init_state(tp, port_hyper())
    st = afto.afto_step(tp, port_hyper(), st, torch.tensor([1., 0, 1, 1]))
    st = afto.cut_refresh(tp, port_hyper(), st)
    locals_ = [shd.shard_state(st, w, n_shards) for w in range(n_shards)]
    back = shd.unshard_state(locals_, st.cuts_i.spec, st.cuts_ii.spec)
    assert _leaves_equal(back, st)
    view = make_views(st, n_shards)[n_shards - 1]
    assert _leaves_equal(locals_[-1].X3, view.stacks["X3"])
    assert _leaves_equal(locals_[-1].cuts_ii.a, view.cuts_ii.a)
    specs = pytree.tree_leaves(shd.afto_state_specs(st),
                               is_leaf=lambda x: isinstance(x, tuple))
    for spec, full, part in zip(specs, pytree.tree_leaves(st),
                                pytree.tree_leaves(locals_[-1])):
        assert spec in (("worker",), ())
        if spec == ():
            assert torch.equal(part, full)
        elif n_shards > 1:
            assert part.shape != full.shape
    lead = shd.afto_state_specs(st, lead=(None,))
    assert lead.X1 == (None, "worker") and lead.z1 == (None,)
    assert shd.worker_data_specs(tp.data) == {"A": ("worker",),
                                             "b": ("worker",)}


def test_schedule_worker_shards_matches_reference():
    want = JaxScheduler(make_straggler_cfg()).precompute(16)
    got = Schedule(active=want.active, sim_time=want.sim_time,
                   max_staleness=want.max_staleness)
    for w in (1, 2, 4):
        np.testing.assert_array_equal(got.worker_shards(w),
                                      want.worker_shards(w))
    with pytest.raises(ValueError):
        got.worker_shards(3)


def test_sharded_loader_gives_each_rank_its_rows():
    """Each rank's rows, in rank order, are the reference loader's batch
    (2 epochs of 3 batches of 6 rows out of 23)."""
    out = [r["loader"] for r in ranks(2)]
    ref = jax_loader.ShardedLoader(_loader_arrays(), 6, seed=4)
    for epoch in range(2):
        want = list(ref)
        assert len(out[0][epoch]) == len(want) == 3
        for b, wb in enumerate(want):
            for k in ("x", "y"):
                got = np.concatenate([o[epoch][b][k] for o in out])
                np.testing.assert_array_equal(got, np.asarray(wb[k]))
                assert len(out[0][epoch][b][k]) == 3
    with pytest.raises(ValueError, match="split"):
        ShardedLoader(_loader_arrays(), 5, mesh=_fake_mesh())
    with pytest.raises(ValueError, match="needs a mesh"):
        ShardedLoader(_loader_arrays(), 6, spec=("worker",), device="cpu")


def test_bad_meshes_rejected():
    _, tp = quad_problems()
    sched = JaxScheduler(make_straggler_cfg()).precompute(4)
    sched = Schedule(active=sched.active, sim_time=sched.sim_time,
                     max_staleness=sched.max_staleness)
    with pytest.raises(ValueError, match="divide"):      # 4 workers / 3
        run_scanned(tp, port_hyper(), sched, mesh=_fake_mesh(3))
    with pytest.raises(ValueError, match="'worker' axis"):
        run_scanned(tp, port_hyper(), sched, mesh=_fake_mesh(2, "data"))
    with pytest.raises(ValueError, match="not a shard"):
        run_scanned(tp, port_hyper(), sched, mesh=_fake_mesh(rank=None))
    # NCCL: one GPU per rank, never on the CPU, never switched to gloo
    with pytest.raises(ValueError, match="gloo"):
        mesh_lib.make_worker_mesh(2, backend="nccl",
                                  device=torch.device("cuda"))
    with pytest.raises(ValueError, match="gloo"):
        mesh_lib.make_worker_mesh(1, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="gloo"):
        mesh_lib.spawn_mesh("torch_mesh_ranks:run_cases", 2,
                            backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="processes"):
        mesh_lib.make_worker_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        mesh_lib.make_worker_mesh(1, backend="mpi", device="cpu")


def test_spawn_mesh_fails_fast_on_a_failing_rank():
    """A rank that raises fails the mesh at once with its traceback; the
    other rank, blocked in a collective, is killed."""
    with pytest.raises(mesh_lib.MeshError, match="no such case") as e:
        mesh_lib.spawn_mesh("torch_mesh_ranks:failing_rank", 2,
                            device="cpu", pythonpath=[str(TESTS)],
                            timeout=60.0)
    assert "rank 1 of 2 exited 1" in str(e.value)
