"""The port's data streams, chunked runs and loader
(`repro_torch.data.stream`, `core.engine.run_chunked`, `RunSpec(data=,
chunk_size=, chunk_hook=)`, `data.loader`) on the CPU.

Inside the port, exactly: a fixed seed draws the same batches in this
process and in a fresh one, worker blocks and per-row times do not change
a row, any chunk partition of a run (streamed or not) equals the
unchunked run bit for bit (the reference's four boundary sets,
tests/test_stream.py:146-156, and a hypothesis property), and the
engine's host mirror of `t_hat` is the state's.  Between the port's
engines, the reference's own tolerances (tests/test_stream.py:186-199,
259-272): streamed scan against streamed eager at rtol 1e-5 on states
and 1e-4 on `gap_sq`, cut counts exact; a streamed sweep's rows against
streamed single runs at rtol 2e-5 on states and 2e-4 on `gap_sq`.

Against the reference: the port fed the reference's batches
(`convert.stream_from_reference`; `jax.random` draws have no torch
counterpart) against the reference's streamed `run_scanned`, and
replacement `data=` arrays on `scan` and `eager`, at the reference's
`_assert_trees_close` tolerance (rtol 1e-4, atol 1e-6), cut counts
exact; `ShardedLoader` batches equal.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from conftest import make_hyper, make_quadratic_problem, make_straggler_cfg
from repro.core import RunSpec as JaxRunSpec
from repro.core import StragglerScheduler as JaxScheduler
from repro.core import run as jax_run
from repro.core import run_scanned as jax_run_scanned
from repro.data import loader as jax_loader
from repro.data import stream as jax_stream
from repro_torch import convert
from repro_torch.apps import robust_hpo
from repro_torch.core import (RunSpec, Schedule, StragglerConfig,
                              StragglerScheduler, run, run_scanned)
from repro_torch.data import ShardedLoader
from repro_torch.data import stream as stream_lib
from repro_torch.kernels import ops
from repro_torch.launch.mesh import WorkerMesh
from test_torch_core import assert_states_close, port_hyper, quad_problems

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

REPO = Path(__file__).resolve().parents[1]
DIM = 3
CROSS = dict(rtol=1e-4, atol=1e-6)


def _sample(key, device):
    g = stream_lib.generator(key, device)
    return {"A": torch.randn((DIM, DIM), generator=g, device=device) * 0.3,
            "b": torch.randn((DIM,), generator=g, device=device)}


def _stream(seed=0, n_workers=4):
    return stream_lib.make_stream(_sample, n_workers, seed)


def _batch(s, it, **kw):
    return stream_lib.next_batch(s, it, device="cpu", **kw)


def _schedule(n, **kw):
    cfg = StragglerConfig(**dict(dict(n_workers=4, s_active=3, tau=5,
                                      n_stragglers=1, seed=0), **kw))
    return StragglerScheduler(cfg).precompute(n)


def _port_schedule(schedule):
    return Schedule(active=schedule.active, sim_time=schedule.sim_time,
                    max_staleness=schedule.max_staleness)


def _leaves(x):
    return pytree.tree_leaves(x)


def _assert_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _assert_close(a, b, rtol, atol):
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# key discipline
# ---------------------------------------------------------------------------

def test_worker_key_is_a_fixed_64_bit_mix():
    """splitmix64's published first output from state 0 pins the mix; the
    keys are pure functions of their integers."""
    assert stream_lib._splitmix64(0) == 0xE220A8397B1DCDAF
    assert stream_lib.worker_key(0, 0, 0) == 12103184956288865414
    assert stream_lib.worker_key(7, 3, 2) == 11220470894275550219
    keys = {stream_lib.worker_key(1, it, j) for it in range(50)
            for j in range(8)}
    assert len(keys) == 400 and all(0 <= k < 2 ** 64 for k in keys)


def test_batches_are_deterministic_for_a_fixed_seed():
    s = _stream(seed=3)
    _assert_equal(_batch(s, 0), _batch(s, 0))
    b0, b1 = _batch(s, 0), _batch(s, 1)
    assert b0["A"].shape == (4, DIM, DIM) and b0["b"].shape == (4, DIM)
    assert not torch.allclose(b0["A"], b1["A"])
    assert not torch.allclose(b0["A"][0], b0["A"][1])
    assert not torch.allclose(b0["A"], _batch(_stream(seed=4), 0)["A"])
    assert s.key == 3                      # the base key never advances


def test_worker_blocks_are_layout_independent():
    s = _stream(seed=1)
    full = _batch(s, 5)
    for off, n_loc in ((0, 1), (1, 2), (2, 2), (0, 4)):
        part = _batch(s, 5, worker_offset=off, n_local=n_loc)
        _assert_equal(part, {k: v[off:off + n_loc] for k, v in
                             full.items()})


def test_scalar_and_per_row_times_give_the_same_rows():
    s = _stream(seed=2)
    _assert_equal(_batch(s, 5), _batch(s, [5, 5, 5, 5]))
    its = [0, 3, 3, 7]
    rows = _batch(s, its)
    for j, it in enumerate(its):
        _assert_equal({k: v[j] for k, v in rows.items()},
                      {k: v[j] for k, v in _batch(s, it).items()})
    # one row of times per run of a sweep
    runs = _batch(s, np.array([its, [5, 5, 5, 5]]))
    assert runs["A"].shape == (2, 4, DIM, DIM)
    _assert_equal({k: v[0] for k, v in runs.items()}, rows)
    _assert_equal({k: v[1] for k, v in runs.items()}, _batch(s, 5))


def test_reseeding_keeps_the_spec():
    s = _stream(seed=0)
    r = dataclasses.replace(s, key=9)
    assert r.spec is s.spec and r.key == 9
    assert not torch.allclose(_batch(s, 0)["A"], _batch(r, 0)["A"])
    _assert_equal(_batch(r, 4), _batch(_stream(seed=9), 4))


_DIGEST = textwrap.dedent("""
    import hashlib

    import torch

    from repro_torch.data import stream as stream_lib

    def sample(key, device):
        g = stream_lib.generator(key, device)
        return {"A": torch.randn((3, 3), generator=g, device=device) * 0.3,
                "b": torch.randn((3,), generator=g, device=device)}

    def digest(seed=7, n_workers=4, iters=4):
        s = stream_lib.make_stream(sample, n_workers, seed)
        h = hashlib.sha256()
        for it in range(iters):
            b = stream_lib.next_batch(s, it, device="cpu")
            h.update(b["A"].numpy().tobytes())
            h.update(b["b"].numpy().tobytes())
        return h.hexdigest()
""")


def test_cross_process_seed_determinism():
    """A fresh process (its own hash salt) draws the same bytes."""
    ns: dict = {}
    exec(compile(_DIGEST, "<digest>", "exec"), ns)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               PYTHONHASHSEED="12345")
    out = subprocess.run(
        [sys.executable, "-c", _DIGEST + "\nprint(digest())"], env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == ns["digest"]()


def test_host_t_hat_mirror_matches_the_state(monkeypatch):
    """The times the scan engine draws each iteration's batch at (its host
    mirror) equal the state's `stale.t_hat` before that iteration, up to
    and including the end of the run; the state after each iteration
    comes from a run in chunks of one."""
    _, tp = quad_problems()
    hyper = port_hyper(t_pre=3)
    T = 8
    drawn = []
    real = stream_lib.next_batch

    def spy(stream, it, *args, **kw):
        drawn.append(np.array(it, np.int64))
        return real(stream, it, *args, **kw)

    monkeypatch.setattr(stream_lib, "next_batch", spy)
    run_scanned(tp, hyper, _schedule(T + 1), metrics_every=T + 1,
                data=_stream())
    seen = []
    run(RunSpec(problem=tp, hyper=hyper, schedule=_schedule(T + 1).slice(
        0, T), chunk_size=1, device="cpu", data=_stream(),
        chunk_hook=lambda s, t: seen.append(s.stale.t_hat.numpy())))
    assert len(drawn) == 2 * T + 1 and len(seen) == T
    np.testing.assert_array_equal(drawn[0], np.zeros(4))
    for k in range(1, T + 1):
        np.testing.assert_array_equal(drawn[k], seen[k - 1])
    assert seen[-1].max() == T and seen[-1].min() < T   # a straggler lags


def test_problem_stream_refuses_integer_leaves():
    """Robust HPO's data carries the int64 worker ids ("wid"): neither
    package draws a normal for them."""
    task = robust_hpo.make_robust_hpo_problem("diabetes", n_workers=4,
                                              seed=0, device="cpu")
    assert task.problem.data["wid"].dtype == torch.int64
    with pytest.raises(ValueError, match="int64"):
        stream_lib.problem_stream(task.problem.data, 4)
    data = {k: np.asarray(v) for k, v in task.problem.data.items()}
    with pytest.raises((TypeError, ValueError)):
        jax_stream.next_batch(jax_stream.problem_stream(data, 4), 0)
    # float leaves stream, in their shapes and dtypes
    s = stream_lib.problem_stream(
        {"A": torch.zeros(4, 2, 3), "b": torch.zeros(4, 2,
                                                     dtype=torch.float64)},
        4, seed=1)
    b = _batch(s, 0)
    assert b["A"].shape == (4, 2, 3) and b["b"].dtype == torch.float64


def test_stream_validation():
    _, tp = quad_problems()
    sched = _schedule(4)
    with pytest.raises(ValueError, match="workers"):
        run_scanned(tp, port_hyper(), sched, data=_stream(n_workers=3))
    with pytest.raises(ValueError, match="spec"):
        run_scanned(tp, port_hyper(), sched, data=stream_lib.Stream(key=0))
    if not torch.cuda.is_available():
        # batches are drawn on CUDA unless the caller names a device
        with pytest.raises(RuntimeError, match="device='cpu'"):
            stream_lib.next_batch(_stream(), 0)


def test_zipf_tokens():
    toks = stream_lib.zipf_tokens(0, (64, 128), 1000, device="cpu")
    assert toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < 1000
    vals, counts = torch.unique(toks, return_counts=True)
    assert int(vals[torch.argmax(counts)]) == 0
    assert torch.equal(toks, stream_lib.zipf_tokens(0, (64, 128), 1000,
                                                    device="cpu"))
    for bad_a in (1.0, 0.9):
        with pytest.raises(ValueError, match="zipf_a"):
            stream_lib.zipf_tokens(0, (2, 4), 16, zipf_a=bad_a,
                                   device="cpu")


# ---------------------------------------------------------------------------
# chunk partitions: bit for bit
# ---------------------------------------------------------------------------

def _assert_chunking_invariant(tp, hyper, sched, data, bounds):
    """State-continued runs over `bounds` (refreshes on t_pre=3 included)
    end in the unchunked run's final state, bit for bit."""
    T = sched.n_iterations
    full = run_scanned(tp, hyper, sched, metrics_every=T, data=data)
    state = None
    for a, b in zip(bounds[:-1], bounds[1:]):
        state = run(RunSpec(problem=tp, hyper=hyper, schedule=sched.slice(
            a, b), metrics_every=T, state=state, data=data,
            device="cpu")).state
    _assert_equal(state, full.state)


@pytest.mark.parametrize("streamed", [True, False])
@pytest.mark.parametrize("bounds", [
    [0, 7, 12, 20],       # boundaries off the refresh stride t_pre=3
    [0, 1, 20],           # a one-iteration first chunk
    [0, 19, 20],          # a one-iteration final chunk
    [0, 3, 6, 9, 20],     # boundaries on the refresh stride
])
def test_chunked_trajectory_bit_identical(bounds, streamed):
    _, tp = quad_problems()
    _assert_chunking_invariant(tp, port_hyper(t_pre=3), _schedule(20),
                               _stream() if streamed else None, bounds)


if HAVE_HYPOTHESIS:
    @settings(deadline=None, max_examples=8)
    @given(data=st.data())
    def test_chunked_trajectory_bit_identical_property(data):
        """Any partition of any length, streamed or not."""
        T = data.draw(st.integers(4, 20), label="n_iterations")
        bounds = [0] + sorted(data.draw(
            st.sets(st.integers(1, T - 1), max_size=3),
            label="cuts")) + [T]
        streamed = data.draw(st.booleans(), label="streamed")
        _, tp = quad_problems()
        _assert_chunking_invariant(tp, port_hyper(t_pre=3), _schedule(T),
                                   _stream() if streamed else None, bounds)


def test_run_chunked_hook_and_stitched_history():
    """The hook sees every boundary, the last included, with the live
    state; returning None gives the unchunked run bit for bit; the
    stitched `t` and `host_time` are absolute."""
    _, tp = quad_problems()
    spec = RunSpec(problem=tp, hyper=port_hyper(t_pre=3), device="cpu",
                   schedule=_schedule(20), metrics_every=5, data=_stream())
    full = run(spec)
    seen = []
    chunked = run(dataclasses.replace(
        spec, chunk_size=7,
        chunk_hook=lambda s, t: seen.append((t, int(s.t)))))
    assert seen == [(7, 7), (14, 14), (20, 20)]
    _assert_equal(chunked.state, full.state)
    h, hf = chunked.history, full.history
    np.testing.assert_array_equal(h["t"], [5, 7, 12, 14, 19, 20])
    assert np.all(np.diff(h["host_time"]) > 0)
    for k in ("gap_sq", "n_cuts_i", "n_cuts_ii", "sim_time",
              "max_staleness"):
        for t in (5, 20):
            assert h[k][list(h["t"]).index(t)] == \
                hf[k][list(hf["t"]).index(t)], k


def test_chunk_hook_replacement_replaces_the_carry():
    _, tp = quad_problems()
    hyper, sched = port_hyper(t_pre=3), _schedule(20)

    def nudge(state):
        return dataclasses.replace(state, z1=state.z1 + 0.5)

    def hook(state, t):
        return nudge(state) if t == 7 else None

    got = run(RunSpec(problem=tp, hyper=hyper, schedule=sched,
                      chunk_size=7, chunk_hook=hook, data=_stream(),
                      device="cpu")).state
    st = run_scanned(tp, hyper, sched.slice(0, 7), data=_stream()).state
    want = run_scanned(tp, hyper, sched.slice(7, 20), data=_stream(),
                       state=nudge(st)).state
    _assert_equal(got, want)
    assert not torch.equal(got.z1, run_scanned(
        tp, hyper, sched, data=_stream()).state.z1)


# ---------------------------------------------------------------------------
# the port's engines against each other
# ---------------------------------------------------------------------------

def test_streamed_scan_matches_eager():
    _, tp = quad_problems()
    spec = RunSpec(problem=tp, hyper=port_hyper(), schedule=_schedule(30),
                   metrics_every=10, data=_stream(), device="cpu")
    scan = run(spec)
    eager = run(dataclasses.replace(spec, engine="eager"))
    _assert_close(eager.state, scan.state, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(eager.history["gap_sq"],
                               scan.history["gap_sq"], rtol=1e-4, atol=1e-6)
    for k in ("n_cuts_i", "n_cuts_ii"):
        assert list(eager.history[k]) == list(scan.history[k])


@pytest.mark.parametrize("route", ["plain", "functions"])
def test_streamed_sweep_rows_match_single_runs(route, monkeypatch):
    """One shared stream, two arrival processes: each row draws at its
    own `t_hat` and equals its single streamed run.  "functions" sends
    every cut contraction through the `cut_ad` Functions' vmap rules."""
    if route == "functions":
        monkeypatch.setattr(ops, "route", lambda a, impl: "kernel")
    _, tp = quad_problems()
    hyper = port_hyper()
    scheds = [_schedule(15, seed=s) for s in (0, 1)]
    swept = run(RunSpec(problem=tp, hyper=hyper, engine="sweep",
                        schedules=scheds, metrics_every=5, data=_stream(),
                        device="cpu"))
    for r in range(2):
        single = run_scanned(tp, hyper, scheds[r], metrics_every=5,
                             data=_stream())
        row = swept.run(r)
        _assert_close(row.state, single.state, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(row.history["gap_sq"],
                                   single.history["gap_sq"], rtol=2e-4,
                                   atol=1e-6)
        for k in ("n_cuts_i", "n_cuts_ii", "t", "sim_time"):
            assert list(row.history[k]) == list(single.history[k]), k
        np.testing.assert_array_equal(row.state.stale.t_hat,
                                      single.state.stale.t_hat)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _jax_sample(key):
    ka, kb = jax.random.split(key)
    return {"A": jax.random.normal(ka, (DIM, DIM)) * 0.3,
            "b": jax.random.normal(kb, (DIM,))}


def _assert_counts_equal(h, hw):
    for k in ("n_cuts_i", "n_cuts_ii"):
        assert list(h[k]) == list(np.asarray(hw[k])), k


def test_streamed_scan_matches_reference_fed_its_batches():
    """The reference's streamed `run_scanned` (refreshes every 5th
    iteration) against the port drawing the reference's rows by
    (iteration, worker) from a table."""
    jp, tp = quad_problems()
    T = 25
    sched = JaxScheduler(make_straggler_cfg()).precompute(T)
    js = jax_stream.make_stream(_jax_sample, 4, 0)
    want = jax_run_scanned(jp, make_hyper(), sched, metrics_every=5,
                           data=js)
    batches = [jax.tree.map(np.asarray, jax_stream.next_batch(js, it))
               for it in range(T)]
    got = run_scanned(tp, port_hyper(), _port_schedule(sched),
                      metrics_every=5,
                      data=convert.stream_from_reference(batches))
    assert_states_close(got.state, want.state, **CROSS)
    np.testing.assert_allclose(got.history["gap_sq"],
                               np.asarray(want.history["gap_sq"]), **CROSS)
    _assert_counts_equal(got.history, want.history)


@pytest.mark.parametrize("engine", ["scan", "eager"])
def test_replacement_data_matches_reference(engine):
    jp, tp = quad_problems()
    data = {k: np.asarray(v) for k, v in
            make_quadratic_problem(seed=3).data.items()}
    sched = JaxScheduler(make_straggler_cfg()).precompute(20)
    want = jax_run(JaxRunSpec(problem=jp, hyper=make_hyper(),
                              engine=engine, schedule=sched,
                              metrics_every=10, data=data))
    got = run(RunSpec(problem=tp, hyper=port_hyper(), engine=engine,
                      schedule=_port_schedule(sched), metrics_every=10,
                      data=data, device="cpu"))
    assert_states_close(got.state, want.state, **CROSS)
    np.testing.assert_allclose(got.history["gap_sq"],
                               np.asarray(want.history["gap_sq"]), **CROSS)
    _assert_counts_equal(got.history, want.history)
    # the replacement moved the trajectory off the problem's own data
    own = run(RunSpec(problem=tp, hyper=port_hyper(), engine=engine,
                      schedule=_port_schedule(sched), metrics_every=10,
                      device="cpu"))
    assert not np.allclose(own.history["gap_sq"], got.history["gap_sq"])


def test_sharded_loader_matches_reference():
    rng = np.random.default_rng(0)
    arrays = {"x": rng.normal(size=(23, 3)).astype(np.float32),
              "y": np.arange(23, dtype=np.int64)}
    for drop_last in (True, False):
        ref = jax_loader.ShardedLoader(arrays, 5, seed=4,
                                       drop_last=drop_last)
        got = ShardedLoader(arrays, 5, seed=4, drop_last=drop_last,
                            device="cpu")
        for _epoch in range(2):
            want_b, got_b = list(ref), list(got)
            assert len(got_b) == len(want_b) == (4 if drop_last else 5)
            for g, w in zip(got_b, want_b):
                for k in arrays:
                    assert g[k].device.type == "cpu"
                    np.testing.assert_array_equal(g[k].numpy(),
                                                  np.asarray(w[k]))
    # a worker mesh's batch must split over its shards
    mesh = WorkerMesh(group=None, rank=0, size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="split"):
        ShardedLoader(arrays, 5, mesh=mesh)
