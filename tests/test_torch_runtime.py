"""The port's async federation runtime (`repro_torch.fed.runtime`) on the
CPU, against the reference's (`repro.fed.runtime`).

  * Wire format: a port frame and a reference frame of the same message
    are byte-identical, each side decodes the other's, pickled payloads
    and leaf-count mismatches raise, and a bf16 leaf is refused.
  * Arrivals: `ArrivalRecorder` and `ArrivalPolicy` against the
    reference's on the same seeded arrival sequences, exactly.
  * Worker gradients: a port worker's pushed rows against a reference
    worker's within the reference's rtol 1e-6 / atol 1e-7
    (tests/test_runtime.py:616).
  * Replay parity: the port's `run_async(replay=schedule)` against the
    reference's on the reference's data, at the reference's own
    tolerances (tests/test_runtime.py:311-315, streamed gap 1e-5: :361).
  * Bitwise inside the port: a live run against its echo replay,
    streamed and under `ArrivalPolicy`; `RunSpec(engine="async")`.
  * The registry: rebuilt identically, rows stable under width, and
    `convert.registry_problem` carrying the reference's data.

Every run is on `device="cpu"`, in process, with every wait bounded
(the runtime joins its worker threads with a timeout and raises if one
is left).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import make_schedules
from repro.core import scheduler as jax_sched
from repro.fed.runtime import messages as jax_msg
from repro.fed.runtime import problems as jax_problems
from repro.fed.runtime import run_async as jax_run_async
from repro.fed.runtime import worker as jax_worker
from repro.fed.runtime import transport as jax_transport
from repro_torch import convert
from repro_torch.core import (ArrivalPolicy, ArrivalRecorder, RunSpec,
                              afto, run, run_chunked, run_scanned)
from repro_torch.fed.runtime import (InProcTransport, decode, encode,
                                     run_async)
from repro_torch.fed.runtime import messages as msg_lib
from repro_torch.fed.runtime import problems
from repro_torch.fed.runtime import worker as worker_lib
from repro_torch.utils.tree import tree_index, tree_leaves
from test_torch_core import quad_problems

REPLAY = dict(rtol=2e-5, atol=1e-6)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_bitwise(got, want):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def assert_state_matches_reference(port_state, ref_state, **tol):
    got = tree_leaves(port_state)
    want = jax.tree.leaves(ref_state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), **tol)


# ---------------------------------------------------------------------------
# the wire format
# ---------------------------------------------------------------------------

def _rows(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(3).astype(np.float32)
                 for _ in range(3))


def _message_pairs():
    """(name, port message, reference message) for the same content; the
    tree payloads are dicts with unsorted keys on both sides."""
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((2, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}
    rows = (tree, _rows()[1], _rows()[2])
    port_rows = (convert.to_torch(tree, "cpu"),
                 torch.tensor(rows[1]), torch.tensor(rows[2]))
    return [
        ("push", msg_lib.push(2, 7, port_rows, epoch=1),
         jax_msg.push(2, 7, rows, epoch=1)),
        ("refresh", msg_lib.refresh(1, 12, port_rows),
         jax_msg.refresh(1, 12, rows)),
        ("welcome", msg_lib.welcome(4, 9, 5), jax_msg.welcome(4, 9, 5)),
        ("stop", msg_lib.stop(), jax_msg.stop()),
        ("hello", msg_lib.hello(3, 2), jax_msg.hello(3, 2)),
        ("heartbeat", msg_lib.heartbeat(0, 1), jax_msg.heartbeat(0, 1)),
        ("admit", msg_lib.admit(5, 0), jax_msg.admit(5, 0)),
        ("disconnect", msg_lib.disconnect(1), jax_msg.disconnect(1)),
    ]


@pytest.mark.parametrize("idx", range(8))
def test_frames_are_byte_identical_and_cross_decode(idx):
    name, port_m, ref_m = _message_pairs()[idx]
    port_frame, ref_frame = encode(port_m), jax_msg.encode(ref_m)
    assert port_frame == ref_frame, name
    for got in (decode(ref_frame), jax_msg.decode(port_frame)):
        assert got.kind == ref_m.kind and got.meta == ref_m.meta
        assert sorted(got.arrays) == sorted(ref_m.arrays)
        for k, v in ref_m.arrays.items():
            np.testing.assert_array_equal(got.arrays[k], np.asarray(v))
            assert got.arrays[k].dtype == np.asarray(v).dtype
    assert msg_lib.peek_kind(ref_frame) == ref_m.kind
    assert msg_lib.peek_meta(ref_frame) == ref_m.meta
    assert msg_lib.peek_kind(port_frame[:3]) is None


def test_push_rows_decode_against_port_templates():
    _, port_m, _ = _message_pairs()[0]
    tpl = ({"b": torch.zeros(3), "w": torch.zeros(2, 3)}, torch.zeros(3),
           torch.zeros(3))
    g1, g2, g3 = msg_lib.push_grads(decode(encode(port_m)), tpl)
    assert sorted(g1) == ["b", "w"] and g1["w"].shape == (2, 3)
    rows = _rows()
    np.testing.assert_array_equal(g2, rows[1])


def test_pickled_payload_and_leaf_mismatch_raise():
    frame = bytearray(encode(msg_lib.Message(
        "push", {"worker": 0}, {"g1/0": np.array([1.0, 2.0])})))
    objs = encode(msg_lib.Message("push", {"worker": 0}, {}))
    import io
    import struct
    buf = io.BytesIO()
    np.savez(buf, bad=np.array([{"a": 1}], dtype=object))
    header = frame[4:4 + struct.unpack(">I", bytes(frame[:4]))[0]]
    pickled = struct.pack(">I", len(header)) + bytes(header) + buf.getvalue()
    with pytest.raises(ValueError, match="pickle"):
        decode(pickled)
    assert decode(objs).arrays == {}
    m = decode(bytes(frame))
    with pytest.raises(ValueError, match="leaves"):
        msg_lib.unpack_tree(m, "g1", (torch.zeros(2), torch.zeros(2)))
    with pytest.raises(TypeError, match="wire"):
        msg_lib.push(0, 1, (torch.zeros(3, dtype=torch.bfloat16),
                            torch.zeros(3), torch.zeros(3)))


# ---------------------------------------------------------------------------
# arrivals: recorder and policy
# ---------------------------------------------------------------------------

def _arrival_script(seed, n=4, t=40):
    """A seeded sequence of recorder operations: masks, deaths, rejoins
    and one widening."""
    rng = np.random.default_rng(seed)
    ops = []
    width = n
    for it in range(t):
        if it == t // 2:
            width += 1
            ops.append(("widen", width))
            ops.append(("alive", width - 1))
        u = rng.random()
        if u < 0.1:
            ops.append(("dead", int(rng.integers(width))))
        elif u < 0.2:
            ops.append(("alive", int(rng.integers(width))))
        mask = (rng.random(width) < 0.6).astype(np.float32)
        eff = None if rng.random() < 0.3 else (int(rng.integers(1, width)),
                                               int(rng.integers(1, 6)))
        ops.append(("record", mask, float(it) * 0.5, eff))
    return ops


def _play(recorder, ops):
    out = []
    for op in ops:
        if op[0] == "widen":
            recorder.widen(op[1])
        elif op[0] == "dead":
            recorder.mark_dead(op[1])
        elif op[0] == "alive":
            recorder.mark_alive(op[1])
        else:
            _, mask, sim_t, eff = op
            kw = {} if eff is None else dict(s_eff=eff[0], tau_eff=eff[1])
            out.append(recorder.record(mask, sim_t, **kw))
            out.append(recorder.staleness().tolist())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arrival_recorder_matches_reference(seed):
    ops = _arrival_script(seed)
    port, ref = ArrivalRecorder(4), jax_sched.ArrivalRecorder(4)
    assert _play(port, ops) == _play(ref, ops)
    got, want = port.to_schedule(), ref.to_schedule()
    for f in ("active", "sim_time", "max_staleness", "dead", "s_eff",
              "tau_eff", "width"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert port.recent(5) == ref.recent(5)
    sd = port.state_dict()
    for k, v in ref.state_dict().items():
        np.testing.assert_array_equal(sd[k], v)
    back = ArrivalRecorder(1)
    back.load_state_dict(ref.state_dict())
    assert back.to_schedule().width is not None
    np.testing.assert_array_equal(back.to_schedule().active, want.active)
    # a slice carries every column
    part = got.slice(3, 9)
    assert part.dead.shape == (6, 5) and part.width.shape == (6,)


@pytest.mark.parametrize("seed", [0, 1])
def test_arrival_policy_matches_reference(seed):
    rng = np.random.default_rng(seed)
    port = ArrivalPolicy(s_active=3, tau=5)
    ref = jax_sched.ArrivalPolicy(s_active=3, tau=5)
    for _ in range(60):
        stale = rng.integers(0, 7, size=5)
        alive = rng.random(5) < 0.8
        assert port.propose(stale, alive) == ref.propose(stale, alive)
    with pytest.raises(ValueError):
        ArrivalPolicy(s_active=0, tau=5)


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

def _ref_quadratic(n=4, dim=3, seed=0):
    """The reference registry's quadratic and the port's on its data."""
    jp, jh = jax_problems.build("quadratic", n_workers=n, dim=dim, seed=seed)
    tp, th = convert.registry_problem(
        "quadratic", jax.tree.map(np.asarray, jp.data), n, dim, seed)
    return jp, jh, tp, th


def test_worker_pushes_the_reference_workers_rows():
    jp, jh, tp, th = _ref_quadratic()
    rows = _rows(3)
    pushed = {}
    for name, lib_msg, loop, prob, hub, to_rows in (
            ("port", msg_lib, worker_lib.worker_loop, tp,
             InProcTransport(4), lambda r: tuple(map(torch.tensor, r))),
            ("ref", jax_msg, jax_worker.worker_loop, jp,
             jax_transport.InProcTransport(4), lambda r: r)):
        me, we = hub.master_endpoint(), hub.worker_endpoint(2)
        me.send(2, lib_msg.encode(lib_msg.refresh(2, 0, to_rows(rows))))
        me.send(2, lib_msg.encode(lib_msg.stop()))
        kw = {"device": "cpu"} if name == "port" else {}
        assert loop(prob, 2, we, **kw) == 1
        assert lib_msg.decode(me.recv(timeout=5)).kind == "hello"
        pushed[name] = jax_msg.decode(me.recv(timeout=5))
        assert pushed[name].kind == "push"
    assert sorted(pushed["port"].arrays) == sorted(pushed["ref"].arrays)
    for k, v in pushed["ref"].arrays.items():
        np.testing.assert_allclose(pushed["port"].arrays[k], v,
                                   rtol=1e-6, atol=1e-7)


def test_worker_rejects_refresh_without_iteration_stamp():
    _, tp = quad_problems()
    hub = InProcTransport(4)
    me, we = hub.master_endpoint(), hub.worker_endpoint(0)
    rows = tuple(map(torch.tensor, _rows()))
    good = msg_lib.refresh(0, 0, rows)
    me.send(0, encode(good))
    me.send(0, encode(msg_lib.Message(msg_lib.REFRESH, {"worker": 0},
                                      dict(good.arrays))))
    with pytest.raises(ValueError, match="REFRESH without"):
        worker_lib.worker_loop(tp, 0, we, device="cpu")


def test_worker_refuses_a_problem_on_another_device():
    _, tp = quad_problems()
    hub = InProcTransport(4)
    with pytest.raises(ValueError, match="lives on"):
        worker_lib.worker_loop(tp, 0, hub.worker_endpoint(0),
                               device="meta")


# ---------------------------------------------------------------------------
# replay parity with the reference
# ---------------------------------------------------------------------------

def test_replay_matches_reference_replay():
    jp, jh, tp, th = _ref_quadratic()
    (schedule,) = make_schedules(24, seeds=(0,))
    ref = jax_run_async(jp, jh, replay=schedule, metrics_every=6)
    got = run_async(tp, th, replay=schedule, metrics_every=6, device="cpu")
    np.testing.assert_allclose(got.history["gap_sq"],
                               ref.history["gap_sq"], rtol=2e-5)
    assert_state_matches_reference(got.state, ref.state, **REPLAY)
    np.testing.assert_array_equal(got.arrivals.active, ref.arrivals.active)
    np.testing.assert_array_equal(got.arrivals.max_staleness,
                                  ref.arrivals.max_staleness)
    np.testing.assert_array_equal(got.arrivals.sim_time,
                                  schedule.sim_time)
    for k in ("t", "sim_time", "max_staleness", "n_cuts_i", "n_cuts_ii"):
        np.testing.assert_array_equal(got.history[k],
                                      np.asarray(ref.history[k]))


def test_streamed_replay_matches_reference_replay():
    """The reference's streamed batches handed over as a table
    (`convert.stream_from_reference`): the port's workers and master
    draw exactly the reference's rows."""
    from repro.data import stream as jax_stream
    jp, jh, tp, th = _ref_quadratic()
    strm = jax_problems.build_stream("quadratic", n_workers=4)
    (schedule,) = make_schedules(16, seeds=(1,))
    batches = [jax.tree.map(np.asarray, jax_stream.next_batch(strm, it))
               for it in range(schedule.n_iterations + 1)]
    ref = jax_run_async(jp, jh, replay=schedule, metrics_every=4,
                        data=strm)
    got = run_async(tp, th, replay=schedule, metrics_every=4,
                    data=convert.stream_from_reference(batches),
                    device="cpu")
    np.testing.assert_allclose(got.history["gap_sq"],
                               ref.history["gap_sq"], rtol=1e-5)
    assert_state_matches_reference(got.state, ref.state, **REPLAY)
    np.testing.assert_array_equal(got.arrivals.active, schedule.active)


def test_replay_matches_run_scanned_and_run_spec_routes_async():
    _, _, tp, th = _ref_quadratic()
    (schedule,) = make_schedules(20, seeds=(2,))
    scan = run_scanned(tp, th, schedule, metrics_every=5)
    got = run(RunSpec(problem=tp, hyper=th, engine="async",
                      schedule=schedule, metrics_every=5, device="cpu"))
    np.testing.assert_allclose(got.history["gap_sq"],
                               scan.history["gap_sq"], rtol=2e-5)
    for a, b in zip(tree_leaves(got.state), tree_leaves(scan.state)):
        np.testing.assert_allclose(_np(a), _np(b), **REPLAY)
    assert got.arrivals.n_iterations == 20


# ---------------------------------------------------------------------------
# bitwise inside the port
# ---------------------------------------------------------------------------

def test_streamed_live_run_replays_bitwise_and_through_scan():
    tp, th = problems.build("quadratic", n_workers=4, device="cpu")
    strm = problems.build_stream("quadratic", n_workers=4)
    live = run_async(tp, th, n_iterations=20, metrics_every=5, data=strm,
                     device="cpu")
    assert live.arrivals.n_iterations == 20
    assert int(live.arrivals.max_staleness.max()) <= th.tau
    echo = run_async(tp, th, replay=live.arrivals, metrics_every=5,
                     data=strm, device="cpu")
    np.testing.assert_array_equal(echo.history["gap_sq"],
                                  live.history["gap_sq"])
    assert_bitwise(echo.state, live.state)
    np.testing.assert_array_equal(echo.arrivals.active, live.arrivals.active)
    scan = run_scanned(tp, th, live.arrivals, metrics_every=5, data=strm)
    np.testing.assert_allclose(live.history["gap_sq"],
                               scan.history["gap_sq"], rtol=1e-5)


def test_policy_adapted_run_replays_bitwise():
    tp, th = problems.build("quadratic", n_workers=4, device="cpu")
    live = run_async(tp, th, n_iterations=20, metrics_every=5,
                     policy=ArrivalPolicy(s_active=th.s_active, tau=th.tau),
                     device="cpu")
    sched = live.arrivals
    assert sched.s_eff is not None and (sched.s_eff >= 1).all()
    assert ((1 <= sched.tau_eff) & (sched.tau_eff <= th.tau)).all()
    assert int(sched.max_staleness.max()) <= th.tau
    echo = run_async(tp, th, replay=sched, metrics_every=5, device="cpu")
    np.testing.assert_array_equal(echo.history["gap_sq"],
                                  live.history["gap_sq"])
    assert_bitwise(echo.state, live.state)
    np.testing.assert_array_equal(echo.arrivals.s_eff, sched.s_eff)
    np.testing.assert_array_equal(echo.arrivals.tau_eff, sched.tau_eff)
    # the engines take a recorded schedule, audit columns and all
    whole = run_scanned(tp, th, sched, metrics_every=5)
    chunked = run_chunked(tp, th, sched, 7, metrics_every=5)
    assert_bitwise(chunked.state, whole.state)
    np.testing.assert_allclose(whole.history["gap_sq"],
                               live.history["gap_sq"], rtol=2e-5)


def test_async_validation_errors():
    tp, th = problems.build("quadratic", n_workers=4, device="cpu")
    from repro_torch.data import stream as stream_lib
    bad = stream_lib.problem_stream(tp.data, 5)
    with pytest.raises(ValueError, match="workers"):
        run_async(tp, th, n_iterations=2, data=bad, device="cpu")
    (wide,) = make_schedules(3, seeds=(0,), n_workers=5, s_active=3)
    with pytest.raises(ValueError, match="replay schedule has 5"):
        run_async(tp, th, replay=wide, device="cpu")
    spec = RunSpec(problem=tp, hyper=th, n_iterations=2, device="cpu",
                   transport=InProcTransport(4))
    with pytest.raises(ValueError, match="transport"):
        run(spec)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_rebuilds_identically_and_rows_are_stable():
    p1, h1 = problems.build("quadratic", n_workers=3, dim=4, seed=4,
                            device="cpu")
    p2, h2 = problems.build("quadratic", n_workers=3, dim=4, seed=4,
                            device="cpu")
    p5, _ = problems.build("quadratic", n_workers=5, dim=4, seed=4,
                           device="cpu")
    for k in p1.data:
        assert torch.equal(p1.data[k], p2.data[k])
        assert torch.equal(p1.data[k], p5.data[k][:3])
    assert h1 == h2
    jp, jh = jax_problems.build("quadratic", n_workers=3, dim=4, seed=4)
    want = dataclasses.asdict(jh)
    assert {k: v for k, v in dataclasses.asdict(h1).items()
            if k in want} == want
    with pytest.raises(KeyError, match="unknown problem"):
        problems.build("no-such-problem", device="cpu")
    with pytest.raises(KeyError, match="no registered stream"):
        problems.build_stream("no-such-problem")
    # the stream's rows are keyed on (iteration, global worker index)
    s4 = problems.build_stream("quadratic", n_workers=4)
    full = worker_lib.stream_lib.next_batch(s4, 3, device="cpu")
    row = worker_lib.stream_lib.batch_at(s4.spec, s4.key, 3,
                                         worker_offset=2, n_local=1,
                                         device="cpu")
    assert torch.equal(tree_index(full, 2)["A"], row["A"][0])


def test_registry_problem_carries_reference_data():
    jp, jh, tp, th = _ref_quadratic(n=3, dim=2, seed=5)
    for k in jp.data:
        np.testing.assert_array_equal(_np(tp.data[k]), np.asarray(jp.data[k]))
    st = afto.init_state(tp, th)
    assert int(st.stale.t_hat.shape[0]) == 3
