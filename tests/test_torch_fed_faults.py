"""The port's fault-tolerant, elastic federation runtime on the CPU.

  * Membership: the failure detector's transitions, and the resharding
    operators (`make_views` / `assemble_state` / `reshard_state`) and
    growth (`grow_state` / `cuts.grow_cuts`) as bitwise identities, as
    the reference holds them (tests/test_membership.py:292-400).
  * Transports: the TCP handshake, its bounded accept, DISCONNECT frames
    for broken connections and rejoins over a new socket.
  * Chaos: a lossy network and a scripted crash with rejoin complete,
    and their recorded schedules replay through the runtime bit for bit.
  * Kill / resume: a master resumed from its checkpoint ends bitwise
    where the uninterrupted run ends.
  * Elastic: a run that admits a late worker replays bit for bit through
    `run_scanned_elastic` and through the runtime.
  * Mixed federations over TCP on localhost: a port master with
    reference workers, and a reference master with port workers,
    replaying one schedule, held to the all-reference run at the replay
    tolerances (tests/test_runtime.py:311-315).

Every wait is bounded: thread joins with a timeout followed by an
assert that the thread is gone, TCP accepts with a timeout, and fault
deadlines of seconds.
"""
import dataclasses
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from conftest import make_schedules
from repro.fed.runtime import problems as jax_problems
from repro.fed.runtime import run_async as jax_run_async
from repro.fed.runtime import transport as jax_transport
from repro.fed.runtime import worker as jax_worker
from repro_torch import convert
from repro_torch.checkpoint import CheckpointError
from repro_torch.core import afto, cuts, run_scanned
from repro_torch.fed.runtime import (ChaosScript, FaultConfig, Master,
                                     Membership, TcpTransport,
                                     assemble_state, decode, encode,
                                     make_views, reshard_state, run_async,
                                     run_chaos_async)
from repro_torch.fed.runtime import messages as msg_lib
from repro_torch.fed.runtime import problems
from repro_torch.fed.runtime import transport as transport_lib
from repro_torch.fed.runtime import worker as worker_lib
from repro_torch.fed.runtime.chaos import ChaosMasterEndpoint
from repro_torch.fed.runtime.membership import grow_state, run_scanned_elastic
from test_torch_runtime import assert_bitwise, assert_state_matches_reference

# deadlines of seconds: a loaded box delays a heartbeat, it does not
# lose a worker
FAULT = FaultConfig(heartbeat_every=0.05, resend_every=0.2,
                    refresh_resend_every=0.2, death_timeout=5.0,
                    poll_interval=0.005, all_dead_timeout=20.0,
                    stop_timeout=10.0)
JOIN_S = 30.0


def _quad(n=4):
    return problems.build("quadratic", n_workers=n, device="cpu")


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)


# ---------------------------------------------------------------------------
# membership
# ---------------------------------------------------------------------------

def test_membership_liveness_sessions_and_growth():
    now = [0.0]
    m = Membership(3, FaultConfig(death_timeout=1.0), clock=lambda: now[0])
    assert m.disconnect(1) and not m.disconnect(1) and m.deaths == 1
    assert m.saw(1) and m.rejoins == 1
    now[0] = 2.0
    m.saw(0)
    assert m.overdue() == [1, 2]
    assert m.hello(2, 1) and int(m.epoch[2]) == 1
    assert m.fresh_push(2, 1, 1) and not m.fresh_push(2, 0, 5)
    m.consumed(2, 1)
    assert not m.fresh_push(2, 1, 1)
    assert m.observe_epoch(2, 2) and int(m.consumed_seq[2]) == 0
    m.grow(5)
    assert m.n == 5 and not m.alive[3:].any()
    m.admit(4, 0)
    assert m.alive[4] and m.n_live == 4
    with pytest.raises(ValueError, match="grows"):
        m.grow(4)
    back = Membership(1)
    back.load_state_dict(m.state_dict())
    assert back.n == 5 and list(back.epoch) == list(m.epoch)
    assert len(m.status()) == 5


def _stepped_state(n=4, iters=12, seed=0):
    tp, th = _quad(n)
    (sched,) = make_schedules(iters, seeds=(seed,), n_workers=n,
                              s_active=max(1, n - 1))
    return tp, th, run_scanned(tp, th, sched, metrics_every=iters).state


def test_views_assemble_and_reshard_are_bitwise_identities():
    _, _, state = _stepped_state()
    assert float(state.cuts_ii.active.sum()) > 0
    for n_shards in (1, 2, 4):
        views = make_views(state, n_shards)
        assert [v.index for v in views] == list(range(n_shards))
        assert_bitwise(assemble_state(state, views), state)
    for n_old, n_new in ((2, 4), (4, 2), (1, 4), (4, 1)):
        assert_bitwise(reshard_state(state, n_old, n_new), state)
    with pytest.raises(ValueError, match="partition"):
        make_views(state, 3)
    views = make_views(state, 4)
    with pytest.raises(ValueError, match="complete"):
        assemble_state(state, views[:3])


def test_grow_state_pads_exactly_and_continues_as_the_wider_run():
    p3, h3 = _quad(3)
    p5, h5 = _quad(5)
    grown = grow_state(afto.init_state(p3, h3), 5)
    fresh = afto.init_state(p5, h5)
    assert grown.cuts_ii.spec == fresh.cuts_ii.spec
    assert_bitwise(grown, fresh)
    (sched,) = make_schedules(10, seeds=(3,), n_workers=5)
    assert_bitwise(run_scanned(p5, h5, sched, state=grown).state,
                   run_scanned(p5, h5, sched, state=fresh).state)
    # a populated polytope: a-columns and old b-columns kept, new zero
    _, _, state = _stepped_state(3, 12, 2)
    g = grow_state(state, 5)
    assert torch.equal(g.X1[:3], state.X1) and not g.X1[3:].any()
    assert (g.stale.t_hat[3:] == int(state.t)).all()
    with pytest.raises(ValueError, match="grows"):
        grow_state(state, 2)
    assert grow_state(state, 3) is state
    na = cuts.n_a_leaves(state.cuts_ii.spec)
    spec, gspec = state.cuts_ii.spec, g.cuts_ii.spec
    for i in range(len(spec.sizes)):
        old = state.cuts_ii.a[:, spec.offsets[i]:spec.offsets[i]
                              + spec.sizes[i]]
        new = g.cuts_ii.a[:, gspec.offsets[i]:gspec.offsets[i]
                          + gspec.sizes[i]]
        if i < na:
            assert torch.equal(old, new)
        else:
            p = old.shape[0]
            new = new.reshape(p, 5, -1)
            assert torch.equal(new[:, :3], old.reshape(p, 3, -1))
            assert not new[:, 3:].any()


# ---------------------------------------------------------------------------
# the TCP transport
# ---------------------------------------------------------------------------

def test_tcp_handshake_accept_timeout_and_garbage_probes():
    import socket as socket_lib
    hub = TcpTransport(2, port=0)
    me = hub.master_endpoint()
    conns = []
    try:
        probe = socket_lib.create_connection(("127.0.0.1", hub.port))
        probe.sendall(b"\x00\x00\x00\x04junk")
        conns.append(TcpTransport.connect("127.0.0.1", hub.port, 0))
        with pytest.raises(TimeoutError, match=r"missing \[1\]"):
            me.wait_for_workers(timeout=0.5)
        conns.append(TcpTransport.connect("127.0.0.1", hub.port, 1))
        me.wait_for_workers(timeout=10.0)
        assert sorted(me._socks) == [0, 1]
        conns[1].send(encode(msg_lib.heartbeat(1)))
        got = decode(me.recv(timeout=5.0))
        assert got.kind == msg_lib.HEARTBEAT and got.meta["worker"] == 1
        me.send(0, encode(msg_lib.stop()))
        assert decode(conns[0].recv(timeout=5.0)).kind == msg_lib.STOP
        assert conns[1].recv(timeout=0.05) is None
        probe.close()
    finally:
        for c in conns:
            c.close()
        me.close()


def test_tcp_disconnect_frames_and_rejoin_on_a_new_socket():
    hub = TcpTransport(1, port=0)
    me = hub.master_endpoint()
    try:
        c = TcpTransport.connect("127.0.0.1", hub.port, 0)
        me.wait_for_workers(timeout=10.0)
        for k in range(1, 4):
            c.close()
            got = decode(me.recv(timeout=5.0))
            assert got.kind == msg_lib.DISCONNECT and got.meta["worker"] == 0
            c = TcpTransport.connect("127.0.0.1", hub.port, 0, epoch=k)
            got = decode(me.recv(timeout=5.0))
            assert got.kind == msg_lib.HELLO and got.meta["epoch"] == k
        me.send(0, encode(msg_lib.stop()))
        assert decode(c.recv(timeout=5.0)).kind == msg_lib.STOP
        assert len(me._threads) <= 4
        c.close()
    finally:
        me.close()


def test_tcp_master_refuses_workers_after_close():
    """A closed master stops listening: a worker that (re)connects after
    the run is refused, not accepted by a still-blocked accept thread
    and left waiting for rows forever."""
    hub = TcpTransport(1, port=0)
    me = hub.master_endpoint()
    c = TcpTransport.connect("127.0.0.1", hub.port, 0)
    me.wait_for_workers(timeout=10.0)
    me.close()
    c.close()
    with pytest.raises(OSError):
        late = TcpTransport.connect("127.0.0.1", hub.port, 0, epoch=1)
        late.close()


# ---------------------------------------------------------------------------
# chaos, kill / resume, elastic admission
# ---------------------------------------------------------------------------

def test_lossy_network_completes_and_replays_bitwise():
    tp, th = _quad()
    script = ChaosScript(seed=3, drop_p=0.10, dup_p=0.10, delay_p=0.15,
                         delay_s=0.002, cut_p=0.05)
    res = run_chaos_async(tp, th, script, n_iterations=16, fault=FAULT,
                          metrics_every=4, device="cpu")
    rec = res.arrivals
    assert rec.n_iterations == 16
    assert int(rec.max_staleness.max()) <= th.tau
    echo = run_async(tp, th, replay=rec, metrics_every=4, device="cpu")
    assert_bitwise(echo.state, res.state)
    np.testing.assert_array_equal(echo.history["gap_sq"],
                                  res.history["gap_sq"])
    scan = run_scanned(tp, th, rec, metrics_every=4)
    np.testing.assert_allclose(scan.history["gap_sq"],
                               res.history["gap_sq"], rtol=2e-5)


def test_crash_death_rejoin_and_bitwise_replay():
    tp, th = _quad()
    script = ChaosScript(seed=11, crash_at_push=((1, 3),))
    paced = dataclasses.replace(FAULT, min_iter_time=0.03)
    captured = {}
    res = run_chaos_async(tp, th, script, n_iterations=30, fault=paced,
                          restart_delay=0.15, metrics_every=5,
                          master_hook=lambda m: captured.update(m=m),
                          device="cpu")
    master = captured["m"]
    assert master.status["deaths"] >= 1 and master.status["rejoins"] >= 1
    rec = res.arrivals
    assert rec.dead[:, 1].max() == 1.0 and rec.dead[-1].sum() == 0.0
    assert int(rec.max_staleness.max()) <= th.tau
    echo = run_async(tp, th, replay=rec, metrics_every=5, device="cpu")
    assert_bitwise(echo.state, res.state)
    np.testing.assert_array_equal(echo.history["gap_sq"],
                                  res.history["gap_sq"])


def test_cut_stop_frames_are_resent_until_workers_leave():
    tp, th = _quad()
    script = ChaosScript(seed=0, stop_cut_p=0.7)
    assert all(script.stop_cut(j, 0) for j in range(4))
    hub = transport_lib.InProcTransport(4)
    threads = [threading.Thread(
        target=worker_lib.worker_loop, args=(tp, j, hub.worker_endpoint(j)),
        kwargs={"fault": FAULT, "device": "cpu"}, daemon=True)
        for j in range(4)]
    for t in threads:
        t.start()
    master = Master(tp, th, ChaosMasterEndpoint(hub.master_endpoint(),
                                                script),
                    n_iterations=6, metrics_every=3, fault=FAULT,
                    device="cpu")
    assert master.run().arrivals.n_iterations == 6
    _join(threads)


def test_master_kill_and_resume_is_bitwise(tmp_path):
    tp, th = _quad()
    (sched,) = make_schedules(20, seeds=(0,))
    ckpt = os.fspath(tmp_path / "master")
    full = run_async(tp, th, replay=sched, metrics_every=5, device="cpu")
    run_async(tp, th, replay=sched.slice(0, 10), metrics_every=5,
              ckpt_dir=ckpt, ckpt_every=5, device="cpu")
    assert sorted(os.listdir(ckpt))[-1] == "step_00000010"
    res = run_async(tp, th, replay=sched, metrics_every=5, ckpt_dir=ckpt,
                    resume=True, device="cpu")
    assert_bitwise(res.state, full.state)
    for k, v in full.history.items():
        if k != "host_time":
            np.testing.assert_array_equal(res.history[k], v)
    np.testing.assert_array_equal(res.arrivals.active, full.arrivals.active)
    with pytest.raises(CheckpointError, match="no checkpoints"):
        run_async(tp, th, replay=sched, device="cpu",
                  ckpt_dir=os.fspath(tmp_path / "empty"), resume=True)


class _SlowFirstPush(transport_lib.InProcTransport):
    """In-process transport whose workers hold their first push back."""

    def worker_endpoint(self, worker):
        inner = super().worker_endpoint(worker)
        state = {"held": False}

        class Endpoint(transport_lib.WorkerEndpoint):
            def recv(self, timeout=None):
                return inner.recv(timeout)

            def send(self, frame):
                if msg_lib.peek_kind(frame) == msg_lib.PUSH \
                        and not state["held"]:
                    state["held"] = True
                    time.sleep(0.3)
                inner.send(frame)

            def close(self):
                inner.close()

        return Endpoint()


def test_resume_takes_fresh_pushes_and_does_not_livelock(tmp_path):
    """A checkpoint holds pushes of sessions that are gone.  Consuming one
    before the new session's first push (at the same replayed rows)
    arrives used to leave the worker's consumed counter at the old
    session's seq, so every later push read as a duplicate and the run
    livelocked.  The resumed master starts with no pending push, and the
    resumed run completes, bitwise, even with every first push held
    back; the master runs on a thread joined with a timeout."""
    from repro_torch.checkpoint import load_array_dict

    tp, th = _quad()
    (sched,) = make_schedules(16, seeds=(4,))
    ckpt = os.fspath(tmp_path / "master")
    full = run_async(tp, th, replay=sched, metrics_every=4, device="cpu")
    run_async(tp, th, replay=sched.slice(0, 8), metrics_every=4,
              ckpt_dir=ckpt, ckpt_every=8, device="cpu")
    assert (load_array_dict(ckpt)["pending_seq"] > 0).any()
    out = {}

    def resume():
        out["res"] = run_async(tp, th, replay=sched, metrics_every=4,
                               ckpt_dir=ckpt, resume=True,
                               transport=_SlowFirstPush(4), device="cpu",
                               master_hook=lambda m: out.update(
                                   pending=dict(m.pending)))

    t = threading.Thread(target=resume, daemon=True)
    t.start()
    t.join(timeout=60.0)
    assert not t.is_alive(), "the resumed master did not finish"
    assert out["pending"] == {}
    assert_bitwise(out["res"].state, full.state)


def test_elastic_admission_widens_and_replays_bitwise():
    elastic = problems.elastic_config("quadratic", 4, device="cpu")
    tp, th = _quad(3)
    paced = dataclasses.replace(FAULT, min_iter_time=0.02)
    res = run_chaos_async(tp, th, ChaosScript(), n_iterations=16,
                          metrics_every=8, fault=paced, elastic=elastic,
                          admit_at=((3, 0.1),), device="cpu")
    rec = res.arrivals
    assert rec.width is not None
    assert int(rec.width[0]) == 3 and int(rec.width[-1]) == 4
    assert float(rec.active[:, 3].sum()) > 0
    echo = run_scanned_elastic(elastic.build, rec, metrics_every=8)
    np.testing.assert_array_equal(echo.history["gap_sq"],
                                  res.history["gap_sq"])
    assert_bitwise(echo.state, res.state)
    again = run_async(tp, th, n_iterations=16, replay=rec, fault=FAULT,
                      elastic=elastic, metrics_every=8, device="cpu")
    assert_bitwise(again.state, res.state)
    # the grown run's checkpoint restores into a launch-width master
    fixed = run_async(tp, th, n_iterations=4, metrics_every=2,
                      elastic=problems.elastic_config("quadratic", 6,
                                                      device="cpu"),
                      replay=make_schedules(4, seeds=(1,), n_workers=3,
                                            s_active=2)[0],
                      device="cpu")
    assert fixed.arrivals.width is None


# ---------------------------------------------------------------------------
# mixed federations over TCP
# ---------------------------------------------------------------------------

def _tcp_workers(loop, problem, connect, port, n, **kw):
    threads = [threading.Thread(
        target=loop, args=(problem, j, connect("127.0.0.1", port, j)),
        kwargs=kw, daemon=True) for j in range(n)]
    for t in threads:
        t.start()
    return threads


@pytest.mark.parametrize("master", ["port", "reference"])
def test_mixed_federation_over_tcp_matches_the_reference(master):
    jp, jh = jax_problems.build("quadratic", n_workers=4)
    tp, th = convert.registry_problem(
        "quadratic", jax.tree.map(np.asarray, jp.data), 4)
    (sched,) = make_schedules(16, seeds=(0,))
    want = jax_run_async(jp, jh, replay=sched, metrics_every=4)
    if master == "port":
        hub = TcpTransport(4, port=0)
        hub.master_endpoint()
        threads = _tcp_workers(jax_worker.worker_loop, jp,
                               jax_transport.TcpTransport.connect,
                               hub.port, 4)
        got = run_async(tp, th, replay=sched, metrics_every=4,
                        transport=hub, accept_timeout=60.0, device="cpu")
        state = got.state
    else:
        hub = jax_transport.TcpTransport(4, port=0)
        hub.master_endpoint()
        threads = _tcp_workers(worker_lib.worker_loop, tp,
                               TcpTransport.connect, hub.port, 4,
                               device="cpu")
        got = jax_run_async(jp, jh, replay=sched, metrics_every=4,
                            transport=hub, accept_timeout=60.0)
        state = jax.tree.map(np.asarray, got.state)
    _join(threads)
    np.testing.assert_allclose(np.asarray(got.history["gap_sq"]),
                               want.history["gap_sq"], rtol=2e-5)
    if master == "port":
        assert_state_matches_reference(state, want.state, rtol=2e-5,
                                       atol=1e-6)
    else:
        for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(want.state)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=2e-5,
                                       atol=1e-6)
    np.testing.assert_array_equal(got.arrivals.active, sched.active)
