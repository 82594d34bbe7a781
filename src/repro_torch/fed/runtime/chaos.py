"""Chaos-injection transport: seeded, scriptable, fully deterministic.

Counterpart of `repro/fed/runtime/chaos.py`.

`ChaosScript` describes a fault program; `ChaosMasterEndpoint` /
`ChaosWorkerEndpoint` wrap ANY transport endpoint and apply it to
outgoing frames:

  drop       the frame is never delivered
  dup        the frame is delivered twice
  delay      the sender sleeps `delay_s` before delivering
  cut        the frame is truncated mid-frame (the receiver sees a
             corrupt frame it cannot decode — the queue-transport
             analogue of a connection dying mid-write)
  crash      the worker raises `ChaosCrash` INSTEAD of sending its
             n-th push — a scripted process death at a known point

Every decision is a pure function of (seed, role, worker, frame index)
through an independent counter-keyed PRNG stream, so a chaos run's
fault sequence is exactly reproducible — every failure path is a
replayable test, not a flake.  STOP frames are exempt from the run
faults (chaos targets the run, not the shutdown handshake) but get
their own seeded stream: `stop_cut_p` truncates the master's n-th STOP
to a given worker mid-frame — the fault that pins the master's
STOP-resend shutdown drain (a worker whose only STOP is lost would
otherwise spin forever; STOP has no worker-side retransmit to heal it).

`run_chaos_async` is the harness: an in-process master/worker
population where every endpoint is chaos-wrapped and each worker runs
under a supervisor thread that catches `ChaosCrash`, waits
`restart_delay`, and restarts the worker with a bumped resume epoch —
the full crash/rejoin cycle, deterministically scripted.  The recorded
arrival `Schedule` (with its degradation `dead` mask) replays
bit-exactly through `run_scanned` and through a fresh
`Master(replay=...)` — `tests/test_torch_fed_faults.py` pins both.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.fed.runtime import messages as msg_lib
from repro_torch.fed.runtime import transport as transport_lib
from repro_torch.fed.runtime.membership import FaultConfig


class ChaosCrash(RuntimeError):
    """Scripted worker death (raised instead of sending a push)."""

    def __init__(self, worker: int, push_seq: int):
        super().__init__(f"scripted crash: worker {worker} at "
                         f"push {push_seq}")
        self.worker, self.push_seq = worker, push_seq


_ROLE_MASTER, _ROLE_WORKER, _ROLE_STOP = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class ChaosScript:
    """A seeded fault program.  Probabilities are per outgoing frame;
    `crash_at_push` maps worker id -> the push SEQUENCE NUMBER at which
    that worker's FIRST session dies — triggered on the first
    transmission of that seq (retransmits of earlier pushes don't
    count), and only in the armed epoch-0 session, so every scripted
    crash happens exactly once."""
    seed: int = 0
    drop_p: float = 0.0
    dup_p: float = 0.0
    delay_p: float = 0.0
    delay_s: float = 0.005
    cut_p: float = 0.0
    stop_cut_p: float = 0.0     # per-STOP mid-frame truncation
    crash_at_push: Tuple[Tuple[int, int], ...] = ()

    def crash_point(self, worker: int) -> Optional[int]:
        for w, seq in self.crash_at_push:
            if int(w) == int(worker):
                return int(seq)
        return None

    def draw(self, role: int, worker: int, k: int) -> Dict[str, bool]:
        """The (deterministic) fault decisions for frame `k` of
        (role, worker)'s outgoing stream."""
        u = np.random.default_rng(
            (self.seed, role, int(worker), int(k))).random(4)
        return {"drop": bool(u[0] < self.drop_p),
                "dup": bool(u[1] < self.dup_p),
                "delay": bool(u[2] < self.delay_p),
                "cut": bool(u[3] < self.cut_p)}

    def stop_cut(self, worker: int, k: int) -> bool:
        """Deterministic: is the master's k-th STOP to `worker` cut?"""
        u = np.random.default_rng(
            (self.seed, _ROLE_STOP, int(worker), int(k))).random(1)
        return bool(u[0] < self.stop_cut_p)


def _apply_faults(deliver, frame: bytes, faults: Dict[str, bool],
                  delay_s: float) -> None:
    """Deliver `frame` through the scripted faults (drop wins over dup;
    cut truncates the frame so the receiver's decode fails)."""
    if faults["delay"]:
        time.sleep(delay_s)
    if faults["drop"]:
        return
    if faults["cut"]:
        deliver(frame[:max(1, len(frame) // 2)])
        return
    deliver(frame)
    if faults["dup"]:
        deliver(frame)


class ChaosMasterEndpoint(transport_lib.MasterEndpoint):
    """Wraps a master endpoint; outgoing refreshes run the script."""

    def __init__(self, inner: transport_lib.MasterEndpoint,
                 script: ChaosScript):
        self.inner, self.script = inner, script
        self._sent: Dict[int, int] = {}
        self._stops: Dict[int, int] = {}

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        return self.inner.recv(timeout)

    def send(self, worker: int, frame: bytes) -> None:
        if msg_lib.peek_kind(frame) == msg_lib.STOP:
            k = self._stops.get(worker, 0)
            self._stops[worker] = k + 1
            if self.script.stop_cut(worker, k):
                self.inner.send(worker, frame[:max(1, len(frame) // 2)])
            else:
                self.inner.send(worker, frame)
            return
        k = self._sent.get(worker, 0)
        self._sent[worker] = k + 1
        _apply_faults(lambda f: self.inner.send(worker, f), frame,
                      self.script.draw(_ROLE_MASTER, worker, k),
                      self.script.delay_s)

    def close(self) -> None:
        self.inner.close()


class ChaosWorkerEndpoint(transport_lib.WorkerEndpoint):
    """Wraps a worker endpoint; outgoing pushes/heartbeats run the
    script, and the scripted crash point raises instead of sending."""

    def __init__(self, inner: transport_lib.WorkerEndpoint, worker: int,
                 script: ChaosScript, armed: bool = True):
        self.inner, self.worker, self.script = inner, worker, script
        self.armed = armed          # False for restarted (clean) sessions
        self._sent = 0

    def recv(self, timeout: Optional[float] = None) -> Optional[bytes]:
        return self.inner.recv(timeout)

    def send(self, frame: bytes) -> None:
        kind = msg_lib.peek_kind(frame)
        if kind == msg_lib.PUSH and self.armed:
            crash = self.script.crash_point(self.worker)
            seq = int((msg_lib.peek_meta(frame) or {}).get("n_pushes", 0))
            if crash is not None and seq == crash:
                raise ChaosCrash(self.worker, seq)
        k = self._sent
        self._sent += 1
        _apply_faults(self.inner.send, frame,
                      self.script.draw(_ROLE_WORKER, self.worker, k),
                      self.script.delay_s)

    def close(self) -> None:
        self.inner.close()


# ---------------------------------------------------------------------------
# the deterministic chaos harness
# ---------------------------------------------------------------------------

def run_chaos_async(problem, hyper, script: ChaosScript,
                    n_iterations: int = 50,
                    fault: Optional[FaultConfig] = None,
                    restart_delay: float = 0.1,
                    metrics_every: int = 10,
                    replay=None,
                    master_hook=None,
                    elastic=None,
                    admit_at: Tuple[Tuple[int, float], ...] = (),
                    device=None):
    """Run the async runtime with every endpoint chaos-wrapped and
    crashed workers supervised back to life (bumped resume epoch).

    `elastic` (an `ElasticConfig`) + `admit_at` — pairs of
    (worker id, spawn delay seconds) — additionally inject LATE workers:
    each is spawned after its delay in admit mode against a problem
    built at (id + 1) workers, goes through the real ADMIT/WELCOME
    boundary, and is supervised like any other worker (a crashed
    newcomer re-ADMITs with a bumped epoch).

    Returns the master's `RunResult`; `result.arrivals` carries the
    degraded (and possibly widened) Schedule that must replay exactly
    through `run_scanned` / `Master(replay=...)`.  The master and the
    worker threads run on `device` (the CUDA card unless named); a
    thread still running `master.JOIN_TIMEOUT` seconds after the run is
    an error.
    """
    from repro_torch.fed.runtime import worker as worker_lib
    from repro_torch.fed.runtime.master import Master, join_workers
    from repro_torch.utils.device import resolve_device

    device = resolve_device(device)

    fault = fault or FaultConfig(
        heartbeat_every=0.02, resend_every=0.1, refresh_resend_every=0.1,
        death_timeout=0.5, poll_interval=0.005, all_dead_timeout=10.0)
    n = hyper.n_workers
    hub = transport_lib.InProcTransport(n)
    stop_flag = threading.Event()

    def supervise(j: int, wp=None, admit: bool = False,
                  delay: float = 0.0) -> None:
        if delay > 0:
            time.sleep(delay)
        epoch = 0
        while not stop_flag.is_set():
            ep = ChaosWorkerEndpoint(hub.worker_endpoint(j), j, script,
                                     armed=(epoch == 0))
            try:
                worker_lib.worker_loop(wp if wp is not None else problem,
                                       j, ep, epoch=epoch,
                                       fault=fault, admit=admit,
                                       device=device)
                return                     # clean STOP
            except ChaosCrash:
                # the crash kills the session: surface a DISCONNECT the
                # way a TCP reader thread would, then resurrect after
                # the scripted delay with a bumped resume epoch
                hub.to_master.put(msg_lib.encode(msg_lib.disconnect(j)))
                time.sleep(restart_delay)
                epoch += 1

    threads = [threading.Thread(target=supervise, args=(j,), daemon=True)
               for j in range(n)]
    worker_ids = list(range(n))
    for j, delay in admit_at:
        assert elastic is not None, "admit_at needs an ElasticConfig"
        wp, _ = elastic.build(int(j) + 1)
        threads.append(threading.Thread(
            target=supervise, args=(int(j), wp, True, float(delay)),
            daemon=True))
        worker_ids.append(int(j))
    for t in threads:
        t.start()

    endpoint = ChaosMasterEndpoint(hub.master_endpoint(), script)
    master = Master(problem, hyper, endpoint, n_iterations,
                    metrics_every=metrics_every, replay=replay,
                    fault=fault, elastic=elastic, device=device)
    if master_hook is not None:
        master_hook(master)
    ok = False
    try:
        result = master.run()
        ok = True
    finally:
        stop_flag.set()
        if not ok:
            # unfaulted STOPs straight into the mailboxes so supervised
            # workers exit even when the master errored out mid-run (a
            # CLEAN run must not get this rescue — the master's own
            # STOP-resend shutdown drain is the tested dismissal path)
            for j in worker_ids:
                hub._ensure_queue(j)
                hub.to_worker[j].put(msg_lib.encode(msg_lib.stop()))
        endpoint.close()
    join_workers(threads)
    return result
