"""The master endpoint: bounded-staleness arrival rule + step loop.

Counterpart of `repro/fed/runtime/master.py`; the state and every step
live on the master's device (the CUDA card unless named), where the
cut kernels run in the step, the refresh and the gap.

The master owns the canonical state — the `FlatCuts` polytopes, the z
variables, the duals, and every worker's last-consumed local point.
Workers own nothing but their data shard and the gradient they are
currently computing.  One master iteration:

  1. ARRIVE.  Block until the paper's arrival rule is satisfied: at
     least `hyper.s_active` worker pushes pending AND every tau-forced
     worker (staleness about to exceed `hyper.tau`) has arrived; then
     drain anything else already in flight (the scheduler's "extra
     workers finished by t_done" rule) and consume ALL pending pushes.
     In replay mode the master instead waits for — and consumes exactly
     — the workers of `replay.active[t]`, which makes the run
     deterministic on a deterministic transport.
  2. STEP.  Zero-fill the inactive gradient rows (exact: the Eq. 16
     update masks them out bitwise) and apply
     `afto_step_from_grads` — the stale-dual cut corrections, the
     masked worker updates, the master Gauss-Seidel z updates, and the
     dual ascent, all at the master's consumption-time polytope.
  3. REFRESH.  Every `t_pre` iterations (t < t1) generate the mu-cuts
     (`cut_refresh`) — master-side, exactly as in the scanned engine.
  4. REPLY.  Send each consumed worker its refreshed local point
     (x1_j, x2_j, x3_j).  Worker rows change only at the worker's own
     consumption, so each worker's local copy stays exactly in sync
     with the master's row between its activations — the property that
     makes the push-gradients / pull-rows decomposition reproduce the
     single-process trajectory.

Fault tolerance wraps the loop without touching the math:

  - FAILURE DETECTION.  Every frame from worker j refreshes its
    liveness clock (`membership.Membership`); a transport DISCONNECT or
    silence past `FaultConfig.death_timeout` declares it dead — removed
    from the tau-forced set, pending rows dropped (zero-filled rows are
    exact), effective S shrinks to the live population, and the
    degradation is recorded in the Schedule's `dead` mask, so the
    degraded trajectory still replays exactly through `run_scanned`.
  - RETRY/RECONNECT.  Pushes carry (epoch, seq); duplicates and
    dead-session frames are exact no-ops, a current-session duplicate
    seq retransmits the lost refresh, and a re-HELLO with a bumped
    resume epoch replays the worker's last consumed local point — a
    rejoined worker is bit-identical to one that never left.
  - DURABLE STATE.  `ckpt_every` arrivals, the WHOLE canonical carry
    (state + recorder + pending map + per-worker epochs + history) is
    written through `checkpoint/io.py` array dicts; `restore()` resumes
    it bitwise (`serve fed --resume`).

The live arrival process is recorded per iteration
(`ArrivalRecorder`) and returned as `RunResult.arrivals` — a
`Schedule` replayable through `run_scanned` or through this master.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import afto as afto_lib
from repro_torch.core import engine as engine_lib
from repro_torch.core.engine import RunResult, _check_stream, record_slots
from repro_torch.core.scheduler import (ArrivalPolicy, ArrivalRecorder,
                                        Schedule, validate_arrival_params)
from repro_torch.core.types import AFTOState, Hyper, TrilevelProblem
from repro_torch.data import stream as stream_lib
from repro_torch.data.stream import Stream
from repro_torch.fed.runtime import messages as msg_lib
from repro_torch.fed.runtime import transport as transport_lib
from repro_torch.fed.runtime.membership import (ElasticConfig, FaultConfig,
                                                Membership, grow_state)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import (tree_flatten, tree_index, tree_leaves,
                                    tree_map, tree_unflatten)


def _zero_stack(template_stack):
    """Host zeros shaped like a stacked tree of tensors."""
    return tree_map(lambda x: np.zeros(
        tuple(x.shape), torch.empty(0, dtype=x.dtype).numpy().dtype),
        template_stack)


def _set_row(stack, j: int, row_tree) -> None:
    for dst, src in zip(tree_leaves(stack), tree_leaves(row_tree)):
        dst[j] = np.asarray(src)


class _Silence:
    """Fails a blocking wait once no frame at all (not even a heartbeat)
    has arrived for `limit` seconds: every worker is gone."""

    def __init__(self, limit: float, what: str):
        self.limit, self.what = float(limit), what
        self.last = time.monotonic()

    def __call__(self, frame):
        now = time.monotonic()
        if frame is not None:
            self.last = now
        elif now - self.last > self.limit:
            raise RuntimeError(
                f"no frame from any worker for {self.limit}s while "
                f"waiting for {self.what}")
        return frame


# seconds an in-process worker thread may take to leave after the run
JOIN_TIMEOUT = 30.0

_HIST_KEYS = ("t", "sim_time", "host_time", "gap_sq", "n_cuts_i",
              "n_cuts_ii", "max_staleness")


class Master:
    """Runs the async master loop over any `MasterEndpoint`."""

    def __init__(self, problem: TrilevelProblem, hyper: Hyper,
                 endpoint: transport_lib.MasterEndpoint,
                 n_iterations: int,
                 metrics_fn: Optional[Callable] = None,
                 metrics_every: int = 10,
                 state: Optional[AFTOState] = None,
                 replay: Optional[Schedule] = None,
                 fault: Optional[FaultConfig] = None,
                 ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 0,
                 stream: Optional[Stream] = None,
                 policy: Optional[ArrivalPolicy] = None,
                 elastic: Optional[ElasticConfig] = None,
                 device=None):
        if replay is not None and replay.n_workers != hyper.n_workers:
            # a WIDENING schedule replays from its initial width, the
            # elastic machinery growing the run at the recorded
            # boundaries; anything else is a plain mismatch
            widening = (replay.width is not None and elastic is not None
                        and int(replay.width[0]) == hyper.n_workers
                        and replay.n_workers <= elastic.max_workers)
            if not widening:
                raise ValueError(
                    f"replay schedule has {replay.n_workers} workers; "
                    f"hyper has {hyper.n_workers}")
        # the master is what deadlocks on a bad quorum: check here too
        validate_arrival_params(hyper.s_active, hyper.tau,
                                hyper.n_workers, what="Master")
        if stream is not None:
            _check_stream(stream, hyper)
        self.device = resolve_device(device)
        for leaf in tree_leaves((problem.x1_init, problem.data)):
            if leaf.device.type != self.device.type:
                raise ValueError(f"the problem lives on {leaf.device}, "
                                 f"the master on {self.device}")
        self.problem, self.hyper = problem, hyper
        self.stream, self.policy = stream, policy
        self.elastic = elastic
        self._admit: Dict[int, int] = {}   # pending ADMITs: worker -> epoch
        self.endpoint = endpoint
        self.n_iterations = (replay.n_iterations if replay is not None
                             else n_iterations)
        self.metrics_fn, self.metrics_every = metrics_fn, metrics_every
        self.state = state if state is not None else afto_lib.init_state(
            problem, hyper)
        self.replay = replay
        self.fault = fault or FaultConfig()
        self.ckpt_dir, self.ckpt_every = ckpt_dir, int(ckpt_every)
        n = hyper.n_workers
        self.recorder = ArrivalRecorder(n)
        self.members = Membership(n, self.fault)
        self._eff = (None, None)   # this iteration's effective (s, tau)
        self.pending: Dict[int, tuple] = {}   # worker -> (seq, grads)
        self.last_refresh_t = np.zeros(n, dtype=np.int64)
        self._last_tx = np.zeros(n, dtype=np.float64)  # refresh send times
        self.start_it = 0
        self.hist: Dict[str, List[float]] = {k: [] for k in _HIST_KEYS}
        self.status: Dict = {"t": 0, "n_iterations": self.n_iterations,
                             "gap_sq": None, "max_staleness": 0,
                             "pending": 0, "done": False, "deaths": 0,
                             "rejoins": 0, "corrupt_frames": 0,
                             "resumed_from": None,
                             "workers": self.members.status()}
        self._bind()
        self._row_templates = (problem.x1_init, problem.x2_init,
                               problem.x3_init)
        self._update_worker_status()

    def _bind(self) -> None:
        """(Re)bind the step / refresh / record closures to the CURRENT
        (problem, hyper): at construction and after every elastic
        growth.  The step never reads `problem.data` (the workers
        differentiated at their rows); the refresh and the gap take the
        streamed batch when there is one."""
        problem, hyper, metrics_fn = self.problem, self.hyper, \
            self.metrics_fn

        def with_data(d):
            return problem if d is None else dataclasses.replace(
                problem, data=d)

        self._step = lambda s, m, g: afto_lib.afto_step_from_grads(
            problem, hyper, s, m, g)
        self._cut_refresh = lambda s, d: afto_lib.cut_refresh(
            with_data(d), hyper, s)
        self._record = lambda s, d, aux: engine_lib.record(
            with_data(d), hyper, s, metrics_fn, aux=aux)

    # -- message plumbing ---------------------------------------------------

    def _consume_frame(self, frame: Optional[bytes]) -> None:
        if frame is None:
            return
        try:
            m = msg_lib.decode(frame)
        except Exception:
            # a chaos-cut / mid-frame-truncated frame: count it and let
            # the retransmit protocol recover the payload
            self.status["corrupt_frames"] += 1
            return
        n = self.hyper.n_workers
        j = int(m.meta.get("worker", -1))
        if m.kind == msg_lib.ADMIT:
            epoch = int(m.meta.get("epoch", 0))
            if 0 <= j < n:
                # an already-admitted worker reconnecting: the ADMIT is
                # its rejoin HELLO — replay its rows immediately
                if self.members.hello(j, epoch):
                    self.recorder.mark_alive(j)
                    self._resend_last(j)
            elif (self.elastic is not None
                    and n <= j < self.elastic.max_workers):
                # queue for the next iteration boundary (latest epoch
                # wins if the newcomer retries its ADMIT)
                self._admit[j] = max(epoch, self._admit.get(j, epoch))
            else:
                self.status["corrupt_frames"] += 1
            return
        if not 0 <= j < n:
            if (self.elastic is not None
                    and 0 <= j < self.elastic.max_workers):
                # pending-admission chatter (heartbeats) is not corrupt;
                # a newcomer dying before its boundary just dequeues
                if m.kind == msg_lib.DISCONNECT:
                    self._admit.pop(j, None)
                return
            self.status["corrupt_frames"] += 1
            return
        if m.kind == msg_lib.DISCONNECT:
            if self.members.disconnect(j):
                self._degrade(j)
            return
        if m.kind == msg_lib.HELLO:
            rejoin = self.members.hello(j, int(m.meta.get("epoch", 0)))
            if rejoin:
                self.recorder.mark_alive(j)
                self._resend_last(j)
            return
        if m.kind == msg_lib.HEARTBEAT:
            if self.members.saw(j):
                self.recorder.mark_alive(j)   # slow, not gone: resurrect
            self.members.observe_epoch(j, int(m.meta.get("epoch", 0)))
            return
        if m.kind != msg_lib.PUSH:
            raise ValueError(f"master got unexpected {m.kind!r} message")
        if self.members.saw(j):
            self.recorder.mark_alive(j)
        epoch = int(m.meta.get("epoch", 0))
        seq = int(m.meta.get("n_pushes", 0))
        self.members.observe_epoch(j, epoch)
        if self.members.fresh_push(j, epoch, seq):
            self.pending[j] = (seq,
                               msg_lib.push_grads(m, self._row_templates))
        elif epoch == int(self.members.epoch[j]):
            # current-session duplicate: the worker's refresh was lost —
            # retransmit its last consumed local point (rows unchanged
            # since, so this is an exact retransmission)
            self._resend_last(j)

    def _degrade(self, j: int) -> None:
        """Declare worker j dead: drop it from the tau-forced set and
        zero its pending rows (exact — Eq. 16 masks inactive rows)."""
        self.recorder.mark_dead(j)
        self.pending.pop(j, None)
        self.status["deaths"] = self.members.deaths

    def _send(self, j: int, frame: bytes) -> None:
        try:
            self.endpoint.send(j, frame)
        except (ConnectionError, OSError):
            # a dead socket surfaces through the reader's DISCONNECT (or
            # the deadline); sends to the gone worker are best-effort
            pass

    def _send_rows(self, j: int, t_master: int) -> None:
        rows = (tree_index(self.state.X1, j), tree_index(self.state.X2, j),
                tree_index(self.state.X3, j))
        self._send(j, msg_lib.encode(msg_lib.refresh(j, t_master, rows)))
        self.last_refresh_t[j] = int(t_master)
        self._last_tx[j] = time.monotonic()

    def _resend_last(self, j: int) -> None:
        """Replay worker j's last consumed local point (its rows changed
        only at its own consumption, so resending last_refresh_t's rows
        is bit-identical to the original refresh)."""
        self._send_rows(int(j), int(self.last_refresh_t[int(j)]))

    # -- failure detection --------------------------------------------------

    def _check_deadlines(self) -> None:
        for j in self.members.overdue():
            self.members.mark_dead(j)
            self._degrade(j)

    def _heal_stalled(self) -> None:
        """Retransmit the last refresh to live workers that owe a push
        but have been silent on the compute side too long — recovers a
        refresh (or initial-rows) frame lost in flight."""
        now = time.monotonic()
        for j in range(self.hyper.n_workers):
            if (self.members.alive[j] and j not in self.pending
                    and now - self._last_tx[j]
                    > self.fault.refresh_resend_every):
                self._resend_last(j)

    # -- elastic admission (the boundary barrier) ---------------------------

    def _grow_to(self, n_new: int) -> None:
        """Grow the run to `n_new` workers at an iteration boundary:
        widen the canonical state (`grow_state` — zero rows, exact),
        rebuild (problem, hyper, stream) at the new width via the
        elastic builders, recompile the width-static jits, and widen
        every per-worker bookkeeping array.  The arrival rule is stated
        over the CURRENT live set, so the grown hyper's (s_active, tau)
        govern from the next iteration on (a configured `ArrivalPolicy`
        adopts them as its new baseline)."""
        assert self.elastic is not None
        n_new = int(n_new)
        problem, hyper = self.elastic.build(n_new)
        validate_arrival_params(hyper.s_active, hyper.tau,
                                hyper.n_workers, what="Master (grown)")
        self.state = grow_state(self.state, n_new)
        add = n_new - self.hyper.n_workers
        self.problem, self.hyper = problem, hyper
        if self.stream is not None:
            if self.elastic.build_stream is None:
                raise ValueError(
                    "a streamed elastic run needs "
                    "ElasticConfig.build_stream to widen the Stream")
            self.stream = self.elastic.build_stream(n_new)
            _check_stream(self.stream, hyper)
        self._bind()
        self.members.grow(n_new)
        self.recorder.widen(n_new)
        self.last_refresh_t = np.concatenate(
            [self.last_refresh_t, np.zeros(add, np.int64)])
        self._last_tx = np.concatenate(
            [self._last_tx, np.zeros(add, np.float64)])
        if self.policy is not None:
            self.policy.s_active = hyper.s_active
            self.policy.tau = hyper.tau
        self.status["n_workers"] = n_new

    def _welcome(self, j: int, epoch: int, t_bnd: int) -> None:
        """Open an admitted worker's session at boundary `t_bnd`: grant
        (WELCOME), then its initial rows stamped with the boundary —
        the newcomer's first consumption clock, so its locally folded
        stream batch agrees with the master's bitwise."""
        self.members.admit(j, epoch)
        self.recorder.mark_alive(j)
        self._send(j, msg_lib.encode(msg_lib.welcome(
            j, t_bnd, self.hyper.n_workers)))
        self._send_rows(j, t_bnd)

    def _process_admissions(self) -> None:
        """LIVE boundary: grow to cover every queued ADMIT and open the
        newcomers' sessions.  Ids between the old width and the highest
        admitted id that never said ADMIT stay dead (excluded from the
        tau-forced set like any crashed worker)."""
        if not self._admit:
            return
        n_new = max(self._admit) + 1
        if n_new > self.hyper.n_workers:
            self._grow_to(n_new)
        t_bnd = int(self.state.t)
        for j in sorted(self._admit):
            self._welcome(j, self._admit[j], t_bnd)
        self._admit.clear()
        self._update_worker_status()

    def _admit_for_replay(self, it: int) -> None:
        """REPLAY boundary: at the recorded widening iteration, block
        until every recorded newcomer's ADMIT is queued, then grow to
        exactly the recorded width — the widened trajectory replays
        bit-exactly because the growth happens at the same boundary
        with the same zero rows."""
        rp = self.replay
        if rp.width is None:
            return
        w = int(rp.width[it])
        n = self.hyper.n_workers
        if w <= n:
            return
        newcomers = list(range(n, w))
        silence = _Silence(self.fault.all_dead_timeout, "admissions")
        while not all(j in self._admit for j in newcomers):
            self._consume_frame(silence(self.endpoint.recv(
                timeout=self.fault.poll_interval)))
        self._grow_to(w)
        t_bnd = int(self.state.t)
        for j in newcomers:
            self._welcome(j, self._admit.pop(j), t_bnd)
        self._update_worker_status()

    # -- the arrival rule ---------------------------------------------------

    def _wait_arrivals(self, it: int) -> np.ndarray:
        """Block until this iteration's arrival set is pending; return
        the sorted worker ids to consume."""
        poll = self.fault.poll_interval
        if self.replay is not None:
            # echo the source schedule's effective-(s, tau) audit
            # columns (if any) so a replayed recorder reproduces them
            rp = self.replay
            self._eff = (
                None if rp.s_eff is None else int(rp.s_eff[it]),
                None if rp.tau_eff is None else int(rp.tau_eff[it]))
            target = np.nonzero(self.replay.active[it] > 0)[0]
            silence = _Silence(self.fault.all_dead_timeout,
                               f"iteration {it}'s recorded arrivals")
            while not all(j in self.pending for j in target):
                self._consume_frame(silence(self.endpoint.recv(
                    timeout=poll)))
                self._heal_stalled()
            return target
        forced_rule, s_active = self.hyper.tau, self.hyper.s_active
        if self.policy is not None:
            # one feedback step per master iteration: the policy sees
            # the recorded staleness and proposes this iteration's
            # effective (quorum, forcing horizon) within the tau bound
            s_active, forced_rule = self.policy.propose(
                self.recorder.staleness(), self.members.alive)
        self._eff = (s_active, forced_rule)
        dead_deadline = None
        while True:
            # drain everything already in flight BEFORE judging
            # liveness: the master may have been away compiling/stepping
            # for seconds, and queued heartbeats prove the silence was
            # ours, not the workers'
            while True:
                frame = self.endpoint.recv(timeout=0.0)
                if frame is None:
                    break
                self._consume_frame(frame)
            self._check_deadlines()
            alive = self.members.alive
            n_live = self.members.n_live
            if n_live == 0:
                # nobody left: hold the line for a rejoin, then fail
                if dead_deadline is None:
                    dead_deadline = (time.monotonic()
                                     + self.fault.all_dead_timeout)
                elif time.monotonic() > dead_deadline:
                    raise RuntimeError(
                        "all workers declared dead and none rejoined "
                        f"within {self.fault.all_dead_timeout}s")
            else:
                dead_deadline = None
                stale = self.recorder.staleness()
                forced = np.nonzero((stale >= forced_rule) & alive)[0]
                s_eff = max(1, min(s_active, n_live))
                pend_live = sum(1 for j in self.pending if alive[j])
                if (pend_live >= s_eff
                        and all(j in self.pending for j in forced)):
                    self._eff = (s_eff, forced_rule)
                    break
            self._consume_frame(self.endpoint.recv(timeout=poll))
            self._heal_stalled()
        # the scheduler's "extra" rule: anything already in flight when
        # the master proceeds counts as arrived this iteration
        while True:
            frame = self.endpoint.recv(timeout=0.0)
            if frame is None:
                break
            self._consume_frame(frame)
        return np.array(sorted(self.pending), dtype=np.int64)

    # -- durable master state (checkpoint array dicts) ----------------------

    def snapshot(self) -> Dict[str, np.ndarray]:
        """The master's whole runtime carry as a flat name -> ndarray
        dict, under the reference's key names: the state's leaves, the
        recorder, the pending pushes (stacked rows and per-worker seq),
        membership epochs, refresh bookkeeping and the history.
        Restoring it continues the loop bitwise from the same point."""
        out: Dict[str, np.ndarray] = {
            "it": np.asarray(self.start_it, np.int64),
            "n_workers": np.asarray(self.hyper.n_workers, np.int64),
            "last_refresh_t": self.last_refresh_t.copy(),
        }
        for i, leaf in enumerate(tree_leaves(self.state)):
            out[f"state/{i}"] = msg_lib.to_wire(leaf)
        for k, v in self.recorder.state_dict().items():
            out[f"rec/{k}"] = v
        for k, v in self.members.state_dict().items():
            out[f"mem/{k}"] = v
        n = self.hyper.n_workers
        pend_seq = np.zeros(n, np.int64)
        stacks = tuple(_zero_stack(s) for s in
                       (self.state.X1, self.state.X2, self.state.X3))
        for j, (seq, grads) in self.pending.items():
            pend_seq[j] = seq
            for stack, g in zip(stacks, grads):
                _set_row(stack, int(j), g)
        out["pending_seq"] = pend_seq
        for gi, stack in enumerate(stacks):
            for i, leaf in enumerate(tree_leaves(stack)):
                out[f"pend/g{gi + 1}/{i}"] = leaf
        for k, v in self.hist.items():
            out[f"hist/{k}"] = np.asarray(v, np.float64)
        return out

    def save(self, step: int) -> str:
        """Checkpoint the runtime carry (every `ckpt_every` iterations
        from the loop; safe to call by hand)."""
        assert self.ckpt_dir, "Master has no ckpt_dir configured"
        snap = self.snapshot()
        snap["it"] = np.asarray(step, np.int64)
        return ckpt_io.save_array_dict(self.ckpt_dir, snap, step=step)

    def restore(self, step: Optional[int] = None) -> int:
        """Restore the carry saved by `save`; returns the iteration to
        resume from.  Connection-scoped state (epochs, consumed seqs,
        the pending pushes) is reset: a resumed master faces a fresh
        population, replays each worker's last consumed point and takes
        each worker's first push there."""
        assert self.ckpt_dir, "Master has no ckpt_dir configured"
        d = ckpt_io.load_array_dict(self.ckpt_dir, step=step)
        # a checkpoint written after an elastic growth is wider than the
        # launch: grow to its width first, then restore into it
        n_ckpt = int(d.get("n_workers", self.hyper.n_workers))
        if n_ckpt > self.hyper.n_workers:
            if self.elastic is None or n_ckpt > self.elastic.max_workers:
                raise ckpt_io.CheckpointError(
                    f"checkpoint was written at {n_ckpt} workers; this "
                    f"master launched at {self.hyper.n_workers} with no "
                    "elastic config able to grow that far")
            self._grow_to(n_ckpt)
        elif n_ckpt < self.hyper.n_workers:
            raise ckpt_io.CheckpointError(
                f"checkpoint was written at {n_ckpt} workers; this "
                f"master has {self.hyper.n_workers} (membership only "
                "grows)")
        leaves, tdef = tree_flatten(self.state)
        restored = []
        for i, tpl in enumerate(leaves):
            arr = d[f"state/{i}"]
            if tuple(arr.shape) != tuple(tpl.shape):
                raise ckpt_io.CheckpointError(
                    f"state leaf {i}: checkpoint shape {arr.shape} != "
                    f"runtime template {tuple(tpl.shape)}")
            restored.append(torch.as_tensor(arr, dtype=tpl.dtype,
                                            device=tpl.device).clone())
        self.state = tree_unflatten(tdef, restored)
        self.recorder.load_state_dict(
            {k[len("rec/"):]: v for k, v in d.items()
             if k.startswith("rec/")})
        self.members.load_state_dict(
            {k[len("mem/"):]: v for k, v in d.items()
             if k.startswith("mem/")})
        self.members.reset_sessions()
        self.last_refresh_t = np.asarray(d["last_refresh_t"],
                                         np.int64).copy()
        # The checkpointed pushes are NOT restored: each belongs to a
        # session that is gone, and every fresh session first pushes at
        # the replayed rows, which is the same gradient.  Consuming an
        # old push before that fresh one arrives would set the worker's
        # consumed counter to the old session's seq: the new session's
        # pushes then read as duplicates, the master answers each with
        # the same rows, and the run livelocks (the reference's
        # `restore` does this; tests/test_chaos.py:209 can hang on it).
        self.pending = {}
        self.members.consumed_seq[:] = 0
        self.hist = {k[len("hist/"):]: list(np.asarray(v))
                     for k, v in d.items() if k.startswith("hist/")}
        self.start_it = int(d["it"])
        self.status.update(t=self.start_it, resumed_from=self.start_it,
                           pending=len(self.pending))
        return self.start_it

    # -- the loop -----------------------------------------------------------

    def _update_worker_status(self) -> None:
        stale = self.recorder.staleness()
        rows = self.members.status()
        for j, row in enumerate(rows):
            row["staleness"] = int(stale[j])
            row["dead"] = bool(self.recorder.dead[j])
        self.status.update(workers=rows, deaths=self.members.deaths,
                           rejoins=self.members.rejoins,
                           arrivals=self.recorder.recent())

    def _grads_on_device(self, active_ids) -> tuple:
        """The consumed pushes as (G1, G2, G3) stacks on the device:
        inactive rows zero (exact: Eq. 16 masks them out)."""
        grads = tuple(_zero_stack(s) for s in
                      (self.state.X1, self.state.X2, self.state.X3))
        for j in active_ids:
            seq, rows = self.pending.pop(int(j))
            self.members.consumed(int(j), seq)
            for stack, g in zip(grads, rows):
                _set_row(stack, int(j), g)
        return tuple(tree_map(lambda x: torch.as_tensor(x,
                                                        device=self.device),
                              g) for g in grads)

    def run(self) -> RunResult:
        hist = self.hist
        # state.t advances one per consumed iteration, so subtracting
        # the resume point recovers the absolute origin
        t0_abs = int(self.state.t) - self.start_it
        t_start = time.perf_counter()

        if self.start_it == 0:
            # every worker starts from the master's initial rows
            for j in range(self.hyper.n_workers):
                self._send_rows(j, t0_abs)
        else:
            # resumed master, fresh workers: replay each live worker's
            # last consumed point (unchanged since)
            for j in range(self.hyper.n_workers):
                if self.members.alive[j]:
                    self._resend_last(j)
        self._update_worker_status()
        _, slots = record_slots(self.n_iterations, self.metrics_every)

        with torch.no_grad():
            for it in range(self.start_it, self.n_iterations):
                iter_t0 = time.monotonic()
                # admissions happen only here, at the iteration boundary
                if self.replay is not None:
                    self._admit_for_replay(it)
                else:
                    self._process_admissions()
                active_ids = self._wait_arrivals(it)
                hyper = self.hyper   # fixed for this iteration
                mask = np.zeros((hyper.n_workers,), np.float32)
                mask[active_ids] = 1.0
                grads = self._grads_on_device(active_ids)
                # streamed data: the refresh and the gap take the batch
                # the workers differentiated, each row drawn at its
                # PRE-step consumption time (the streamed engine's draw)
                t_hat_pre = self.state.stale.t_hat
                self.state, aux = self._step(
                    self.state, torch.as_tensor(mask, device=self.device),
                    grads)
                elapsed = time.perf_counter() - t_start
                sim_t = (float(self.replay.sim_time[it])
                         if self.replay is not None else elapsed)
                stale = self.recorder.record(mask, sim_t,
                                             s_eff=self._eff[0],
                                             tau_eff=self._eff[1])

                t_post = t0_abs + it + 1
                record_now = bool(slots[it] >= 0)
                do_refresh = engine_lib.refresh_due(hyper, t_post)
                batch = None
                if self.stream is not None and (do_refresh or record_now):
                    batch = stream_lib.next_batch(
                        self.stream, t_hat_pre.cpu().numpy(),
                        device=self.device)
                if do_refresh:
                    self.state = self._cut_refresh(self.state, batch)

                for j in active_ids:
                    self._send_rows(int(j), t_post)

                self.status.update(t=it + 1, max_staleness=stale,
                                   pending=len(self.pending))
                self._update_worker_status()
                if record_now:
                    # the gap reuses the step's cut products unless a
                    # refresh rewrote the polytope (as the engine does)
                    row = self._record(self.state, batch,
                                       None if do_refresh else aux)
                    gap = float(row.pop("gap_sq"))
                    hist["t"].append(it + 1)
                    hist["sim_time"].append(sim_t)
                    hist["host_time"].append(time.perf_counter() - t_start)
                    hist["gap_sq"].append(gap)
                    hist["max_staleness"].append(float(stale))
                    for k, v in row.items():
                        hist.setdefault(k, []).append(float(v))
                    self.status.update(gap_sq=gap)
                if self.ckpt_dir and self.ckpt_every \
                        and (it + 1) % self.ckpt_every == 0:
                    self.save(step=it + 1)
                if self.replay is None and self.fault.min_iter_time > 0:
                    left = self.fault.min_iter_time \
                        - (time.monotonic() - iter_t0)
                    if left > 0:
                        time.sleep(left)

        self._shutdown()
        self.status.update(done=True)
        return RunResult(state=self.state,
                         history={k: np.asarray(v, np.float64)
                                  for k, v in hist.items()},
                         arrivals=self.recorder.to_schedule())

    def _shutdown(self) -> None:
        """Reliable dismissal: send STOP to every live worker (and any
        newcomer still queued for admission), then keep draining: a
        frame from a still-talking worker means its STOP was lost and
        triggers a resend, until each session's DISCONNECT arrives or
        `FaultConfig.stop_timeout` expires.  STOP has no worker-side
        retransmit, so the master owns its delivery."""
        n = self.hyper.n_workers
        stop = msg_lib.encode(msg_lib.stop())
        open_set = {j for j in range(n) if self.members.alive[j]}
        open_set.update(self._admit)
        for j in sorted(open_set):
            self._send(j, stop)
        deadline = time.monotonic() + self.fault.stop_timeout
        while open_set and time.monotonic() < deadline:
            frame = self.endpoint.recv(timeout=self.fault.poll_interval)
            if frame is None:
                continue
            meta = msg_lib.peek_meta(frame)
            j = -1 if meta is None else int(meta.get("worker", -1))
            if j < 0:
                # a corrupt frame: its sender is unknowable, so dismiss
                # everyone still open again
                for k in sorted(open_set):
                    self._send(k, stop)
                continue
            if msg_lib.peek_kind(frame) == msg_lib.DISCONNECT:
                open_set.discard(j)
            else:
                self._send(j, stop)


def run_async(problem: TrilevelProblem, hyper: Hyper,
              n_iterations: int = 200,
              metrics_fn: Optional[Callable] = None,
              metrics_every: int = 10,
              state: Optional[AFTOState] = None,
              replay: Optional[Schedule] = None,
              transport=None, data=None,
              master_hook: Optional[Callable] = None,
              fault: Optional[FaultConfig] = None,
              ckpt_dir: Optional[str] = None,
              ckpt_every: int = 0,
              resume: bool = False,
              accept_timeout: Optional[float] = None,
              policy: Optional[ArrivalPolicy] = None,
              elastic: Optional[ElasticConfig] = None,
              device=None) -> RunResult:
    """Run the async runtime end to end; a `RunResult` whose `.arrivals`
    is the recorded live Schedule.

    transport=None builds an `InProcTransport` and starts one worker
    thread per worker on the master's device: the deterministic
    single-process configuration.  A `TcpTransport` runs the master over
    sockets; its workers are launched separately (`launch/serve.py fed`
    does both ends).  `master_hook(master)` runs before the loop (the
    status server's attach point).

    fault / ckpt_dir / ckpt_every configure the fault-tolerant layer;
    `resume=True` restores the latest checkpoint of `ckpt_dir` first.
    `data` replaces `problem.data`, or is a `Stream` each worker draws
    its own row from at its REFRESH's `t` (the master draws the same
    rows for the refresh and the gap).  `policy` (live runs) adapts the
    effective quorum and forcing horizon.  `elastic` admits workers
    beyond the launch width; replaying a widening Schedule in process
    starts the recorded newcomers up front in admit mode.

    `device` is where the master and the in-process workers run (the
    CUDA card unless named).  The in-process worker threads are joined
    for at most `JOIN_TIMEOUT` seconds; one still running then is an
    error, not a leak."""
    device = resolve_device(device)
    stream = data if isinstance(data, Stream) else None
    if data is not None and stream is None:
        problem, _ = engine_lib.bind_data(problem, hyper, data)

    threads: List[threading.Thread] = []
    if transport is None:
        transport = transport_lib.InProcTransport(hyper.n_workers)
    endpoint = transport.master_endpoint()
    if isinstance(transport, transport_lib.InProcTransport):
        from repro_torch.fed.runtime import worker as worker_lib

        def spawn(wp, j, ws, admit=False):
            t = threading.Thread(
                target=worker_lib.worker_loop,
                args=(wp, j, transport.worker_endpoint(j)),
                kwargs={"fault": fault, "stream": ws, "admit": admit,
                        "device": device},
                daemon=True)
            t.start()
            threads.append(t)

        for j in range(hyper.n_workers):
            spawn(problem, j, stream)
        if (replay is not None and replay.width is not None
                and elastic is not None
                and replay.n_workers > hyper.n_workers):
            # the recorded newcomers, each on a problem built at its id
            # + 1 (registry rows are stable under width)
            for j in range(hyper.n_workers, replay.n_workers):
                wp, _ = elastic.build(j + 1)
                spawn(wp, j, None if stream is None
                      else elastic.build_stream(j + 1), admit=True)
    else:
        endpoint.wait_for_workers(timeout=accept_timeout)

    try:
        master = Master(problem, hyper, endpoint, n_iterations,
                        metrics_fn=metrics_fn, metrics_every=metrics_every,
                        state=state, replay=replay, fault=fault,
                        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                        stream=stream, policy=policy, elastic=elastic,
                        device=device)
        if resume:
            master.restore()
        if master_hook is not None:
            master_hook(master)
        result = master.run()
    except BaseException:
        # a failed master still dismisses its population (newcomers
        # included) before the error propagates
        for j in range(max(hyper.n_workers, len(threads))):
            try:
                endpoint.send(j, msg_lib.encode(msg_lib.stop()))
            except Exception:
                pass
        raise
    finally:
        endpoint.close()
    join_workers(threads)
    return result


def join_workers(threads) -> None:
    """Join in-process worker threads for at most `JOIN_TIMEOUT` seconds
    each; raise if one is still running (a worker that outlives its
    master is a fault, not a leak to ignore)."""
    for t in threads:
        t.join(timeout=JOIN_TIMEOUT)
    alive = [t.name for t in threads if t.is_alive()]
    if alive:
        raise RuntimeError(f"worker threads still running "
                           f"{JOIN_TIMEOUT}s after the run: {alive}")
