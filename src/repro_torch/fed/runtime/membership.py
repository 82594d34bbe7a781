"""Elastic membership: liveness tracking + exact worker resharding.

Counterpart of `repro/fed/runtime/membership.py`.

Two halves:

1. `Membership` — the master's failure-detector state machine.  Every
   frame from worker j refreshes its `last_seen` clock; a worker silent
   past `FaultConfig.death_timeout` (or surfaced as a transport
   `DISCONNECT`) is DECLARED DEAD: removed from the tau-forced arrival
   set, its pending gradient rows dropped (zero-filled rows are exact —
   Eq. 16 masks inactive rows bitwise), and the degradation recorded in
   the arrival `Schedule`'s `dead` mask so the trajectory still replays
   exactly through `run_scanned`.  A rejoin (re-HELLO with a bumped
   resume epoch, or a late frame from a presumed-dead worker) resurrects
   it with a fresh staleness clock.  Per-worker (epoch, seq) bookkeeping
   makes duplicated / retransmitted / dead-session frames exact no-ops.

2. Exact resharding — `make_views` / `assemble_state` partition the
   canonical `AFTOState` into per-shard worker views (each shard holds
   its own workers' stacked rows plus a local cut polytope from
   `cuts.shard_cuts`: replicated a-columns + own workers' b-columns) and
   reassemble them bitwise.  Because the column partition is exact, a
   membership change mid-trajectory (workers regrouped over a different
   shard count on permanent leave/join) is a pure re-layout: a resharded
   continuation matches the fixed-membership run bit-for-bit
   (`tests/test_torch_fed_faults.py` pins this).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import cuts as cuts_lib
from repro_torch.core.types import (AFTOState, FlatCuts, InnerState2,
                                    InnerState3, StaleView)
from repro_torch.utils.tree import tree_map


# ---------------------------------------------------------------------------
# fault-tolerance knobs (master + worker sides share one config)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Timeouts and pacing for the fault-tolerant runtime.

    The defaults are generous relative to the test problems' per-push
    compute (~ms) so healthy runs never trip a deadline; chaos tests
    shrink them to exercise the failure paths quickly.
    """
    heartbeat_every: float = 0.2    # worker liveness beacon period (idle)
    resend_every: float = 1.0       # worker push-retransmit period
    refresh_resend_every: float = 1.0   # master refresh-retransmit period
    death_timeout: float = 10.0     # silence before a worker is declared dead
    poll_interval: float = 0.02     # master recv poll while blocked
    all_dead_timeout: float = 30.0  # blocked with zero live workers -> error
    stop_timeout: float = 10.0      # STOP-resend shutdown drain deadline
    min_iter_time: float = 0.0      # master pacing floor (chaos smoke)
    backoff_base: float = 0.05      # worker reconnect backoff (seconds)
    backoff_cap: float = 2.0
    backoff_tries: int = 20


class Membership:
    """Per-worker liveness, session epochs and consumed-push sequence
    numbers — the master's view of who is alive, who is gone, and which
    frames are from dead sessions."""

    def __init__(self, n_workers: int, cfg: Optional[FaultConfig] = None,
                 clock=time.monotonic):
        self.n = int(n_workers)
        self.cfg = cfg or FaultConfig()
        self.clock = clock
        now = clock()
        self.alive = np.ones(self.n, dtype=bool)
        self.last_seen = np.full(self.n, now, dtype=np.float64)
        self.epoch = np.zeros(self.n, dtype=np.int64)
        self.consumed_seq = np.zeros(self.n, dtype=np.int64)
        self.deaths = 0
        self.rejoins = 0

    # -- liveness transitions ----------------------------------------------

    def saw(self, j: int) -> bool:
        """Any frame from worker j refreshes its clock; returns True if
        this resurrects a presumed-dead worker (it was slow, not gone)."""
        j = int(j)
        self.last_seen[j] = self.clock()
        if not self.alive[j]:
            self.alive[j] = True
            self.rejoins += 1
            return True
        return False

    def hello(self, j: int, epoch: int) -> bool:
        """Process a HELLO; returns True if the master must replay the
        worker's last consumed local point.

        Any post-launch HELLO is a session restart: the worker's push
        sequence restarts at 1 regardless of whether it remembered to
        bump its epoch, so the consumed counter resets whenever the
        announced epoch is current-or-newer and the rows are replayed
        unconditionally.  (The old rule replayed only on death or an
        epoch advance — an externally supervised restart that forgot
        `--epoch` kept its socket but never got its rows back, and its
        seq-1 pushes read as consumed duplicates: wedged until
        death_timeout.)  A STALE epoch still never regresses the
        session — rows are replayed but the live session's (epoch,
        consumed_seq) dedup state is untouched."""
        j = int(j)
        self.saw(j)
        if int(epoch) >= int(self.epoch[j]):
            self.epoch[j] = int(epoch)
            self.consumed_seq[j] = 0
        return True

    def disconnect(self, j: int) -> bool:
        """Transport surfaced a broken connection; returns True if the
        worker was alive (newly declared dead)."""
        j = int(j)
        newly = bool(self.alive[j])
        if newly:
            self.alive[j] = False
            self.deaths += 1
        return newly

    def overdue(self) -> List[int]:
        """Live workers silent past the death deadline."""
        now = self.clock()
        return [int(j) for j in range(self.n)
                if self.alive[j]
                and now - self.last_seen[j] > self.cfg.death_timeout]

    def mark_dead(self, j: int) -> None:
        j = int(j)
        if self.alive[j]:
            self.alive[j] = False
            self.deaths += 1

    @property
    def n_live(self) -> int:
        return int(self.alive.sum())

    # -- elastic admission ---------------------------------------------------

    def grow(self, n_new: int) -> None:
        """Widen the population to `n_new` workers.  New slots start
        DEAD with fresh session bookkeeping — `admit` (or a gap id's
        later ADMIT) resurrects them.  Growth is monotone; ids between
        the old width and the highest admitted id that never said ADMIT
        simply stay dead (they are excluded from the tau-forced set the
        same way a crashed worker is)."""
        n_new = int(n_new)
        if n_new < self.n:
            raise ValueError(
                f"grow: {n_new} < current population {self.n} "
                "(membership only grows)")
        if n_new == self.n:
            return
        add = n_new - self.n
        now = self.clock()
        self.alive = np.concatenate([self.alive, np.zeros(add, bool)])
        self.last_seen = np.concatenate(
            [self.last_seen, np.full(add, now, np.float64)])
        self.epoch = np.concatenate(
            [self.epoch, np.zeros(add, np.int64)])
        self.consumed_seq = np.concatenate(
            [self.consumed_seq, np.zeros(add, np.int64)])
        self.n = n_new

    def admit(self, j: int, epoch: int = 0) -> None:
        """Open an admitted worker's first session: alive, at the
        announced epoch, with a clean consumed counter."""
        j = int(j)
        self.alive[j] = True
        self.epoch[j] = int(epoch)
        self.consumed_seq[j] = 0
        self.last_seen[j] = self.clock()

    def observe_epoch(self, j: int, epoch: int) -> bool:
        """Adopt a newer session epoch seen on any frame (covers a lost
        rejoin HELLO: the first push of the new session advances the
        epoch and resets the consumed counter).  Returns True if the
        epoch advanced."""
        j = int(j)
        if int(epoch) > int(self.epoch[j]):
            self.epoch[j] = int(epoch)
            self.consumed_seq[j] = 0
            return True
        return False

    def fresh_push(self, j: int, epoch: int, seq: int) -> bool:
        """True iff a PUSH with this (epoch, seq) is new — from the
        worker's current session and not yet consumed.  Stale-session
        frames are dropped; a current-session duplicate seq means the
        worker never got its refresh (retransmit it)."""
        j = int(j)
        return (int(epoch) == int(self.epoch[j])
                and int(seq) > int(self.consumed_seq[j]))

    def consumed(self, j: int, seq: int) -> None:
        self.consumed_seq[int(j)] = int(seq)

    def reset_sessions(self) -> None:
        """Forget connection-scoped bookkeeping (epochs + consumed
        sequence numbers) — used when a resumed master faces a fresh
        worker population.  Liveness clocks restart too."""
        self.epoch[:] = 0
        self.consumed_seq[:] = 0
        self.alive[:] = True
        self.last_seen[:] = self.clock()

    def status(self) -> List[Dict]:
        """Per-worker liveness snapshot for the serve /status endpoint."""
        now = self.clock()
        return [{"worker": j,
                 "alive": bool(self.alive[j]),
                 "last_seen_age": float(now - self.last_seen[j]),
                 "epoch": int(self.epoch[j]),
                 "consumed_seq": int(self.consumed_seq[j])}
                for j in range(self.n)]

    # -- durable-master support --------------------------------------------

    def state_dict(self) -> Dict[str, np.ndarray]:
        return {"epoch": self.epoch.copy(),
                "consumed_seq": self.consumed_seq.copy(),
                "alive": self.alive.copy()}

    def load_state_dict(self, d: Dict[str, np.ndarray]) -> None:
        self.epoch = np.asarray(d["epoch"], np.int64).copy()
        self.consumed_seq = np.asarray(d["consumed_seq"], np.int64).copy()
        self.alive = np.asarray(d["alive"], bool).copy()
        # a grown snapshot restores at its grown width
        self.n = int(self.epoch.shape[0])
        self.last_seen = np.full(self.n, self.clock(), np.float64)


# ---------------------------------------------------------------------------
# exact resharding of the canonical state over worker groups
# ---------------------------------------------------------------------------

# every AFTOState piece with a leading worker axis (nested fields listed
# explicitly so a new stacked field fails the conformance test loudly)
_STACKED_TOP = ("X1", "X2", "X3", "theta")


@dataclasses.dataclass
class ShardView:
    """One shard's slice of the canonical state: its workers' stacked
    rows plus the local cut polytopes (replicated a-columns and its own
    workers' b-columns, the `cuts.shard_spec` layout)."""
    index: int
    n_shards: int
    stacks: Dict   # field name -> (n_loc, ...) tree (incl. nested pieces)
    cuts_i: FlatCuts
    cuts_ii: FlatCuts


def _block(tree, w: int, n_loc: int):
    return tree_map(lambda x: x[w * n_loc:(w + 1) * n_loc], tree)


def _n_workers_of(state: AFTOState) -> int:
    return int(state.stale.t_hat.shape[0])


def _stale_of(tree_of, parts):
    return StaleView(**{f.name: tree_of([getattr(p, f.name) for p in parts])
                        for f in dataclasses.fields(StaleView)})


def make_views(state: AFTOState, n_shards: int) -> List[ShardView]:
    """Partition the canonical state into `n_shards` contiguous worker
    groups (the worker axis must divide evenly)."""
    n = _n_workers_of(state)
    if n % n_shards != 0:
        raise ValueError(
            f"{n} workers do not partition over {n_shards} shards")
    n_loc = n // n_shards
    ci = cuts_lib.shard_cuts(state.cuts_i, n_shards)
    cii = cuts_lib.shard_cuts(state.cuts_ii, n_shards)
    views = []
    for w in range(n_shards):
        stacks = {f: _block(getattr(state, f), w, n_loc)
                  for f in _STACKED_TOP}
        stacks["stale"] = _stale_of(lambda xs: _block(xs[0], w, n_loc),
                                    [state.stale])
        stacks["inner3_x3"] = _block(state.inner3.x3, w, n_loc)
        stacks["inner3_phi"] = _block(state.inner3.phi, w, n_loc)
        stacks["inner2_x2"] = _block(state.inner2.x2, w, n_loc)
        stacks["inner2_phi"] = _block(state.inner2.phi, w, n_loc)
        views.append(ShardView(
            index=w, n_shards=n_shards, stacks=stacks,
            cuts_i=FlatCuts(a=ci.a[w], c=ci.c, active=ci.active,
                            age=ci.age, spec=ci.spec),
            cuts_ii=FlatCuts(a=cii.a[w], c=cii.c, active=cii.active,
                             age=cii.age, spec=cii.spec)))
    return views


def _concat(trees):
    return tree_map(lambda *xs: torch.cat(xs, dim=0), *trees)


def assemble_state(master_state: AFTOState,
                   views: List[ShardView]) -> AFTOState:
    """Reassemble the canonical state from per-shard views (inverse of
    `make_views`, bit for bit).  Master-replicated fields (z's, lam,
    gamma_k, inner consensus and slack pieces, t) come from
    `master_state`; the worker-partitioned pieces and the cut matrices
    come from the views."""
    views = sorted(views, key=lambda v: v.index)
    n_shards = len(views)
    if any(v.n_shards != n_shards for v in views) \
            or [v.index for v in views] != list(range(n_shards)):
        raise ValueError("views do not form a complete shard set")

    def cat(name):
        return _concat([v.stacks[name] for v in views])

    def polytope(which):
        local = [getattr(v, which) for v in views]
        stacked = FlatCuts(a=torch.stack([fc.a for fc in local]),
                           c=local[0].c, active=local[0].active,
                           age=local[0].age, spec=local[0].spec)
        return cuts_lib.unshard_cuts(stacked,
                                     getattr(master_state, which).spec)

    return dataclasses.replace(
        master_state,
        X1=cat("X1"), X2=cat("X2"), X3=cat("X3"), theta=cat("theta"),
        stale=_stale_of(_concat, [v.stacks["stale"] for v in views]),
        inner3=InnerState3(x3=cat("inner3_x3"),
                           z3=master_state.inner3.z3,
                           phi=cat("inner3_phi")),
        inner2=InnerState2(x2=cat("inner2_x2"),
                           z2=master_state.inner2.z2,
                           phi=cat("inner2_phi"),
                           s=master_state.inner2.s,
                           gamma=master_state.inner2.gamma),
        cuts_i=polytope("cuts_i"), cuts_ii=polytope("cuts_ii"))


def reshard_state(state: AFTOState, n_old: int, n_new: int) -> AFTOState:
    """Re-partition the canonical state from `n_old` worker groups to
    `n_new` (a membership change).  Both directions go through the exact
    column partition, so the result is bitwise the input state."""
    canonical = assemble_state(state, make_views(state, n_old))
    return assemble_state(canonical, make_views(canonical, n_new))


# ---------------------------------------------------------------------------
# elastic admission: growing the canonical state mid-run
# ---------------------------------------------------------------------------

def grow_state(state: AFTOState, n_new: int) -> AFTOState:
    """Widen the state's worker axis to `n_new` workers.

    Every worker-stacked piece gains zero rows and both polytopes zero
    b-columns (`cuts.grow_cuts`): exact, because a newcomer's row stays
    masked out of every Eq. 16 update until its first push is consumed,
    and a zero coefficient adds nothing to a contraction.  The
    newcomers' consumption clocks `t_hat` start at the current master
    iteration `state.t` (the admission boundary, the `t` their first
    rows are stamped with).  Master-replicated fields are untouched."""
    n_old = _n_workers_of(state)
    n_new = int(n_new)
    if n_new < n_old:
        raise ValueError(
            f"grow_state: {n_new} < current width {n_old} "
            "(membership only grows)")
    if n_new == n_old:
        return state
    add = n_new - n_old

    def pad(x):
        return torch.cat([x, x.new_zeros((add,) + tuple(x.shape[1:]))])

    def pad_tree(tree):
        return tree_map(pad, tree)

    st = state.stale
    t_hat = torch.cat([st.t_hat, state.t.to(st.t_hat.dtype).expand(add)])
    return dataclasses.replace(
        state,
        X1=pad_tree(state.X1), X2=pad_tree(state.X2),
        X3=pad_tree(state.X3), theta=pad_tree(state.theta),
        stale=StaleView(z1=pad_tree(st.z1), z2=pad_tree(st.z2),
                        z3=pad_tree(st.z3), lam=pad(st.lam),
                        theta=pad_tree(st.theta), t_hat=t_hat),
        inner3=InnerState3(x3=pad_tree(state.inner3.x3),
                           z3=state.inner3.z3,
                           phi=pad_tree(state.inner3.phi)),
        inner2=InnerState2(x2=pad_tree(state.inner2.x2),
                           z2=state.inner2.z2,
                           phi=pad_tree(state.inner2.phi),
                           s=state.inner2.s, gamma=state.inner2.gamma),
        cuts_i=cuts_lib.grow_cuts(state.cuts_i, n_new),
        cuts_ii=cuts_lib.grow_cuts(state.cuts_ii, n_new))


@dataclasses.dataclass
class ElasticConfig:
    """Elastic-admission wiring for the async master.

    `build(n) -> (problem, hyper)` rebuilds the problem at population
    width `n`; it MUST be per-worker-row stable (worker j's data row is
    the same at every width that holds j), as the registry builders of
    `problems.py` are.  `build_stream(n)` is the streamed analogue.
    `max_workers` bounds the population: an ADMIT beyond it is dropped
    as corrupt."""
    build: Callable[[int], tuple]
    max_workers: int
    build_stream: Optional[Callable] = None


def run_scanned_elastic(build: Callable[[int], tuple], schedule,
                        metrics_fn=None, metrics_every: int = 10,
                        build_stream: Optional[Callable] = None,
                        state: Optional[AFTOState] = None):
    """Replay a (possibly widening) recorded Schedule through
    `run_scanned`, one segment per population width.

    Each constant-width segment runs at its own width (columns
    truncated: the padded history is zero there), with `grow_state` at
    every admission boundary, which is what the live elastic master
    does.  Segments record every iteration and the `metrics_every`
    stride is subsampled afterwards, so the record points are the
    unsegmented run's.  A schedule with no `width` column takes the
    plain `run_scanned` path."""
    from repro_torch.core.engine import RunResult, run_scanned

    if schedule.width is None:
        problem, hyper = build(schedule.n_workers)
        data = (build_stream(schedule.n_workers)
                if build_stream is not None else None)
        return run_scanned(problem, hyper, schedule,
                           metrics_fn=metrics_fn,
                           metrics_every=metrics_every,
                           state=state, data=data)

    width = np.asarray(schedule.width, np.int64)
    bounds = [0] + [int(i) for i in (np.nonzero(np.diff(width))[0] + 1)] \
        + [schedule.n_iterations]
    history: Dict[str, list] = {}
    host_offset = 0.0
    for a, b in zip(bounds[:-1], bounds[1:]):
        w = int(width[a])
        if state is not None and _n_workers_of(state) < w:
            state = grow_state(state, w)
        seg = schedule.slice(a, b)
        seg = dataclasses.replace(
            seg, active=seg.active[:, :w],
            dead=None if seg.dead is None else seg.dead[:, :w],
            width=None)
        problem, hyper = build(w)
        data = build_stream(w) if build_stream is not None else None
        res = run_scanned(problem, hyper, seg, metrics_fn=metrics_fn,
                          metrics_every=1, state=state, data=data)
        state = res.state
        for k, v in res.history.items():
            col = np.asarray(v)
            if k == "t":
                col = col + a
            elif k == "host_time":
                col = col + host_offset
            history.setdefault(k, []).extend(list(col))
        host_offset = float(history["host_time"][-1])
    n_total = schedule.n_iterations
    keep = np.array([it for it in range(n_total)
                     if (it + 1) % metrics_every == 0
                     or it == n_total - 1], dtype=np.int64)
    return RunResult(state=state, history={
        k: np.asarray(v)[keep] for k, v in history.items()})
