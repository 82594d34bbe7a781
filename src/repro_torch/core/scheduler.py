"""Host-side asynchrony: straggler model, active sets, simulated clock.

A numpy copy of `repro/core/scheduler.py` (the port keeps its own copy:
importing `repro` would import jax).  *Who arrives when* and the
wall-clock cost of each master iteration are simulated with a
deterministic seeded latency model; for the same `StragglerConfig` the
arrival masks, simulated times and staleness equal the reference's
exactly.  Setting ``s_active == n_workers`` recovers SFTO (the
synchronous baseline in Fig. 1/2).  The async runtime
(`repro_torch.fed.runtime`) records its live arrival process with
`ArrivalRecorder` and may adapt the arrival rule with `ArrivalPolicy`.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The arrival process of `n_iterations` master iterations, materialized
    up front and handed to the engine as plain arrays.

    Only `active` drives the step math; the optional columns are records
    of a live run (`ArrivalRecorder`), carried by `slice` and
    checkpoints, None for simulated schedules:

      dead     (T, N) {0,1} workers declared dead as of each iteration
               (`max_staleness` is then taken among the live ones).
      s_eff / tau_eff  (T,) the effective quorum and forcing horizon the
               master used (fixed, or `ArrivalPolicy`'s proposals).
      width    (T,) the population width at each iteration, set only
               when it grew (elastic admission): earlier rows of
               `active` are zero-padded and of `dead` one-padded, and
               the run replays as per-width segments
               (`fed.runtime.membership.run_scanned_elastic`).
    """
    active: np.ndarray         # (T, N) float32 arrival masks
    sim_time: np.ndarray       # (T,) float64 completion sim-times
    max_staleness: np.ndarray  # (T,) int64 max staleness after each iter
    dead: Optional[np.ndarray] = None
    s_eff: Optional[np.ndarray] = None      # (T,) int64
    tau_eff: Optional[np.ndarray] = None    # (T,) int64
    width: Optional[np.ndarray] = None      # (T,) int64

    @property
    def n_iterations(self) -> int:
        return int(self.active.shape[0])

    @property
    def n_workers(self) -> int:
        return int(self.active.shape[1])

    def slice(self, a: int, b: int) -> "Schedule":
        """Iterations [a, b) as a standalone Schedule (every per-iteration
        column sliced together)."""
        def cut(x):
            return None if x is None else x[a:b]
        return dataclasses.replace(
            self, active=self.active[a:b], sim_time=self.sim_time[a:b],
            max_staleness=self.max_staleness[a:b], dead=cut(self.dead),
            s_eff=cut(self.s_eff), tau_eff=cut(self.tau_eff),
            width=cut(self.width))


def _stack_rows(rows, n: int, dtype) -> np.ndarray:
    return np.stack(rows) if rows else np.zeros((0, n), dtype)


class ArrivalRecorder:
    """Materializes a LIVE arrival process into a `Schedule`.

    The async runtime records each master iteration here, so the
    observed process comes back out as a `Schedule` that replays through
    `run_scanned` or through the runtime itself.  Staleness is counted
    among live workers only; the `dead` mask records who was declared
    dead at each iteration."""

    def __init__(self, n_workers: int):
        self.n_workers = int(n_workers)
        self._active: List[np.ndarray] = []
        self._sim_time: List[float] = []
        self._staleness: List[int] = []
        self._dead: List[np.ndarray] = []
        # per-iteration effective (quorum, forcing horizon); -1 marks an
        # iteration recorded without them
        self._s_eff: List[int] = []
        self._tau_eff: List[int] = []
        # per-iteration population width; the schedule carries a `width`
        # column only if it ever changed
        self._width: List[int] = []
        self.last_active = np.zeros(self.n_workers, dtype=np.int64)
        self.dead = np.zeros(self.n_workers, dtype=bool)

    @property
    def t(self) -> int:
        return len(self._active)

    def mark_dead(self, j: int) -> None:
        """Declare worker j dead: out of the staleness diagnostic (and
        the master's tau-forced set) until it rejoins."""
        self.dead[int(j)] = True

    def mark_alive(self, j: int) -> None:
        """Resurrect worker j; its staleness clock restarts now, so it
        gets the full tau window for its first push."""
        j = int(j)
        self.dead[j] = False
        self.last_active[j] = self.t

    def widen(self, n_new: int) -> None:
        """Grow the worker axis to `n_new` (elastic admission).  Recorded
        rows keep full width: `active` zero-padded, `dead` one-padded (a
        worker that did not exist yet is recorded dead).  Newcomers start
        dead with a fresh staleness clock."""
        n_new = int(n_new)
        if n_new < self.n_workers:
            raise ValueError(
                f"widen: {n_new} < current width {self.n_workers} "
                "(membership only grows)")
        if n_new == self.n_workers:
            return
        add = n_new - self.n_workers
        self._active = [np.concatenate([r, np.zeros(add, np.float32)])
                        for r in self._active]
        self._dead = [np.concatenate([r, np.ones(add, np.float32)])
                      for r in self._dead]
        self.last_active = np.concatenate(
            [self.last_active, np.full(add, self.t, np.int64)])
        self.dead = np.concatenate([self.dead, np.ones(add, bool)])
        self.n_workers = n_new

    def record(self, active_mask, sim_time: float,
               s_eff: Optional[int] = None,
               tau_eff: Optional[int] = None) -> int:
        """Append one master iteration's arrival set; returns the max
        staleness among live workers after it."""
        mask = np.asarray(active_mask, np.float32).reshape(self.n_workers)
        self._active.append(mask)
        self._sim_time.append(float(sim_time))
        self._dead.append(self.dead.astype(np.float32).copy())
        self._s_eff.append(-1 if s_eff is None else int(s_eff))
        self._tau_eff.append(-1 if tau_eff is None else int(tau_eff))
        self._width.append(self.n_workers)
        t = self.t
        self.last_active[mask > 0] = t
        live = ~self.dead
        stale = int(np.max((t - self.last_active)[live])) if live.any() \
            else 0
        self._staleness.append(stale)
        return stale

    def staleness(self) -> np.ndarray:
        """Per-worker staleness going into the next iteration (t+1 -
        last_active), the quantity the tau rule bounds.  Dead workers'
        entries keep growing: mask them before forcing on them."""
        return (self.t + 1) - self.last_active

    def to_schedule(self) -> Schedule:
        """The recorded process as a `Schedule`.  The effective-(s, tau)
        columns are kept if any iteration recorded them; `width` only if
        the population grew."""
        n = self.n_workers
        s_eff = np.asarray(self._s_eff, np.int64)
        tau_eff = np.asarray(self._tau_eff, np.int64)
        have_eff = bool((s_eff >= 0).any() or (tau_eff >= 0).any())
        width = np.asarray(self._width, np.int64)
        widened = bool(width.size and (width != width[0]).any())
        return Schedule(
            active=_stack_rows(self._active, n, np.float32),
            sim_time=np.asarray(self._sim_time, np.float64),
            max_staleness=np.asarray(self._staleness, np.int64),
            dead=_stack_rows(self._dead, n, np.float32),
            s_eff=s_eff if have_eff else None,
            tau_eff=tau_eff if have_eff else None,
            width=width if widened else None)

    def recent(self, k: int = 8) -> List[dict]:
        """The last `k` iterations as status rows: who arrived, the
        effective (s, tau) and the staleness."""
        t0 = max(0, self.t - int(k))
        return [{
            "t": i + 1,
            "arrived": np.nonzero(self._active[i] > 0)[0].tolist(),
            "s_eff": int(self._s_eff[i]),
            "tau_eff": int(self._tau_eff[i]),
            "max_staleness": int(self._staleness[i]),
        } for i in range(t0, self.t)]

    def state_dict(self) -> dict:
        """The recorder's whole mutable state as name -> ndarray (the
        reference's checkpoint keys)."""
        n = self.n_workers
        return {
            "active": _stack_rows(self._active, n, np.float32),
            "sim_time": np.asarray(self._sim_time, np.float64),
            "staleness": np.asarray(self._staleness, np.int64),
            "dead_hist": _stack_rows(self._dead, n, np.float32),
            "s_eff": np.asarray(self._s_eff, np.int64),
            "tau_eff": np.asarray(self._tau_eff, np.int64),
            "width": np.asarray(self._width, np.int64),
            "last_active": self.last_active.copy(),
            "dead": self.dead.copy(),
        }

    def load_state_dict(self, d: dict) -> None:
        """Inverse of `state_dict`.  A dict without the (s, tau) or
        width columns restores them as unrecorded / constant."""
        self._active = [np.asarray(r, np.float32)
                        for r in np.asarray(d["active"])]
        self._sim_time = [float(x) for x in np.asarray(d["sim_time"])]
        self._staleness = [int(x) for x in np.asarray(d["staleness"])]
        self._dead = [np.asarray(r, np.float32)
                      for r in np.asarray(d["dead_hist"])]
        t = len(self._active)
        self._s_eff = [int(x) for x in np.asarray(
            d.get("s_eff", np.full(t, -1, np.int64)))]
        self._tau_eff = [int(x) for x in np.asarray(
            d.get("tau_eff", np.full(t, -1, np.int64)))]
        self.last_active = np.asarray(d["last_active"], np.int64).copy()
        self.dead = np.asarray(d["dead"], bool).copy()
        self.n_workers = int(self.last_active.shape[0])
        self._width = [int(x) for x in np.asarray(
            d.get("width", np.full(t, self.n_workers, np.int64)))]


def validate_arrival_params(s_active: int, tau: int, n_workers: int,
                            what: str = "arrival config") -> None:
    """Fail fast on arrival-rule parameters that can never be satisfied:
    `s_active > n_workers` deadlocks the quorum wait and `tau < 1`
    admits no arrival process."""
    if not 1 <= int(s_active) <= int(n_workers):
        raise ValueError(
            f"{what}: s_active={s_active} must be in "
            f"[1, n_workers={n_workers}] — the S-of-N quorum can never "
            f"be met otherwise (deadlocked arrival wait)")
    if int(tau) < 1:
        raise ValueError(
            f"{what}: tau={tau} must be >= 1 — the staleness bound "
            f"admits no arrival process otherwise")


@dataclasses.dataclass
class StragglerConfig:
    n_workers: int
    s_active: int                 # S
    tau: int                      # staleness bound
    n_stragglers: int = 0
    straggler_slowdown: float = 5.0
    base_latency: float = 1.0     # mean per-iteration worker latency
    jitter: float = 0.2           # lognormal sigma
    seed: int = 0

    def __post_init__(self):
        validate_arrival_params(self.s_active, self.tau, self.n_workers,
                                what="StragglerConfig")


def quorum(forced: np.ndarray, order, s_active: int) -> np.ndarray:
    """Every tau-forced worker, plus the earliest-finishing others (in
    `order`) until at least `s_active` workers are chosen; sorted ids."""
    chosen = set(int(j) for j in np.nonzero(np.asarray(forced))[0])
    for j in order:
        if len(chosen) >= s_active:
            break
        chosen.add(int(j))
    return np.array(sorted(chosen), dtype=np.int64)


@dataclasses.dataclass
class ArrivalPolicy:
    """Closed-loop arrival control from the recorded staleness, inside the
    paper's bound.

    Each master iteration feeds the observed per-worker staleness in and
    gets an effective (s_eff, tau_eff) back, with 1 <= s_eff and
    1 <= tau_eff <= tau.  Staleness pressure (a live worker within one
    iteration of the forcing horizon) raises the quorum by one notch and
    forces one iteration earlier; after `relax_after` calm iterations
    the boost decays one notch.  Only arrival masks reach the step math,
    so adapted runs replay exactly."""
    s_active: int
    tau: int
    relax_after: int = 4
    max_boost: Optional[int] = None   # default: tau - 1 (keeps tau_eff >= 1)
    _boost: int = dataclasses.field(default=0, repr=False)
    _calm: int = dataclasses.field(default=0, repr=False)

    def __post_init__(self):
        if self.tau < 1 or self.s_active < 1:
            raise ValueError(
                f"ArrivalPolicy needs s_active >= 1 and tau >= 1; got "
                f"s_active={self.s_active}, tau={self.tau}")
        if self.max_boost is None:
            self.max_boost = max(0, int(self.tau) - 1)

    def propose(self, staleness, alive) -> Tuple[int, int]:
        """Observed staleness and the liveness mask in, this iteration's
        (s_eff, tau_eff) out.  Call once per master iteration."""
        alive = np.asarray(alive, bool)
        live_stale = np.asarray(staleness)[alive]
        worst = int(live_stale.max()) if live_stale.size else 0
        tau_now = max(1, self.tau - self._boost)
        if worst >= tau_now - 1:
            self._boost = min(self._boost + 1, self.max_boost)
            self._calm = 0
        else:
            self._calm += 1
            if self._calm >= self.relax_after and self._boost > 0:
                self._boost -= 1
                self._calm = 0
        return max(1, self.s_active + self._boost), \
            max(1, self.tau - self._boost)


class StragglerScheduler:
    """Event-driven simulation of the parameter-server arrival process.

    Each worker finishes its local update ``latency_j`` after the last
    broadcast it received.  The master proceeds once S workers have
    arrived; any worker about to exceed the staleness bound tau is waited
    for regardless.
    """

    def __init__(self, cfg: StragglerConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        slow = np.ones(cfg.n_workers)
        slow[: cfg.n_stragglers] = cfg.straggler_slowdown
        self.rng.shuffle(slow)
        self.slowdown = slow
        self.now = 0.0
        self.ready = self._draw_latency()
        self.last_active = np.zeros(cfg.n_workers, dtype=np.int64)
        self.t = 0

    def _draw_latency(self) -> np.ndarray:
        c = self.cfg
        lat = c.base_latency * self.slowdown * self.rng.lognormal(
            mean=0.0, sigma=c.jitter, size=c.n_workers)
        return self.now + lat

    def next_active(self) -> Tuple[np.ndarray, float]:
        """Returns ((N,) float mask, iteration completion sim-time)."""
        c = self.cfg
        self.t += 1
        staleness = self.t - self.last_active
        forced = staleness >= c.tau

        chosen_idx = quorum(forced, np.argsort(self.ready), c.s_active)
        t_done = float(np.max(self.ready[chosen_idx]))
        extra = np.nonzero(self.ready <= t_done)[0]
        active_idx = np.union1d(chosen_idx, extra)

        self.now = t_done
        mask = np.zeros(c.n_workers, dtype=np.float32)
        mask[active_idx] = 1.0
        self.last_active[active_idx] = self.t
        new_ready = self._draw_latency()
        self.ready = np.where(mask > 0, new_ready, self.ready)
        return mask, self.now

    def max_staleness(self) -> int:
        return int(np.max(self.t - self.last_active))

    def precompute(self, n_iterations: int) -> Schedule:
        """The next `n_iterations` of the arrival process, stepped on a
        deep copy (`self` is left untouched)."""
        clone = copy.deepcopy(self)
        n = self.cfg.n_workers
        active = np.empty((n_iterations, n), np.float32)
        sim_time = np.empty((n_iterations,), np.float64)
        staleness = np.empty((n_iterations,), np.int64)
        for i in range(n_iterations):
            mask, t_done = clone.next_active()
            active[i] = mask
            sim_time[i] = t_done
            staleness[i] = clone.max_staleness()
        return Schedule(active=active, sim_time=sim_time,
                        max_staleness=staleness)
