"""Host-side asynchrony: straggler model, active sets, simulated clock.

A numpy copy of the parts of `repro/core/scheduler.py` the single-device
engines use (the port keeps its own copy: importing `repro` would import
jax).  *Who arrives when* and the wall-clock cost of each master
iteration are simulated with a deterministic seeded latency model; for
the same `StragglerConfig` the arrival masks, simulated times and
staleness equal the reference's exactly.  Setting ``s_active ==
n_workers`` recovers SFTO (the synchronous baseline in Fig. 1/2).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The arrival process of `n_iterations` master iterations, materialized
    up front and handed to the engine as plain arrays."""
    active: np.ndarray         # (T, N) float32 arrival masks
    sim_time: np.ndarray       # (T,) float64 completion sim-times
    max_staleness: np.ndarray  # (T,) int64 max staleness after each iter

    @property
    def n_iterations(self) -> int:
        return int(self.active.shape[0])

    @property
    def n_workers(self) -> int:
        return int(self.active.shape[1])

    def slice(self, a: int, b: int) -> "Schedule":
        """Iterations [a, b) as a standalone Schedule."""
        return Schedule(active=self.active[a:b],
                        sim_time=self.sim_time[a:b],
                        max_staleness=self.max_staleness[a:b])


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
