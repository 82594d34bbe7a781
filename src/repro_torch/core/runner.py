"""Run dispatcher behind the `RunSpec` API.

Counterpart of `repro/core/runner.py`.  `run(RunSpec(...))` is the
canonical entry; this slice of the port carries three engines:

  "scan"   (default) materialize the straggler schedule up front and
           drive the trajectory through `engine.run_scanned`, which keeps
           the device free of per-iteration host round trips.
  "sweep"  R whole trajectories (per-seed schedules, per-run states,
           data and hypers) through one vmapped loop
           (`engine.run_swept`): every kernel launch covers all R runs.
  "eager"  the per-iteration host loop: host-side `metrics_fn`
           callbacks, per-iteration host timestamps, and the live
           scheduler when no schedule is given.

The async engine, worker meshes, chunked runs and replacement or
streamed data for the single-run engines are later slices of the port
and raise `NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, Dict, List, Mapping, Optional,
                    Sequence)

import torch

from repro_torch.core import afto as afto_lib
from repro_torch.core import engine as engine_lib
from repro_torch.core.engine import RunResult, SweepResult
from repro_torch.core.scheduler import (Schedule, StragglerConfig,
                                        StragglerScheduler)
from repro_torch.core.types import AFTOState, Hyper, TrilevelProblem
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves

ENGINES = ("scan", "sweep", "eager")
# what is not ported yet, and its item in ROADMAP.md Queue 1
_LATER = {"async": "the async runtime (item 5)"}
_LATER_FIELDS = {"chunk_size": "chunked runs (item 4)",
                 "mesh": "the worker-mesh sharded engine (item 6)"}
_SWEEP_ONLY = ("schedules", "seeds", "sweep_states", "sweep_hypers")


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One run, fully specified.

      problem / hyper   the trilevel problem and algorithm hypers.
      engine            "scan" | "eager".
      n_iterations      master iterations T (ignored when `schedule`
                        fixes the length).
      scheduler         `StragglerConfig` for the simulated arrival
                        process (defaults to hyper's N/S/tau).
      schedule          a materialized `Schedule` to run.
      metrics_fn        extra per-record metrics: `state -> {name: 0-d
                        tensor}`.
      metrics_every     record stride.
      schedules/seeds   per-run arrival processes for engine="sweep"
                        (one of them; `seeds` re-seeds `scheduler`).
      state             initial `AFTOState` (continuation runs).
      sweep_states/sweep_hypers  per-run initial states / swept hyper
                        scalars for engine="sweep".
      data              engine="sweep": replacement `problem.data` with
                        a leading (R,) axis per leaf (per-seed data).
                        The single-run engines take none yet (streams
                        and replacement data are a later slice).
      device            where the run happens; None means CUDA (and
                        raises without it).  The problem must live there.
      mesh, chunk_size  later slices of the port; must stay None.
    """
    problem: TrilevelProblem
    hyper: Hyper
    engine: str = "scan"
    n_iterations: int = 200
    scheduler: Optional[StragglerConfig] = None
    schedule: Optional[Schedule] = None
    schedules: Optional[Sequence[Schedule]] = None
    seeds: Optional[Sequence[int]] = None
    metrics_fn: Optional[Callable] = None
    metrics_every: int = 10
    state: Optional[AFTOState] = None
    sweep_states: Optional[AFTOState] = None
    sweep_hypers: Optional[Mapping] = None
    device: Optional[str] = None
    data: Any = None
    mesh: Any = None
    chunk_size: Optional[int] = None

    def resolved_scheduler(self) -> StragglerConfig:
        if self.scheduler is not None:
            return self.scheduler
        return StragglerConfig(n_workers=self.hyper.n_workers,
                               s_active=self.hyper.s_active,
                               tau=self.hyper.tau)

    def resolved_iterations(self) -> int:
        if self.schedule is not None:
            return self.schedule.n_iterations
        return self.n_iterations


def run(spec: RunSpec):
    """Run AFTO as `spec` says: a `RunResult`, or for engine="sweep" a
    `SweepResult`."""
    if spec.engine in _LATER:
        raise NotImplementedError(
            f"engine={spec.engine!r}: {_LATER[spec.engine]} is not ported "
            "yet (ROADMAP.md Queue 1)")
    if spec.engine not in ENGINES:
        raise ValueError(f"unknown engine {spec.engine!r}; expected one "
                         f"of {ENGINES}")
    for name, what in _LATER_FIELDS.items():
        if getattr(spec, name) is not None:
            raise NotImplementedError(
                f"RunSpec.{name}: {what} is not ported yet (ROADMAP.md "
                "Queue 1)")
    if spec.engine != "sweep":
        if spec.data is not None:
            raise NotImplementedError(
                "RunSpec.data: streams and replacement data for the "
                f"{spec.engine!r} engine are not ported yet (ROADMAP.md "
                "Queue 1, item 4); engine='sweep' takes per-run data")
        for name in _SWEEP_ONLY:
            if getattr(spec, name) is not None:
                raise ValueError(f"RunSpec.{name} is for engine='sweep'")
    device = resolve_device(spec.device)
    for leaf in tree_leaves((spec.problem.x1_init, spec.problem.data)):
        if leaf.device.type != device.type:
            raise ValueError(f"the problem lives on {leaf.device}, the run "
                             f"on {device}")

    if spec.engine == "sweep":
        return _run_sweep(spec)
    if spec.engine == "scan":
        schedule = spec.schedule
        if schedule is None:
            schedule = StragglerScheduler(spec.resolved_scheduler()) \
                .precompute(spec.n_iterations)
        return engine_lib.run_scanned(
            spec.problem, spec.hyper, schedule, metrics_fn=spec.metrics_fn,
            metrics_every=spec.metrics_every, state=spec.state)
    return _run_eager(spec)


def _run_sweep(spec: RunSpec) -> SweepResult:
    """engine="sweep": one schedule per entry of `schedules`, or per seed
    of `seeds` (the scheduler re-seeded), or the scheduler's own seed."""
    if spec.state is not None or spec.schedule is not None:
        raise ValueError(
            "engine='sweep' takes per-run sweep_states/schedules; the "
            "single-run state/schedule would be silently ignored")
    if spec.schedules is not None and spec.seeds is not None:
        raise ValueError("pass either explicit `schedules` or `seeds` "
                         "(which materialize one schedule per seed), not "
                         "both")
    schedules = spec.schedules
    if schedules is None:
        cfg = spec.resolved_scheduler()
        seeds = list(spec.seeds) if spec.seeds is not None else [cfg.seed]
        schedules = [
            StragglerScheduler(dataclasses.replace(cfg, seed=s))
            .precompute(spec.n_iterations) for s in seeds]
    return engine_lib.run_swept(
        spec.problem, spec.hyper, schedules, metrics_fn=spec.metrics_fn,
        metrics_every=spec.metrics_every, states=spec.sweep_states,
        data=spec.data, sweep_hypers=spec.sweep_hypers)


def _run_eager(spec: RunSpec) -> RunResult:
    """The per-iteration host loop (engine="eager")."""
    problem, hyper = spec.problem, spec.hyper
    schedule, state = spec.schedule, spec.state
    sched = StragglerScheduler(spec.resolved_scheduler())
    if state is None:
        state = afto_lib.init_state(problem, hyper)
    device = state.lam.device

    hist: Dict[str, List[float]] = {
        "t": [], "sim_time": [], "host_time": [], "gap_sq": [],
        "n_cuts_i": [], "n_cuts_ii": [], "max_staleness": []}
    t0_abs = int(state.t)
    t_start = time.perf_counter()
    with torch.no_grad():
        for it in range(spec.resolved_iterations()):
            if schedule is not None:
                mask, sim_t = schedule.active[it], \
                    float(schedule.sim_time[it])
            else:
                mask, sim_t = sched.next_active()
            state = afto_lib.afto_step(
                problem, hyper, state,
                torch.as_tensor(mask, dtype=torch.float32, device=device))
            if engine_lib.refresh_due(hyper, t0_abs + it + 1):
                state = afto_lib.cut_refresh(problem, hyper, state)
            if (it + 1) % spec.metrics_every == 0 \
                    or it == spec.resolved_iterations() - 1:
                hist["t"].append(it + 1)
                hist["sim_time"].append(sim_t)
                hist["host_time"].append(time.perf_counter() - t_start)
                hist["max_staleness"].append(float(
                    schedule.max_staleness[it] if schedule is not None
                    else sched.max_staleness()))
                for k, v in engine_lib.record(problem, hyper, state,
                                              spec.metrics_fn).items():
                    hist.setdefault(k, []).append(float(v))
    return RunResult(state=state, history=hist)
