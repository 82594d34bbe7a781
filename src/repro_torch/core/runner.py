"""Run dispatcher behind the `RunSpec` API.

Counterpart of `repro/core/runner.py`.  `run(RunSpec(...))` is the
canonical entry; this port carries four engines:

  "scan"   (default) materialize the straggler schedule up front and
           drive the trajectory through `engine.run_scanned`, which keeps
           the device free of per-iteration host round trips; with
           `chunk_size` set the trajectory splits into state-continued
           calls with `chunk_hook` called on the live state at every
           chunk boundary (`engine.run_chunked`).
  "sweep"  R whole trajectories (per-seed schedules, per-run states,
           data and hypers, or one shared stream) through one vmapped
           loop (`engine.run_swept`): every kernel launch covers all R
           runs.
  "eager"  the per-iteration host loop: host-side `metrics_fn`
           callbacks, per-iteration host timestamps, and the live
           scheduler when no schedule is given.
  "async"  the real master / worker runtime (`repro_torch.fed.runtime.
           run_async`) over a pluggable transport: workers compute the
           Eq. 16 gradients at their own pace and push them; with
           `schedule` the master replays that arrival order, without it
           the run's live arrivals come back as `RunResult.arrivals`.

Every engine takes `data=`: replacement `problem.data` arrays, or a
`repro_torch.data.stream.Stream` whose worker batches are drawn each
iteration at the workers' consumption times.  Worker meshes are a later
slice of the port and raise `NotImplementedError`.
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
from repro_torch.data import stream as stream_lib
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves

ENGINES = ("scan", "sweep", "eager", "async")
# what is not ported yet, and its item in ROADMAP.md Queue 1
_LATER_FIELDS = {"mesh": "the worker-mesh sharded engine (item 6)"}
_SWEEP_ONLY = ("schedules", "seeds", "sweep_states", "sweep_hypers")


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One run, fully specified.

      problem / hyper   the trilevel problem and algorithm hypers.
      engine            "scan" | "sweep" | "eager" | "async".
      n_iterations      master iterations T (ignored when `schedule`
                        fixes the length).
      scheduler         `StragglerConfig` for the simulated arrival
                        process (defaults to hyper's N/S/tau).
      schedule          a materialized `Schedule` to run (engine="async":
                        the arrival order the master replays).
      metrics_fn        extra per-record metrics: `state -> {name: 0-d
                        tensor}`.
      metrics_every     record stride.
      schedules/seeds   per-run arrival processes for engine="sweep"
                        (one of them; `seeds` re-seeds `scheduler`).
      state             initial `AFTOState` (continuation runs).
      sweep_states/sweep_hypers  per-run initial states / swept hyper
                        scalars for engine="sweep".
      data              replacement `problem.data` arrays (for
                        engine="sweep" with a leading (R,) axis per
                        leaf: per-seed data), or a
                        `repro_torch.data.stream.Stream`, whose batches
                        are drawn on the device every iteration (shared
                        by the runs of a sweep).
      chunk_size        engine="scan": split the trajectory into
                        state-continued calls of this many iterations.
      chunk_hook        `(state, t_abs) -> state | None`, called on the
                        live state at every chunk boundary, the last
                        included (checkpoints, the push/pull seam);
                        needs `chunk_size`.
      device            where the run happens; None means CUDA (and
                        raises without it).  The problem must live there.
      transport         engine="async": a `repro_torch.fed.runtime`
                        transport (default: an in-process queue
                        transport with one worker thread per worker).
      mesh              a later slice of the port; must stay None.
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
    transport: Any = None
    mesh: Any = None
    chunk_size: Optional[int] = None
    chunk_hook: Optional[Callable] = None

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
    if spec.engine not in ENGINES:
        raise ValueError(f"unknown engine {spec.engine!r}; expected one "
                         f"of {ENGINES}")
    for name, what in _LATER_FIELDS.items():
        if getattr(spec, name) is not None:
            raise NotImplementedError(
                f"RunSpec.{name}: {what} is not ported yet (ROADMAP.md "
                "Queue 1)")
    if spec.chunk_hook is not None and spec.chunk_size is None:
        raise ValueError("chunk_hook requires chunk_size")
    if spec.chunk_size is not None and spec.engine != "scan":
        raise ValueError("chunk_size/chunk_hook require engine='scan'")
    if spec.transport is not None and spec.engine != "async":
        raise ValueError("RunSpec.transport is for engine='async'")
    if spec.engine != "sweep":
        for name in _SWEEP_ONLY:
            if getattr(spec, name) is not None:
                raise ValueError(f"RunSpec.{name} is for engine='sweep'")
    device = resolve_device(spec.device)
    for leaf in tree_leaves((spec.problem.x1_init, spec.problem.data)):
        if leaf.device.type != device.type:
            raise ValueError(f"the problem lives on {leaf.device}, the run "
                             f"on {device}")

    if spec.engine == "async":
        from repro_torch.fed import runtime as runtime_lib
        return runtime_lib.run_async(
            spec.problem, spec.hyper, n_iterations=spec.n_iterations,
            metrics_fn=spec.metrics_fn, metrics_every=spec.metrics_every,
            state=spec.state, replay=spec.schedule,
            transport=spec.transport, data=spec.data, device=device)
    if spec.engine == "sweep":
        return _run_sweep(spec)
    if spec.engine == "scan":
        schedule = spec.schedule
        if schedule is None:
            schedule = StragglerScheduler(spec.resolved_scheduler()) \
                .precompute(spec.n_iterations)
        if spec.chunk_size is not None:
            return engine_lib.run_chunked(
                spec.problem, spec.hyper, schedule, spec.chunk_size,
                chunk_hook=spec.chunk_hook, metrics_fn=spec.metrics_fn,
                metrics_every=spec.metrics_every, state=spec.state,
                data=spec.data)
        return engine_lib.run_scanned(
            spec.problem, spec.hyper, schedule, metrics_fn=spec.metrics_fn,
            metrics_every=spec.metrics_every, state=spec.state,
            data=spec.data)
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
    """The per-iteration host loop (engine="eager").  A stream's batch is
    drawn from the state's own `stale.t_hat` (read from the device each
    iteration, where the scan engine keeps a host mirror), and step,
    refresh and gap see the same batch, as in the reference's loop."""
    hyper, schedule, state = spec.hyper, spec.schedule, spec.state
    problem, stream = engine_lib.bind_data(spec.problem, hyper, spec.data)
    sched = StragglerScheduler(spec.resolved_scheduler())
    if state is None:
        state = afto_lib.init_state(problem, hyper)
    device = state.lam.device
    prob = problem

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
            if stream is not None:
                prob = dataclasses.replace(problem, data=stream_lib.next_batch(
                    stream, state.stale.t_hat.tolist(), device=device))
            state = afto_lib.afto_step(
                prob, hyper, state,
                torch.as_tensor(mask, dtype=torch.float32, device=device))
            if engine_lib.refresh_due(hyper, t0_abs + it + 1):
                state = afto_lib.cut_refresh(prob, hyper, state)
            if (it + 1) % spec.metrics_every == 0 \
                    or it == spec.resolved_iterations() - 1:
                hist["t"].append(it + 1)
                hist["sim_time"].append(sim_t)
                hist["host_time"].append(time.perf_counter() - t_start)
                hist["max_staleness"].append(float(
                    schedule.max_staleness[it] if schedule is not None
                    else sched.max_staleness()))
                for k, v in engine_lib.record(prob, hyper, state,
                                              spec.metrics_fn).items():
                    hist.setdefault(k, []).append(float(v))
    return RunResult(state=state, history=hist)
