"""Run dispatcher behind the `RunSpec` API.

Counterpart of `repro/core/runner.py`.  `run(RunSpec(...))` is the
canonical entry; this slice of the port carries two engines:

  "scan"   (default) materialize the straggler schedule up front and
           drive the trajectory through `engine.run_scanned`, which keeps
           the device free of per-iteration host round trips.
  "eager"  the per-iteration host loop: host-side `metrics_fn`
           callbacks, per-iteration host timestamps, and the live
           scheduler when no schedule is given.

The sweep and async engines, worker meshes, chunked runs and replacement
or streamed data are later slices of the port and raise
`NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core import afto as afto_lib
from repro_torch.core import engine as engine_lib
from repro_torch.core.engine import RunResult
from repro_torch.core.scheduler import (Schedule, StragglerConfig,
                                        StragglerScheduler)
from repro_torch.core.types import AFTOState, Hyper, TrilevelProblem
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves

ENGINES = ("scan", "eager")
# what is not ported yet, and its item in ROADMAP.md Queue 1
_LATER = {"sweep": "the sweep engine (item 3)",
          "async": "the async runtime (item 5)"}
_LATER_FIELDS = {"data": "streams and replacement data (item 4)",
                 "chunk_size": "chunked runs (item 4)",
                 "mesh": "the worker-mesh sharded engine (item 6)"}


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
      state             initial `AFTOState` (continuation runs).
      device            where the run happens; None means CUDA (and
                        raises without it).  The problem must live there.
      data, mesh, chunk_size
                        later slices of the port; must stay None.
    """
    problem: TrilevelProblem
    hyper: Hyper
    engine: str = "scan"
    n_iterations: int = 200
    scheduler: Optional[StragglerConfig] = None
    schedule: Optional[Schedule] = None
    metrics_fn: Optional[Callable] = None
    metrics_every: int = 10
    state: Optional[AFTOState] = None
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


def run(spec: RunSpec) -> RunResult:
    """Run AFTO as `spec` says."""
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
    device = resolve_device(spec.device)
    for leaf in tree_leaves((spec.problem.x1_init, spec.problem.data)):
        if leaf.device.type != device.type:
            raise ValueError(f"the problem lives on {leaf.device}, the run "
                             f"on {device}")

    if spec.engine == "scan":
        schedule = spec.schedule
        if schedule is None:
            schedule = StragglerScheduler(spec.resolved_scheduler()) \
                .precompute(spec.n_iterations)
        return engine_lib.run_scanned(
            spec.problem, spec.hyper, schedule, metrics_fn=spec.metrics_fn,
            metrics_every=spec.metrics_every, state=spec.state)
    return _run_eager(spec)


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
