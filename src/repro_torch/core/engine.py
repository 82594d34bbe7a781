"""Trajectory engine: a whole single-device AFTO run as one host loop.

Counterpart of `repro/core/engine.py` `run_scanned` (single device,
static data).  The reference compiles the trajectory into one
`lax.scan`; here each iteration is eager PyTorch on the device, and the
loop keeps the device free of host round trips:

  * the schedule's arrival masks are copied to the device once;
  * `afto_step` runs every master iteration (Eqs. 16-21);
  * `cut_refresh` runs on every t_pre-th iteration with t < t1
    (Eqs. 23-25), decided on a host-side mirror of the post-step `t`
    (the step adds exactly 1), so no device sync per iteration;
  * at `metrics_every` strides the stationarity gap reuses the step's
    cut operator and cut values, recomputed only after a refresh;
  * recorded values stay on the device until the run ends.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import afto as afto_lib
from repro_torch.core import stationarity as stat_lib
from repro_torch.core.scheduler import Schedule
from repro_torch.core.types import AFTOState, Hyper, TrilevelProblem


@dataclasses.dataclass
class RunResult:
    state: AFTOState
    history: Dict
    # the live arrival process of an async run; None for scheduled runs
    arrivals: Any = None


def record_slots(n_iterations: int,
                 metrics_every: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side record layout matching the eager runner.

    Returns (record_its, slots): `record_its` are the iterations whose
    metrics are recorded — every `metrics_every`-th plus the final one —
    and `slots[it]` is the history row for iteration `it` (-1 when
    iteration `it` records nothing)."""
    record_its = np.array(
        [it for it in range(n_iterations)
         if (it + 1) % metrics_every == 0 or it == n_iterations - 1],
        dtype=np.int64)
    slots = np.full((n_iterations,), -1, np.int32)
    slots[record_its] = np.arange(len(record_its), dtype=np.int32)
    return record_its, slots


def refresh_due(hyper: Hyper, t_post: int) -> bool:
    """The refresh predicate on the 1-based post-step iteration count."""
    return t_post % hyper.t_pre == 0 and t_post - 1 < hyper.t1


def record(problem: TrilevelProblem, hyper: Hyper, state: AFTOState,
           metrics_fn: Optional[Callable], aux=None) -> Dict:
    """One history row as 0-d device tensors."""
    vals = {
        "gap_sq": stat_lib.stationarity_gap_sq(problem, hyper, state,
                                               aux=aux),
        "n_cuts_i": torch.sum(state.cuts_i.active),
        "n_cuts_ii": torch.sum(state.cuts_ii.active),
    }
    if metrics_fn is not None:
        vals.update(metrics_fn(state))
    return vals


def run_scanned(problem: TrilevelProblem, hyper: Hyper, schedule: Schedule,
                metrics_fn: Optional[Callable] = None,
                metrics_every: int = 10,
                state: Optional[AFTOState] = None) -> RunResult:
    """Run the AFTO trajectory over `schedule`.

    The history holds numpy arrays keyed by t / sim_time / host_time /
    gap_sq / n_cuts_i / n_cuts_ii / max_staleness plus any `metrics_fn`
    keys (whose values are 0-d tensors).  `host_time` is prorated from
    the run's total, as in the reference.  A `state` continues a run:
    the refresh predicate keys on the absolute iteration count."""
    n_iterations = schedule.n_iterations
    if state is None:
        state = afto_lib.init_state(problem, hyper)
    device = state.lam.device
    record_its, slots = record_slots(n_iterations, metrics_every)
    masks = torch.as_tensor(schedule.active, dtype=torch.float32,
                            device=device)
    rows = []

    t_start = time.perf_counter()
    t_abs = int(state.t)
    with torch.no_grad():
        for it in range(n_iterations):
            state, aux = afto_lib.afto_step_aux(problem, hyper, state,
                                                masks[it])
            t_abs += 1
            refreshed = refresh_due(hyper, t_abs)
            if refreshed:
                state = afto_lib.cut_refresh(problem, hyper, state)
            if slots[it] >= 0:
                rows.append(record(problem, hyper, state, metrics_fn,
                                   aux=None if refreshed else aux))
        history = {k: torch.stack([r[k].float() for r in rows])
                   .cpu().numpy() for k in rows[0]}
    elapsed = time.perf_counter() - t_start

    history["t"] = (record_its + 1).astype(np.float64)
    history["sim_time"] = np.asarray(schedule.sim_time)[record_its]
    history["max_staleness"] = np.asarray(
        schedule.max_staleness)[record_its].astype(np.float64)
    history["host_time"] = elapsed * (record_its + 1) / n_iterations
    return RunResult(state=state, history=history)
