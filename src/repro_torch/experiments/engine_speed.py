"""The sweep engine against a loop of single runs, and streamed runs
against runs on resident data.

Counterpart of `benchmarks/engine_speed.py` `sweep_record` and
`streamed_record`.  `sweep_record` runs the white-wine robust-HPO
problem (Table 1: N=6, S=4, tau=10, one 5x straggler) instead of the
quickstart problem: R seeded trajectories as one `run_swept` against the
same R trajectories as a loop of `run_scanned` calls, both warm, the
best of `reps` passes each (host clock, the device synchronised at both
ends), and whether the swept rows reproduce the looped final states
(rtol 2e-5, atol 1e-6, the reference's check).  `streamed_record` runs
the quickstart problem (N=4, dim 3) with a stream of fresh (A, b) draws:
a streamed scan, a scan on the resident data and the streamed run in 2
state-continued chunks, and whether the chunked final state equals the
unchunked one exactly.

    PYTHONPATH=src python -m repro_torch.experiments.engine_speed
        [--iterations 40] [--runs 4] [--reps 2] [--device cpu]
        [--streamed]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.apps.robust_hpo import default_hyper, make_robust_hpo_problem
from repro_torch.core import Hyper, StragglerConfig, StragglerScheduler
from repro_torch.core.engine import run_chunked, run_scanned, run_swept
from repro_torch.data import stream as stream_lib
from repro_torch.experiments.common import make_quadratic_problem

SWEEP_RUNS = 4


def _synced(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def best_of(fn, reps, device):
    """(the least seconds of `reps` calls of fn, the last result)."""
    best, out = float("inf"), None
    for _ in range(reps):
        _synced(device)
        t0 = time.perf_counter()
        out = fn()
        _synced(device)
        best = min(best, time.perf_counter() - t0)
    return best, out


def sweep_record(n_iterations: int = 40, n_runs: int = SWEEP_RUNS,
                 reps: int = 2, device=None) -> dict:
    """Swept against looped: R trajectories on the arrival processes of
    seeds 0 .. R-1, one sweep against a loop of scanned runs."""
    n, s, tau = 6, 4, 10
    task = make_robust_hpo_problem("white_wine", n_workers=n, seed=0,
                                   device=device)
    device = task.problem.x1_init["phi"].device
    hyper = default_hyper(task, n, s, tau)
    cfg = StragglerConfig(n_workers=n, s_active=s, tau=tau, n_stragglers=1,
                          straggler_slowdown=5.0, seed=0)
    schedules = [StragglerScheduler(dataclasses.replace(cfg, seed=r))
                 .precompute(n_iterations) for r in range(n_runs)]
    me = max(1, n_iterations // 10)

    def looped():
        return [run_scanned(task.problem, hyper, sc, metrics_every=me)
                for sc in schedules]

    def swept():
        return run_swept(task.problem, hyper, schedules, metrics_every=me)

    looped(), swept()                                 # warm both engines
    looped_wall, looped_res = best_of(looped, reps, device)
    swept_wall, swept_res = best_of(swept, reps, device)
    match = all(
        torch.allclose(a.float(), b[r].float(), rtol=2e-5, atol=1e-6)
        for r in range(n_runs)
        for a, b in zip(torch.utils._pytree.tree_leaves(looped_res[r].state),
                        torch.utils._pytree.tree_leaves(swept_res.state)))
    return {
        "sweep": {
            "dataset": "white_wine",
            "n_runs": n_runs,
            "n_iterations": n_iterations,
            "device": str(device),
            "looped_wall_s": looped_wall,
            "swept_wall_s": swept_wall,
            "runs_per_sec_looped": n_runs / looped_wall,
            "runs_per_sec_swept": n_runs / swept_wall,
            "swept_speedup": looped_wall / swept_wall,
            "states_allclose": bool(match),
        },
        "runs_per_sec_swept": n_runs / swept_wall,
    }


def quickstart_stream() -> stream_lib.Stream:
    """Fresh per-iteration (A, b) draws shaped like the quickstart
    problem's data (4 workers, dim 3, A at 0.3), seed 0: the reference's
    `quickstart_stream`."""
    def sample(key, device):
        g = stream_lib.generator(key, device)
        return {"A": torch.randn((3, 3), generator=g,
                                 device=device).mul_(0.3),
                "b": torch.randn((3,), generator=g, device=device)}

    return stream_lib.make_stream(sample, 4, 0)


def streamed_record(n_iterations: int = 200, reps: int = 3,
                    device=None) -> dict:
    """A warm streamed scan against the warm scan on resident data over
    the same schedule, and the streamed run in 2 state-continued chunks
    (`run_chunked`), whose final state must equal the unchunked run's
    exactly: `chunked_states_allclose` false means the streaming contract
    broke.  The streamed and resident trajectories differ by design (the
    data differs): the resident run is the cost of a constant dataset,
    the streamed one buys fresh worker samples every iteration."""
    n, s, tau = 4, 3, 5
    problem = make_quadratic_problem(n_workers=n, device=device)
    device = problem.x1_init.device
    hyper = Hyper(n_workers=n, s_active=s, tau=tau, k_inner=3, p_max=6,
                  t_pre=5, t1=100, eta_x=0.05, eta_z=0.05, d1=3)
    schedule = StragglerScheduler(StragglerConfig(
        n_workers=n, s_active=s, tau=tau, n_stragglers=1,
        straggler_slowdown=5.0, seed=0)).precompute(n_iterations)
    stream = quickstart_stream()
    me = max(1, n_iterations // 10)
    runs = {
        "resident": lambda: run_scanned(problem, hyper, schedule,
                                        metrics_every=me),
        "streamed": lambda: run_scanned(problem, hyper, schedule,
                                        metrics_every=me, data=stream),
        "chunked": lambda: run_chunked(problem, hyper, schedule,
                                       n_iterations // 2, metrics_every=me,
                                       data=stream),
    }
    walls, results = {}, {}
    for name, fn in runs.items():
        fn()                                          # warm
        walls[name], results[name] = best_of(fn, reps, device)
    match = all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(results["streamed"].state),
        torch.utils._pytree.tree_leaves(results["chunked"].state)))
    gap = float(results["streamed"].history["gap_sq"][-1])
    return {
        "streamed": {
            "n_iterations": n_iterations,
            "device": str(device),
            "wall_s": walls["streamed"],
            "host_fed_wall_s": walls["resident"],
            "chunked_wall_s": walls["chunked"],
            "n_chunks": 2,
            "iters_per_sec": n_iterations / walls["streamed"],
            "gap_sq": gap,
            "gap_finite": bool(np.isfinite(gap)),
            "chunked_states_allclose": bool(match),
        },
        "iters_per_sec_streamed": n_iterations / walls["streamed"],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=40)
    ap.add_argument("--runs", type=int, default=SWEEP_RUNS)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--streamed", action="store_true",
                    help="print streamed_record instead of sweep_record")
    args = ap.parse_args(argv)
    if args.streamed:
        print(json.dumps(streamed_record(args.iterations, args.reps,
                                         device=args.device)))
        return
    print(json.dumps(sweep_record(args.iterations, args.runs, args.reps,
                                  device=args.device)))


if __name__ == "__main__":
    main()
