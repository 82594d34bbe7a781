"""The sweep engine against a loop of single runs.

Counterpart of `benchmarks/engine_speed.py` `sweep_record`, on the
white-wine robust-HPO problem (Table 1: N=6, S=4, tau=10, one 5x
straggler) instead of the quickstart problem: R seeded trajectories as
one `run_swept` against the same R trajectories as a loop of
`run_scanned` calls, both warm, the best of `reps` passes each (host
clock, the device synchronised at both ends), and whether the swept
rows reproduce the looped final states (rtol 2e-5, atol 1e-6, the
reference's check).

    PYTHONPATH=src python -m repro_torch.experiments.engine_speed
        [--iterations 40] [--runs 4] [--reps 2] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.apps.robust_hpo import default_hyper, make_robust_hpo_problem
from repro_torch.core import StragglerConfig, StragglerScheduler
from repro_torch.core.engine import run_scanned, run_swept

SWEEP_RUNS = 4


def _synced(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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

    def best_of(fn):
        best, out = float("inf"), None
        for _ in range(reps):
            _synced(device)
            t0 = time.perf_counter()
            out = fn()
            _synced(device)
            best = min(best, time.perf_counter() - t0)
        return best, out

    looped(), swept()                                 # warm both engines
    looped_wall, looped_res = best_of(looped)
    swept_wall, swept_res = best_of(swept)
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=40)
    ap.add_argument("--runs", type=int, default=SWEEP_RUNS)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    print(json.dumps(sweep_record(args.iterations, args.runs, args.reps,
                                  device=args.device)))


if __name__ == "__main__":
    main()
