"""The paper's evaluation on the port: one entry per table, figure or
theorem check.  Prints ``name,us_per_call,derived`` CSV, as the
reference's `benchmarks/run.py` does for the same suites.

    PYTHONPATH=src python -m repro_torch.experiments.run [--fast]
        [--only fig1,fig2,table2,rate,comm] [--device cpu]

``--fast`` trims iteration counts as the reference does; without
``--device`` it runs on the CUDA device (and fails without one).
"""
from __future__ import annotations

import argparse

from repro_torch.experiments import (comm_complexity, fig1_robust_hpo,
                                     fig2_domain_adapt, rate_thm45,
                                     table2_baselines)


def suites(fast: bool, device):
    return {
        "fig1": lambda: fig1_robust_hpo.main(
            n_iterations=60 if fast else 120,
            datasets=("diabetes", "boston") if fast else None,
            device=device),
        "fig2": lambda: fig2_domain_adapt.main(
            n_iterations=16 if fast else 40,
            directions=("mnist_pretrain",) if fast else None,
            device=device),
        "table2": lambda: table2_baselines.main(
            n_iterations=60 if fast else 150,
            seeds=(0,) if fast else (0, 1),
            datasets=("diabetes",) if fast
            else table2_baselines.DATASETS, device=device),
        "rate": lambda: rate_thm45.main(
            n_iterations=150 if fast else 400, device=device),
        "comm": lambda: comm_complexity.main(device=device),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset: fig1,fig2,table2,rate,"
                         "comm")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    table = suites(args.fast, args.device)
    only = args.only.split(",") if args.only else list(table)
    unknown = sorted(set(only) - set(table))
    if unknown:
        ap.error(f"unknown suites {unknown}; expected some of {list(table)}")

    print("name,us_per_call,derived")
    for key in table:
        if key in only:
            for name, us, derived in table[key]():
                print(f"{name},{us:.1f},{derived}", flush=True)


if __name__ == "__main__":
    main()
