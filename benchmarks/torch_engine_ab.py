"""ms per master iteration of the port's white-wine scan route, for two
checkouts of the port, in turns on one card.

    python3 benchmarks/torch_engine_ab.py OTHER_SRC [--iterations 120]

`OTHER_SRC` is the `src/` directory of another checkout (for example an
earlier commit unpacked with `git archive` into the ignored
`_checkout/`); this checkout's `src/` is the other side.  Each
measurement is a subprocess that imports `repro_torch` from one side,
builds its kernels, warms up, and times `chip_smoke.py` phase 4's
configuration (white-wine robust HPO: N=6, S=4, tau=10, one 5x
straggler, seed 0) on the cut-kernel route and on the fused route, each
one `run(RunSpec(engine="scan"))` of `--iterations` iterations, host
clock with the device synchronised at both ends.  The sides run in the
order other, this, this, other, so each sees the same mean position;
the card's name and power limit are printed with the table.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1] / "src"


def measure(n_iterations: int) -> dict:
    """{route: ms per iteration} on the `repro_torch` found first on the
    path."""
    import dataclasses

    import torch
    from repro_torch.apps.robust_hpo import (default_hyper,
                                             make_robust_hpo_problem)
    from repro_torch.core import RunSpec, StragglerConfig, run
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()
    task = make_robust_hpo_problem("white_wine", n_workers=6, seed=0,
                                   device="cuda")
    hyper = default_hyper(task, 6, 4, 10)
    cfg = StragglerConfig(n_workers=6, s_active=4, tau=10, n_stragglers=1,
                          straggler_slowdown=5.0, seed=0)
    out = {}
    for route, hy in (("kernel", hyper),
                      ("fused", dataclasses.replace(hyper,
                                                    use_fused_inner=True))):
        spec = RunSpec(problem=task.problem, hyper=hy, scheduler=cfg,
                       n_iterations=n_iterations, metrics_every=10,
                       engine="scan")
        run(dataclasses.replace(spec, n_iterations=20))     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(spec)
        torch.cuda.synchronize()
        out[route] = (time.perf_counter() - t0) / n_iterations * 1e3
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("other_src")
    ap.add_argument("--iterations", type=int, default=120)
    ap.add_argument("--measure", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.measure:
        sys.path.insert(0, args.other_src)
        print(json.dumps(measure(args.iterations)))
        return
    sides = {"other": str(Path(args.other_src).resolve()),
             "this": str(HERE)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"other: {sides['other']}\nthis:  {sides['this']}")
    results = []
    for side in ("other", "this", "this", "other"):
        env = dict(os.environ, PYTHONPATH=sides[side])
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), sides[side],
             "--measure",
             "--iterations", str(args.iterations)],
            capture_output=True, text=True, env=env, cwd=sides[side])
        if proc.returncode != 0:
            sys.exit(f"{side} failed:\n{proc.stdout}\n{proc.stderr}")
        ms = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append((side, ms))
        print(f"{side}: " + ", ".join(f"{k} {v:.3f} ms/iteration"
                                      for k, v in ms.items()), flush=True)
    for side in ("other", "this"):
        got = [ms for s, ms in results if s == side]
        print(f"mean {side}: " + ", ".join(
            f"{k} {sum(m[k] for m in got) / len(got):.3f}"
            for k in got[0]))


if __name__ == "__main__":
    main()
