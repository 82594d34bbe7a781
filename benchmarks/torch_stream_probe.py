#!/usr/bin/env python3
"""Card probe of the port's streamed quadratic problem (no gate).

    python3 benchmarks/torch_stream_probe.py

Needs one CUDA card; builds the kernels like `chip_smoke.py`.  Three
parts, each printed:

1. Scales.  The registry's streamed quadratic (`chip_smoke.
   quadratic_stream_setup`) at dim 16,384 with b at 1 per entry (the
   registry's scale), at dim 16,384 with A and b held at the registry's
   dim-3 norms (phase 12's (a)), and at dim 4,096 with b at 1 per entry
   (phase 12's (a')): 60 iterations on the cut-kernel and the plain
   route, the gap every 5th iteration, the cut counts, the final
   multipliers and the routes' relative gap difference.
2. Host cost of the routes: 10 iterations of the dim-4,096 problem on
   each route in turns, unprofiled ms per iteration, then under
   torch.profiler the synchronising calls and the autograd Functions'
   host time.
3. Host cost of drawing a batch: `stream.generator` on the card, and
   `next_batch` at the quickstart width (4 workers, dim 3).
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402


def scales_part():
    from repro_torch.core import RunSpec, StragglerScheduler

    for dim, b_unit in ((16_384, True), (16_384, False), (4_096, True)):
        problem, hyper, cfg, stream = smoke.quadratic_stream_setup(dim,
                                                                   b_unit)
        spec = RunSpec(problem=problem, hyper=hyper, metrics_every=5,
                       schedule=StragglerScheduler(cfg).precompute(60),
                       data=stream)
        gaps = {}
        for name, hy in (("kernel", hyper),
                         ("plain", dataclasses.replace(hyper,
                                                       cut_impl="ref"))):
            res, secs, _ = smoke.timed_run(dataclasses.replace(spec,
                                                               hyper=hy))
            h, st = res.history, res.state
            print(f"dim {dim:,}, b {'1 per entry' if b_unit else 'held'}, "
                  f"{name}: {secs / 60 * 1e3:.3f} ms/iteration (first run "
                  "of the shape included)", flush=True)
            for k in ("gap_sq", "n_cuts_i", "n_cuts_ii"):
                print(f"   {k}: " + " ".join(f"{x:.6g}" for x in h[k]))
            print(f"   lam {float(st.lam.max()):.4g}, gamma_k "
                  f"{float(st.gamma_k.max()):.4g}, inner2.gamma "
                  f"{float(st.inner2.gamma.max()):.4g}", flush=True)
            gaps[name] = h["gap_sq"]
        with np.errstate(invalid="ignore"):
            rel = np.abs(gaps["kernel"] - gaps["plain"]) \
                / np.abs(gaps["plain"])
        print("   kernel vs plain gap, relative: "
              + " ".join(f"{x:.2e}" for x in rel), flush=True)
        del problem, stream, spec


def routes_part():
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import RunSpec, StragglerScheduler, run

    problem, hyper, cfg, stream = smoke.quadratic_stream_setup(4_096,
                                                               b_unit=True)
    n = 10
    spec = RunSpec(problem=problem, hyper=hyper, metrics_every=5,
                   schedule=StragglerScheduler(cfg).precompute(n),
                   data=stream)
    plain = dataclasses.replace(hyper, cut_impl="ref")
    for name, hy in (("kernel", hyper), ("plain", plain), ("plain", plain),
                     ("kernel", hyper)):
        one = dataclasses.replace(spec, hyper=hy)
        run(one)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(one)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(one)
            torch.cuda.synchronize()
        events = prof.key_averages()
        syncs = sum(e.count for e in events if "Synchronize" in e.key)
        fn_ms = sum(e.self_cpu_time_total for e in events
                    if e.key.startswith(("MVGenerated", "VMGenerated",
                                         "OUTERGenerated"))) / 1e3
        print(f"routes, {name}: {ms:.3f} ms/iteration unprofiled; under "
              f"the profiler {syncs} synchronising calls in {n} "
              f"iterations, the cut Functions' own host time "
              f"{fn_ms / n:.3f} ms/iteration", flush=True)


def draw_part():
    from repro_torch.data import stream as stream_lib
    from repro_torch.experiments.engine_speed import quickstart_stream

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(1000):
        stream_lib.generator(k, "cuda")
    gen_us = (time.perf_counter() - t0) * 1e3
    stream = quickstart_stream()
    stream_lib.next_batch(stream, 0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for it in range(100):
        stream_lib.next_batch(stream, np.full(4, it), device="cuda")
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 10
    print(f"draws: stream.generator on the card {gen_us:.1f} us a call; "
          f"next_batch at 4 x dim 3 {batch_ms:.3f} ms a call (host clock, "
          "synchronised at both ends)", flush=True)


def main():
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: this probe needs a "
                   "CUDA card")
    print(smoke.environment(), flush=True)
    scales_part()
    routes_part()
    draw_part()


if __name__ == "__main__":
    main()
