#!/usr/bin/env python3
"""The designs tried for the sweep engine's batched cut kernels, timed on
the card beside the port's.

    python3 benchmarks/torch_cut_runs_designs.py

1. The batched matvec in f32 at (R, P, D) = (2, 8, 242,628), (4, 8,
   242,628) and (2, 2, 925,590): the port's `cut_matvec_runs` (the
   single-run grid a run, grid y), R x its single-run kernel, and the
   persistent design of `benchmarks/cut_matvec_runs_ring.cu` (the resident
   blocks walking (run, chunk) items, each item's rows and slice of v
   copied into a ring of 2 or 3 shared-memory stages by `cp.async.bulk`
   or by 16-byte `cp.async`).  That file includes the port's
   `cut_kernels.cu` and is built here with nvcc into
   `src/repro_torch/kernels/csrc/build/designs/`.  Every ring output is
   held to the port's with `torch.equal` and every ticket to 0.
2. The batched fused round at white wine, R = 2 and 4, through the
   port's own kernel at explicit plans (`inner_round.fused_cut_round(...,
   plan=)`): A on chip, 7 of its 8 rows on chip, or streamed, each held
   to the planned launch's bits.

Device times by CUDA events around back-to-back calls on operands that
overflow the L2 cache (`chip_smoke.median_ms`), the designs of one shape
timed in turns in one process.  Prints a table; no gate.  Imports
neither jax nor the reference package.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
RING = ROOT / "benchmarks" / "cut_matvec_runs_ring.cu"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = CSRC / "build" / "designs"
# (copy kind, stages) of the persistent design
RING_DESIGNS = ((1, 2), (1, 3), (0, 2), (0, 3))


def ring_lib(build):
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / "cut_matvec_runs_ring.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                    "-I", str(CSRC), "-shared", "-o", str(so), str(RING)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ring_smem.argtypes = [i, ll, i]
    lib.ring_smem.restype = ll
    lib.ring_occupancy.argtypes = [i, i, ll]
    lib.ring_occupancy.restype = i
    lib.ring_matvec_runs.argtypes = [p, ll, p, ll, p, p, p, i, i, ll, i, ll,
                                     i, i, i, ll, p]
    lib.ring_matvec_runs.restype = i
    return lib


def matvec_designs(c, torch, K, lib):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    print("matvec f32, us: the port's matvec_runs | R x its single-run "
          "kernel | persistent ring designs (copies, stages, blocks)")
    for i, (r, p, d) in enumerate(c.SWEEP_SHAPES):
        o = c.batched_operands(r, p, d, torch.float32, seed=i)
        n_copies = min(16, -(-2 * c.L2_BYTES // (r * 4 * p * d)))
        copies = [c.batched_operands(r, p, d, torch.float32, seed=100 + k)
                  for k in range(n_copies)]
        blocks, cw = K._cut_grid(0, p, d, 4)
        partial = torch.empty((r, p, blocks), device="cuda")
        tickets = torch.zeros(r, dtype=torch.int32, device="cuda")
        out = torch.empty((r, p), device="cuda")
        rings = {}
        for bulk, stages in RING_DESIGNS:
            smem = lib.ring_smem(p, cw, stages)
            per_sm = lib.ring_occupancy(p, bulk, smem)
            if per_sm < 1:
                continue
            grid = min(r * blocks, per_sm * sms)

            def ring(x, bulk=bulk, stages=stages, smem=smem, grid=grid):
                err = lib.ring_matvec_runs(
                    x["a"].data_ptr(), x["a"].stride(0), x["v"].data_ptr(),
                    x["v"].stride(0), partial.data_ptr(), tickets.data_ptr(),
                    out.data_ptr(), r, p, d, blocks, cw, grid, stages, bulk,
                    smem, stream)
                if err:
                    raise RuntimeError(f"ring_matvec_runs: CUDA error {err}")
                return out
            label = (f"{'bulk' if bulk else 'cp.async'} x{stages} "
                     f"({grid}, {per_sm} an SM)")
            rings[label] = ring
        want = K.matvec(o["a"], o["v"])
        same = {label: torch.equal(ring(o).clone(), want)
                for label, ring in rings.items()}
        torch.cuda.synchronize()
        assert int(tickets.abs().sum()) == 0, "a ring ticket was left set"
        port = c.median_ms(lambda x: K.matvec(x["a"], x["v"]), copies)
        single = c.median_ms(lambda x: K.matvec(x["a"][0], x["v"][0]),
                             copies)
        times = {label: c.median_ms(ring, copies)
                 for label, ring in rings.items()}
        print(f"  ({r}, {p}, {d}) {blocks} chunks of {cw}: port "
              f"{port * 1e3:.2f} | R x single {r * single * 1e3:.2f} | "
              + "; ".join(f"{label} {ms * 1e3:.2f}"
                          + ("" if same[label] else " (bits differ)")
                          for label, ms in times.items()), flush=True)


def round_plans(c, torch, R):
    p, d = c.MAIN_SHAPE
    print("fused round at white wine, f32, us (plan: blocks a run, "
          "columns, rows on chip)")
    for r in (2, 4):
        def ops_of(seed):
            return c.stack_runs([c.round_operands(p, d, torch.float32,
                                                  seed + k)
                                 for k in range(r)])
        o = ops_of(500)
        copies = [ops_of(600 + 10 * k) for k in range(min(16, -(
            -2 * c.L2_BYTES // (r * c.round_work({"a": o["a"][0]})[0]))))]
        base = R.plan_for(o["a"])
        plans = {"the plan": base}
        if base.on_chip:
            plans["7 of 8 rows on chip"] = base._replace(
                on_chip=False, rows_on_chip=7,
                smem=R.round_smem(p, base.cw, 4, False, 7))
        plans["streamed"] = base._replace(
            on_chip=False, rows_on_chip=0,
            smem=R.round_smem(p, base.cw, 4, False))
        want = R.fused_cut_round(*(o[k] for k in c.ROUND_ARGS),
                                 **c.FUSED_STEPS)
        for label, plan in plans.items():
            got = R.fused_cut_round(*(o[k] for k in c.ROUND_ARGS), plan=plan,
                                    **c.FUSED_STEPS)
            same = all(torch.equal(x, y) for x, y in zip(got, want))
            ms = c.median_ms(lambda x: R.fused_cut_round(
                *(x[k] for k in c.ROUND_ARGS), plan=plan, **c.FUSED_STEPS),
                copies)
            print(f"  R={r} {label:20s} ({plan.blocks}, {plan.cw}, "
                  f"{plan.rows_on_chip}): {ms * 1e3:7.2f} (bits as the "
                  f"plan's: {same})", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as c
    from repro_torch.kernels import build
    from repro_torch.kernels import cut_eval as K
    from repro_torch.kernels import inner_round as R
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    build.load()
    matvec_designs(c, torch, K, ring_lib(build))
    round_plans(c, torch, R)
    return 0


if __name__ == "__main__":
    sys.exit(main())
