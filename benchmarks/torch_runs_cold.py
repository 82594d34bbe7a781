"""The batched cut kernels at white wine (R = 2 and 4, f32) against R x
the single-run kernel, with the single-run reference timed on cold
operands (every run of every batched copy cycled, so its operands span
twice the L2 cache as the batched call's do) and, beside it, on run 0 of
each copy alone (the reference `chip_smoke.py` phase 11 took before it
cycled every run).  Needs the card.

    python3 benchmarks/torch_runs_cold.py [SRC ...]

Each SRC is a checkout's `src` directory (default: this checkout's),
timed in its own process in the order given, so another commit's kernels
compare in one call, e.g. `_checkout/parent/src src src
_checkout/parent/src`.  The kernels' Python API used here (`matvec` and
`fused_cut_round` on batched and single-run operands) is the same since
the sweep engine landed.  Prints one JSON line per SRC, R and kernel.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(src: str) -> None:
    sys.path[:0] = [src, str(ROOT)]
    import torch

    import chip_smoke as c
    from repro_torch.kernels import build
    from repro_torch.kernels import cut_eval as K
    from repro_torch.kernels import inner_round as R

    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()
    p, d = c.MAIN_SHAPE
    f32 = torch.float32
    for r in (2, 4):
        o = c.batched_operands(r, p, d, f32, seed=0)
        n = min(16, -(-2 * c.L2_BYTES
                      // (r * c.work("matvec", {"a": o["a"][0]})[0])))
        copies = [c.batched_operands(r, p, d, f32, seed=100 + k)
                  for k in range(n)]
        rounds = [c.stack_runs([c.round_operands(p, d, f32, 600 + 10 * k + j)
                                for j in range(r)]) for k in range(n)]
        kernels = {
            "matvec_runs": (lambda o: K.matvec(o["a"], o["v"]),
                            lambda o, k: K.matvec(o["a"][k], o["v"][k]),
                            copies),
            "fused_round_runs": (
                lambda o: R.fused_cut_round(
                    *(o[a] for a in c.ROUND_ARGS), **c.FUSED_STEPS),
                lambda o, k: R.fused_cut_round(
                    *(o[a][k] for a in c.ROUND_ARGS), **c.FUSED_STEPS),
                rounds)}
        for name, (batched, single, ops) in kernels.items():
            ms = c.median_ms(batched, ops)
            cold = c.median_ms(lambda ck: single(*ck),
                               c.single_copies(ops, r))
            warm = c.median_ms(lambda o: single(o, 0), ops)
            print(json.dumps({
                "src": src, "kernel": name, "R": r, "shape": [p, d],
                "us": round(ms * 1e3, 2),
                "single_cold_us": round(cold * 1e3, 2),
                "single_run0_us": round(warm * 1e3, 2),
                "share_cold": round(ms / (r * cold), 4),
                "share_run0": round(ms / (r * warm), 4)}), flush=True)


def main(argv) -> None:
    if argv[:1] == ["--one"]:
        one(argv[1])
        return
    for src in argv or [str(ROOT / "src")]:
        subprocess.run([sys.executable, __file__, "--one", src], check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
