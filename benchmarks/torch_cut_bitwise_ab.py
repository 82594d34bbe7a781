#!/usr/bin/env python3
"""Bitwise A/B of the port's cut kernels between two checkouts, on the
card.

    python3 benchmarks/torch_cut_bitwise_ab.py OTHER_SRC

OTHER_SRC is the `src` directory of another checkout of the repository
(unpack it with `git archive <commit> | tar -x -C _checkout/other`).
Each tree runs in its own process, which builds that tree's kernels with
nvcc and writes to a temporary directory, on the operands of this tree's
`chip_smoke.py` (the same seeds):

- phase 2's single-run `matvec`, `vecmat` and `rank1` at every shape of
  `SHAPES`, f32 and bf16;
- phase 3's single-run fused round at white wine (the branch-taking
  operands), domain adaptation, (3, 1,025) and (64, 242,628), f32 and
  bf16;
- phase 11's batched `matvec_runs`, `vecmat_runs` and `rank1_runs` at
  every `SWEEP_SHAPES` entry, f32 and bf16, with a shared operand at run
  stride 0, and at R = 3, 5 and 8; the batched fused round at white wine,
  R = 2, 4 and 8 (f32), at each tree's own plan;

with the kernel launches each output took.  This process then holds each
pair to `torch.equal` and exits 1 on any difference.  Imports neither
jax nor the reference package.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def emit(src: str, out_dir: str) -> None:
    """Write this tree's outputs to `out_dir` (run in a child process)."""
    sys.path[:0] = [src, str(ROOT)]
    import torch
    import chip_smoke as c
    from repro_torch.kernels import build
    from repro_torch.kernels import cut_eval as K
    from repro_torch.kernels import inner_round as R

    t0 = time.perf_counter()
    build.load()
    print(f"{src}: {build.library_path().name} built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out = {}

    def keep(key, fn):
        K.reset_launches()
        got = fn()
        out[key] = [t.cpu() for t in got] if isinstance(got, tuple) \
            else got.cpu()
        out[f"launches {key}"] = dict(K.LAUNCHES)

    def expand(x):
        return x[0].expand(x.shape)

    steps = c.FUSED_STEPS
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            for i, (p, d) in enumerate(c.SHAPES):
                o = c.operands(p, d, dtype, seed=i)
                keep(f"matvec {dname} {p} {d}",
                     lambda: K.matvec(o["a"], o["v"]))
                keep(f"vecmat {dname} {p} {d}",
                     lambda: K.vecmat(o["g"], o["a"]))
                keep(f"rank1 {dname} {p} {d}",
                     lambda: K.rank1(o["x"], o["y"]))
            for i, (p, d) in enumerate((c.MAIN_SHAPE, c.DA_SHAPE, (3, 1_025),
                                        c.OVER_SHAPE)):
                if (p, d) == c.MAIN_SHAPE:
                    o, _ = c.branch_operands(p, d, dtype, R)
                else:
                    o = c.round_operands(p, d, dtype, seed=200 + i)
                keep(f"fused_round {dname} {p} {d}",
                     lambda: R.fused_cut_round(
                         *(o[k] for k in c.ROUND_ARGS), **steps))
            shapes = c.SWEEP_SHAPES + ((3,) + c.MAIN_SHAPE,
                                       (5, 8, 57_366), (8, 13, 5_001))
            for i, (r, p, d) in enumerate(shapes):
                o = c.batched_operands(r, p, d, dtype, seed=i)
                keep(f"matvec_runs {dname} {r} {p} {d}",
                     lambda: K.matvec(o["a"], o["v"]))
                keep(f"matvec_runs shared v {dname} {r} {p} {d}",
                     lambda: K.matvec(o["a"], expand(o["v"])))
                keep(f"vecmat_runs {dname} {r} {p} {d}",
                     lambda: K.vecmat(o["g"], o["a"]))
                keep(f"rank1_runs {dname} {r} {p} {d}",
                     lambda: K.rank1(o["x"], o["y"]))
        p, d = c.MAIN_SHAPE
        for r in (2, 4, 8):
            o = c.stack_runs([c.round_operands(p, d, torch.float32, 500 + k)
                              for k in range(r)])
            keep(f"fused_round_runs float32 {r} {p} {d}",
                 lambda: R.fused_cut_round(*(o[k] for k in c.ROUND_ARGS),
                                           **steps))
    torch.save(out, Path(out_dir) / "out.pt")


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--emit":
        emit(argv[1], argv[2])
        return 0
    if len(argv) != 1:
        print(__doc__)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    trees = {"this": str(ROOT / "src"), "other": str(Path(argv[0]).resolve())}
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, src in trees.items():
            d = Path(tmp) / label
            d.mkdir()
            subprocess.run([sys.executable, __file__, "--emit", src, str(d)],
                           check=True)
            outs[label] = torch.load(d / "out.pt")
    this, other = outs["this"], outs["other"]
    if set(this) != set(other):
        print("FAIL: the two trees wrote different keys", file=sys.stderr)
        return 1
    same, n = True, 0
    for key in this:
        if key.startswith("launches"):
            eq = this[key] == other[key]
            if not eq:
                print(f"{key}: {this[key]} / {other[key]} (DIFFER)")
            same = same and eq
            continue
        pair = zip(this[key], other[key]) if isinstance(this[key], list) \
            else [(this[key], other[key])]
        eq = all(torch.equal(x, y) for x, y in pair)
        n += 1
        print(f"{key}: torch.equal {eq}")
        same = same and eq
    print(f"{n} outputs; bitwise equal: " + ("yes" if same else "NO"),
          flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
