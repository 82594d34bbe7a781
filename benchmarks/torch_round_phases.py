"""Where the PyTorch port's fused round kernel spends its time on the card.

    python3 benchmarks/torch_round_phases.py

Needs a CUDA card and nvcc.  Builds `src/repro_torch/kernels/csrc/
inner_round.cu` as it is and three variants cut short at a phase
boundary, into `csrc/build/phases/`, and times each through
`inner_round.fused_cut_round` (CUDA events around 48 back-to-back calls
on 16 operand copies, median of 7) at white-wine (8, 242,628) and domain
adaptation (2, 925,590), f32 and bf16:

    launch     the kernel returns at once (the launch and its end)
    phase 0    returns after the bulk copies of v and A and the partial
               sums of A v
    phase 1 w  skips phase 1's column pass (g_cut, v_new, A v_new) and
               keeps the grid barrier, the weights from the partials, the
               ticket and the epilogue
    full       the kernel

The differences of consecutive rows split the round's time.  A variant
that returns early leaves the stream's counter untouched; the others add
to it and reset it as the kernel does.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = CSRC / "build" / "phases"
STEPS = dict(eta_z=0.05, eta_s=0.05, eta_dual=0.05, rho2=1.0)
ARGS = ("a", "v", "g_other", "mask", "c", "active", "s", "gamma")
SHAPES = ((8, 242_628), (2, 925_590))


def variants(src: str) -> dict:
    def cut(marker: str) -> int:
        i = src.find(marker)
        if i < 0:
            raise SystemExit(f"marker not in inner_round.cu: {marker!r}")
        return i

    phase0 = cut("  // phase 0: the slices on their way")
    late = cut("  // g_other and mask, needed after the barrier")
    column = cut("  if constexpr (kVecs) mbar_wait(bar(1), 0);")
    epilogue = cut("  // epilogue: the last block")
    return {"launch": src[:phase0] + "  return;\n" + src[phase0:],
            "phase 0": src[:late] + "  return;\n" + src[late:],
            "phase 1 w": src[:column] + src[epilogue:],
            "full": src}


def build(name: str, text: str, nvcc: str, flags) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    stem = name.replace(" ", "_")
    cu, so = OUT / f"{stem}.cu", OUT / f"{stem}.so"
    cu.write_text(text)
    subprocess.run([nvcc, *flags, "-I", str(CSRC), "-shared", "-o", str(so),
                    str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    lib.fused_cut_round_scratch.argtypes = [i, i]
    lib.fused_cut_round_scratch.restype = ll
    lib.fused_cut_round_occupancy.argtypes = [i, i, ll, i]
    lib.fused_cut_round_occupancy.restype = i
    lib.fused_cut_round.argtypes = [p, i, *([p] * 13), i, ll, i, ll, i, i,
                                    ll, f, f, f, f, p]
    lib.fused_cut_round.restype = i
    return lib


def operands(torch, p, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    active = (rnd(p) > -0.4).float()
    active[0] = 1.0
    return {"a": rnd(p, d, scale=d ** -0.5).to(dtype), "v": rnd(d),
            "g_other": rnd(d),
            "mask": (torch.arange(d, device="cuda") % 3 > 0).float(),
            "c": rnd(p), "active": active, "s": rnd(p).abs(),
            "gamma": rnd(p).abs()}


def median_us(torch, fn, copies, n_launch=48, reps=7):
    for o in copies[:3]:
        fn(o)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for j in range(n_launch):
            fn(copies[j % len(copies)])
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / n_launch)
    return float(np.median(times)) * 1e3


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import cut_eval as K
    from repro_torch.kernels import inner_round as R

    text = variants((CSRC / "inner_round.cu").read_text())
    libs = {name: build(name, t, kbuild._nvcc(), kbuild.NVCC_FLAGS)
            for name, t in text.items()}
    cases = [(p, d, dtype) for dtype in (torch.float32, torch.bfloat16)
             for p, d in SHAPES]
    copies = {c: [operands(torch, *c, seed=300 + k) for k in range(16)]
              for c in cases}

    def kern(o):
        return R.fused_cut_round(*(o[k] for k in ARGS), **STEPS)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    print("variant    " + "  ".join(f"({p}, {d}) {str(t)[6:]:8s}"
                                     for p, d, t in cases) + "  (us)")
    for name, lib in libs.items():
        kbuild._lib = lib           # the wrapper launches this variant
        R._plan.cache_clear()
        K._ticket(copies[cases[0]][0]["a"]).zero_()
        print(f"{name:10s} " + "  ".join(
            f"{median_us(torch, kern, copies[c]):22.2f}" for c in cases),
            flush=True)
        K._ticket(copies[cases[0]][0]["a"]).zero_()


if __name__ == "__main__":
    main()
