#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` and a checkout of the repository around this
file; exits non-zero, printing no result, without them.  Phases:

1. Environment: Python, torch, CUDA and nvcc versions, the card's name
   and power limit, and the time `nvcc` takes to build the kernels from
   `src/repro_torch/kernels/csrc/cut_kernels.cu`.
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes and a few ragged ones, in f32 and bf16: forward values,
   first and second derivatives through the MV/VM/OUTER autograd
   Functions, bitwise repeatability of `matvec`, and device times (CUDA
   events around back-to-back calls on operands that together overflow
   the L2 cache) beside the memory-rate bound, the plain version and one
   library call.
3. The slice: robust HPO at the white-wine width of the paper's Table 1
   (N=6, S=4, tau=10, one 5x straggler, MLP 11-16-1, K=4, P=8, t_pre=10,
   t1=400), 120 iterations through `run(RunSpec(engine="scan"))` with the
   kernels and, for comparison, with every cut contraction forced onto
   the plain version (after a warm-up, in turns: plain, kernel, kernel,
   plain); the two histories must agree.

4. Where the slice's time goes: 20 iterations (two refreshes) under
   `torch.profiler`: the device's busy share and the kernels that fill
   it.

The line before the nvidia-smi line is a JSON object listing every
ported kernel; the last line is the JSON result.
"""
from __future__ import annotations

import dataclasses
import json
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
L2_BYTES = 50 * 2 ** 20
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores

SHAPES = ((8, 242_628), (8, 57_366), (3, 33), (13, 5_000))
MAIN_SHAPE = SHAPES[0]      # the white-wine cut space, P = p_max = 8
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (5e-2, 5e-2)}
# grad-of-grad entries grow with D (to ~D at the white-wine width), so
# elementwise f32 agreement of two summation orders is out of reach
# there; both routes are held to a float64 computation instead: the
# kernel route's error, relative to the largest entry, may not exceed
# twice the plain route's plus one rounding of the input type
GOG_FLOOR = {"float32": 1e-6, "bfloat16": 1e-2}

SOURCE = "src/repro_torch/kernels/csrc/cut_kernels.cu"
REPLACES = {"matvec": "src/repro/kernels/cut_eval.py:60",
            "vecmat": "src/repro/kernels/cut_eval.py:96",
            "rank1": "src/repro/kernels/cut_eval.py:129"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def close(got, want, rtol, atol) -> float:
    """Max abs error of got vs want; fails beyond rtol/atol."""
    got = got.detach().float().cpu().numpy()
    want = want.detach().float().cpu().numpy()
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    if not np.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"max abs err {err:.3e} beyond rtol={rtol} "
                             f"atol={atol}")
    return err


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def environment():
    import torch
    from repro_torch.kernels import build

    print(f"python {platform.python_version()}  torch {torch.__version__}"
          f"  cuda {torch.version.cuda}")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"nvcc: {nvcc.splitlines()[-1]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)}  "
          f"count {torch.cuda.device_count()}")
    # f32 products in full f32 for every comparison below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.load()
    print(f"kernel build+load: {time.perf_counter() - t0:.2f} s "
          f"({build.library_path().name})", flush=True)
    return smi.splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def operands(p, d, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale) \
            .to(dtype)

    return {"a": rnd(p, d, scale=d ** -0.5), "v": rnd(d), "g": rnd(p),
            "x": rnd(p), "y": rnd(d)}


def median_ms(fn, copies, n_launch=48, reps=7, warmup=3):
    """Median over `reps` of the device time per call of fn, from CUDA
    events around `n_launch` back-to-back calls that cycle through
    operand copies.  At the main path's shapes the copies together span
    twice the 50 MB L2, so every call reads its operands from device
    memory, as the bound assumes.  A sleep kernel holds the stream while
    the host enqueues the calls, so host launch overhead is not timed."""
    import torch
    for o in copies[:warmup]:
        fn(o)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)     # ~25 ms at the H100's clock
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for j in range(n_launch):
            fn(copies[j % len(copies)])
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / n_launch)
    return float(np.median(times))


def work(name, o):
    """(bytes, flops) the function must move and do on these inputs."""
    a, p, d = o["a"], o["a"].shape[0], o["a"].shape[1]
    es = a.element_size()
    if name == "matvec":
        return p * d * es + d * es + p * 4, 2 * p * d
    if name == "vecmat":
        return p * d * es + p * es + d * 4, 2 * p * d
    return p * es + d * es + p * d * 4, p * d


def kernel_phase():
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import cut_eval as K

    calls = {
        "matvec": (lambda o: K.matvec(o["a"], o["v"]),
                   lambda o: K.matvec_ref(o["a"], o["v"]),
                   lambda o: torch.mv(o["a"], o["v"])),
        "vecmat": (lambda o: K.vecmat(o["g"], o["a"]),
                   lambda o: K.vecmat_ref(o["g"], o["a"]),
                   lambda o: o["g"] @ o["a"]),
        "rank1": (lambda o: K.rank1(o["x"], o["y"]),
                  lambda o: K.rank1_ref(o["x"], o["y"]),
                  lambda o: torch.outer(o["x"], o["y"])),
    }
    rows = {}
    print("kernel  dtype     P      D   max_abs_err  ms  plain_ms  "
          "library_ms  bound_ms")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        rtol, atol = TOL[dname]
        for i, (p, d) in enumerate(SHAPES):
            o = operands(p, d, dtype, seed=i)
            n_copies = min(16, -(-2 * L2_BYTES // work("matvec", o)[0]))
            copies = [operands(p, d, dtype, seed=100 + k)
                      for k in range(n_copies)]
            for name, (kern, plain, lib) in calls.items():
                try:
                    err = close(kern(o), plain(o), rtol, atol)
                except AssertionError as e:
                    fail(f"{name} {dname} ({p}, {d}) vs plain: {e}")
                ms = median_ms(kern, copies)
                plain_ms = median_ms(plain, copies)
                lib_ms = median_ms(lib, copies)
                nbytes, flops = work(name, o)
                bound = max(nbytes / HBM_BYTES_PER_S,
                            flops / F32_FLOP_PER_S) * 1e3
                bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= \
                    flops / F32_FLOP_PER_S else "operations"
                print(f"{name:7s} {dname:8s} {p:3d} {d:7d}  {err:.3e}  "
                      f"{ms:.4f}  {plain_ms:.4f}  {lib_ms:.4f}  "
                      f"{bound:.4f}", flush=True)
                if dtype == torch.float32 and (p, d) == MAIN_SHAPE:
                    rows[name] = {
                        "name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": lib_ms}
            if (p, d) == MAIN_SHAPE:
                once = K.matvec(o["a"], o["v"])
                again = K.matvec(o["a"], o["v"])
                check(torch.equal(once, again),
                      f"matvec {dname} not bitwise repeatable")
                print(f"matvec {dname} ({p}, {d}) bitwise repeatable: yes")
            grads_check(o, dname, ops)
    return rows


def grads_check(o, dname, ops):
    """MV's first and second derivatives w.r.t. A and v through the
    kernel route, against plain-torch autograd (first derivatives) and a
    float64 plain computation (grad-of-grad).  The only place OUTER runs
    on the card: the main path never differentiates the cut matrix."""
    import torch
    p, d = o["a"].shape
    c = o["g"].float()
    act = (o["x"].float() > -0.5).float()
    w = o["y"].float()[:p] if d >= p else torch.ones(p, device="cuda")

    def derivs(impl, dtype=None):
        a = o["a"].detach().to(dtype or o["a"].dtype).requires_grad_(True)
        v = o["v"].detach().to(dtype or o["v"].dtype).requires_grad_(True)
        cc, aa, ww = (x.to(dtype or torch.float32) for x in (c, act, w))
        raw = ops.cut_eval(a, v, cc, aa, impl=impl) if dtype is None \
            else (a @ v - cc) * aa
        loss = 0.5 * torch.sum(ww * raw ** 2)
        da, dv = torch.autograd.grad(loss, (a, v), create_graph=True)
        inner = torch.sum(da.to(raw.dtype) ** 2) \
            + torch.sum(dv.to(raw.dtype) ** 2)
        dda, ddv = torch.autograd.grad(inner, (a, v))
        return da, dv, dda, ddv

    rtol, atol = TOL[dname]
    got, want = derivs("kernel"), derivs("ref")
    truth = derivs(None, dtype=torch.float64)
    try:
        errs = [close(got[0], want[0], rtol, atol),
                close(got[1], want[1], rtol, atol)]
    except AssertionError as e:
        fail(f"MV first derivatives {dname} ({p}, {d}): {e}")
    gog = []
    for k, name in ((2, "dda"), (3, "ddv")):
        t = truth[k].detach()
        scale = float(t.abs().max())
        e_k = float((got[k].double() - t).abs().max()) / scale
        e_p = float((want[k].double() - t).abs().max()) / scale
        check(e_k <= 2 * e_p + GOG_FLOOR[dname],
              f"MV grad-of-grad {name} {dname} ({p}, {d}): error "
              f"{e_k:.2e} of max |entry| vs the plain route's {e_p:.2e}")
        gog.append((e_k, e_p))
    print(f"MV grads {dname} ({p}, {d}): max abs err vs plain da "
          f"{errs[0]:.2e} dv {errs[1]:.2e} | grad-of-grad err vs float64 "
          f"(of max |entry|) kernel/plain dda {gog[0][0]:.1e}/"
          f"{gog[0][1]:.1e} ddv {gog[1][0]:.1e}/{gog[1][1]:.1e}",
          flush=True)


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

N_ITERATIONS = 120


def slice_run(hyper, task, cfg, n_iterations=N_ITERATIONS):
    """One white-wine run: (result, seconds, kernel launches in it)."""
    import torch
    from repro_torch.core import RunSpec, run
    from repro_torch.kernels import cut_eval as K

    def metrics(state):
        w = {k: v.mean(0) for k, v in state.X3.items()}
        return {"mse_clean": task.test_mse(w, 0.0),
                "mse_noisy": task.test_mse(w, 0.3, seed=0)}

    spec = RunSpec(problem=task.problem, hyper=hyper, scheduler=cfg,
                   n_iterations=n_iterations, metrics_every=10,
                   metrics_fn=metrics, engine="scan")
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    res = run(spec)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return res, elapsed, dict(K.LAUNCHES)


def slice_phase(rows):
    from repro_torch.apps.robust_hpo import (default_hyper,
                                             make_robust_hpo_problem)
    from repro_torch.core import StragglerConfig

    n, s, tau = 6, 4, 10
    task = make_robust_hpo_problem("white_wine", n_workers=n, seed=0,
                                   device="cuda")
    hyper = default_hyper(task, n, s, tau)
    cfg = StragglerConfig(n_workers=n, s_active=s, tau=tau, n_stragglers=1,
                          straggler_slowdown=5.0, seed=0)

    plain = dataclasses.replace(hyper, cut_impl="ref")
    # the first use of each kernel loads its module: keep that out of the
    # timed runs, which then go in turns (plain, kernel, kernel, plain);
    # the first kernel run is the main path whose launches are counted
    for hy in (hyper, plain):
        slice_run(hy, task, cfg, n_iterations=20)
    ref, ref_elapsed, ref_launches = slice_run(plain, task, cfg)
    res, elapsed, launches = slice_run(hyper, task, cfg)
    elapsed_2 = slice_run(hyper, task, cfg)[1]
    ref_elapsed_2 = slice_run(plain, task, cfg)[1]
    h = res.history
    a_shape = tuple(res.state.cuts_ii.a.shape)
    print(f"white-wine slice (kernel route): cut matrix {a_shape}, "
          f"{elapsed:.2f} s for {N_ITERATIONS} iterations", flush=True)
    check(a_shape == MAIN_SHAPE, f"cut matrix {a_shape} != {MAIN_SHAPE}")
    for k in ("t", "gap_sq", "mse_clean", "mse_noisy", "n_cuts_i",
              "n_cuts_ii"):
        print(f"  {k:9s} " + " ".join(f"{x:.6g}" for x in h[k]))
    for k in ("gap_sq", "mse_clean", "mse_noisy", "n_cuts_i", "n_cuts_ii"):
        check(bool(np.all(np.isfinite(h[k]))), f"{k} not finite")
    check(h["gap_sq"][-1] < h["gap_sq"][0], "gap_sq did not decrease")
    check(h["mse_noisy"][-1] < h["mse_noisy"][0],
          "noisy test MSE did not decrease")
    print("  launches: " + ", ".join(
        f"{k} {launches.get(k, 0)} ({launches.get(k, 0) / N_ITERATIONS:.2f}"
        "/iteration)" for k in rows))
    st = res.state
    print(f"  final multipliers: max lam {float(st.lam.max()):.3e}, max "
          f"gamma_k {float(st.gamma_k.max()):.3e}, max inner2.s "
          f"{float(st.inner2.s.max()):.3e}")
    for k in ("matvec", "vecmat"):
        check(launches.get(k, 0) > 0, f"{k} never launched on the main path")
    for k in rows:
        rows[k]["launches"] = int(launches.get(k, 0))

    check(sum(ref_launches.values()) == 0,
          f"the plain route launched kernels: {ref_launches}")
    hr = ref.history
    ms = [x / N_ITERATIONS * 1e3 for x in (ref_elapsed, elapsed, elapsed_2,
                                            ref_elapsed_2)]
    print("white-wine slice ms/iteration in turns (plain, kernel, kernel, "
          "plain): " + ", ".join(f"{x:.3f}" for x in ms))
    for k in ("gap_sq", "mse_clean", "mse_noisy"):
        rel = float(np.max(np.abs(h[k] - hr[k]) / np.abs(hr[k])))
        print(f"  kernel vs plain route {k}: max rel diff {rel:.3e}")
        check(bool(np.allclose(h[k], hr[k], rtol=1e-4, atol=0.0)),
              f"{k} kernel vs plain route beyond rtol 1e-4")
    for k in ("n_cuts_i", "n_cuts_ii"):
        check(list(h[k]) == list(hr[k]), f"{k} differs between routes")
    return (ms[1] + ms[2]) / 2, task, hyper, cfg


def profile_phase(task, hyper, cfg):
    """Device time of 20 slice iterations (two refreshes) by kernel, and
    the device's busy share of the wall time, under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import RunSpec, run

    spec = RunSpec(problem=task.problem, hyper=hyper, scheduler=cfg,
                   n_iterations=20, metrics_every=10)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(spec)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            n, us = by_name.get(ev.name, (0, 0.0))
            by_name[ev.name] = (n + 1, us + ev.time_range.elapsed_us())
    busy_us = sum(us for _, us in by_name.values())
    check(busy_us > 0, "the profiler saw no device time")
    ours = sum(us for name, (_, us) in by_name.items()
               if "matvec" in name or "vecmat" in name
               or "rank1" in name)
    n_kernels = sum(n for n, _ in by_name.values())
    print(f"profile (20 iterations, profiler on): wall {wall_us / 1e3:.1f}"
          f" ms, device busy {busy_us / 1e3:.2f} ms "
          f"({100 * busy_us / wall_us:.1f}%), {n_kernels} kernels, cut "
          f"kernels {ours / 1e3:.3f} ms ({100 * ours / busy_us:.1f}% of "
          "busy)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (n, us) in top:
        print(f"  {us / 1e3:8.3f} ms  {n:6d}x  {name[:90]}")


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail("src/repro_torch is not beside chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    smi = environment()
    rows = kernel_phase()
    ms_per_it, task, hyper, cfg = slice_phase(rows)
    profile_phase(task, hyper, cfg)
    print(f"slice ms/iteration (kernel route, mean of two runs): "
          f"{ms_per_it:.3f}")
    print(json.dumps({"kernels": [rows[k] for k in
                                  ("matvec", "vecmat", "rank1")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
