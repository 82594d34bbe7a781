#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` and a checkout of the repository around this
file; exits non-zero, printing no result, without them.  Phases:

1. Environment: Python, torch, CUDA and nvcc versions, the card's name
   and power limit, and the time `nvcc` takes to build every kernel
   source under `src/repro_torch/kernels/csrc/` (one nvcc per source,
   all at once).
2. Cut kernels against their plain PyTorch versions on the card, at the
   main paths' shapes (white-wine (8, 242,628), domain adaptation (2,
   925,590)) and a few ragged ones, in f32 and bf16: forward values,
   first and second derivatives through the MV/VM/OUTER autograd
   Functions, bitwise repeatability of `matvec`, and device times (CUDA
   events around back-to-back calls on operands that together overflow
   the L2 cache) beside the memory-rate bound, the plain version and one
   library call.
3. The fused level-2 round kernel against its plain version at both main
   shapes, f32 and bf16: values of v_new / cv1 / s_new / gamma_new, a
   bitwise repeat, first derivatives and grad-of-grad through
   `FusedRound`, and device times beside the bound, the plain version and
   the three-call composition torch.mv / g @ A / torch.mv.
4. White-wine robust HPO (Table 1: N=6, S=4, tau=10, one 5x straggler,
   MLP 11-16-1, K=4, P=8, t_pre=10, t1=400), 120 iterations through
   `run(RunSpec(engine="scan"))` in four routes: the plain cut route and
   the cut kernels (PR 11's main path), and with
   `Hyper(use_fused_inner=True)` the plain fused round and the fused
   kernel; after a warm-up, in turns.  Histories, cut counts and the
   final II-layer cuts, gamma_k and inner level-2 state must agree.
5. Domain adaptation (§5.2, Table 1's SVHN-pretrain setting: N=6, S=3,
   two 5x stragglers, tau=15, three LeNet-5s, 24/12 pretrain/finetune
   digits per worker, K=1, P=2, t_pre=20), 40 iterations with
   `use_fused_inner=True` through the kernels and through the plain
   versions; cuDNN held to f32 and deterministic algorithms.
6. Where the time goes: 20 iterations of white-wine (cut kernels, then
   the fused kernel; two refreshes each) and of domain adaptation (one
   refresh) under `torch.profiler`: the device's busy share and the
   kernels that fill it.
7. The LLM kernels against their plain versions on the card: flash
   attention at Llama-3 8B's prefill shape (B 4, S = T = 1024, H 32,
   Hkv 8, hd 128; windows 0 and 1024) and two ragged shapes, in bf16
   through the tensor-core kernel (plus Whisper's heads, hd 64, S = T =
   1500) and in f32 through the SIMT kernel, each launch checked against
   `flash_route`; the mLSTM chunk kernel at xLSTM-125M's chunk (B 4, H 4,
   L 256, hd 192) and at L = 100, with a carried state, f32 and bf16;
   bitwise repeats, device times beside the bound, the plain version and
   (flash only) `scaled_dot_product_attention`, a yardstick the port
   never calls, and the SIMT kernel's time on the same bf16 inputs.
8. Llama-3 8B serving at full width and depth (bf16, random weights from
   seed 0): `serve(batch=4, prompt_len=1024, gen=32)` on the kernel route
   and on the plain route; prefill logits of the two routes compared, and
   again in f32 with the depth cut to 2 layers; one prefill under
   `torch.profiler`.  The bf16 prefill launches the tensor-core flash
   kernel 32 times and the SIMT kernel never; the f32 one only the SIMT
   kernel.
9. xLSTM-125M serving at its full config (bf16): the same, with the f32
   run at full depth.

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

MAIN_SHAPE = (8, 242_628)   # the white-wine cut space, P = p_max = 8
DA_SHAPE = (2, 925_590)     # domain adaptation, N=6: 15 LeNets' columns
SHAPES = (MAIN_SHAPE, DA_SHAPE, (8, 57_366), (3, 33), (13, 5_000))
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (5e-2, 5e-2)}
# grad-of-grad entries grow with D (to ~D at the white-wine width), so
# elementwise f32 agreement of two summation orders is out of reach
# there; both routes are held to a float64 computation instead: the
# kernel route's error, relative to the largest entry, may not exceed
# twice the plain route's plus one rounding of the input type
GOG_FLOOR = {"float32": 1e-6, "bfloat16": 1e-2}

SOURCES = {"matvec": "src/repro_torch/kernels/csrc/cut_kernels.cu",
           "vecmat": "src/repro_torch/kernels/csrc/cut_kernels.cu",
           "rank1": "src/repro_torch/kernels/csrc/cut_kernels.cu",
           "fused_round": "src/repro_torch/kernels/csrc/inner_round.cu",
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
           "flash_attention_simt":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "mlstm_chunk": "src/repro_torch/kernels/csrc/mlstm_chunk.cu"}
REPLACES = {"matvec": "src/repro/kernels/cut_eval.py:60",
            "vecmat": "src/repro/kernels/cut_eval.py:96",
            "rank1": "src/repro/kernels/cut_eval.py:129",
            "fused_round": "src/repro/kernels/inner_round.py:53",
            "flash_attention": "src/repro/kernels/flash_attention.py:26",
            "flash_attention_simt":
                "src/repro/kernels/flash_attention.py:26",
            "mlstm_chunk": "src/repro/kernels/mlstm_chunk.py:25"}
KERNELS = tuple(REPLACES)
STEP_NAMES = ("eta_z", "eta_s", "eta_dual", "rho2")


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
          f"({build.library_path().name}, "
          f"{len(build.SOURCES)} sources)", flush=True)
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


def bound_of(nbytes, t_ops):
    """(ms, what bounds it): the least time for the work on this card,
    the larger of the bytes over the memory rate and `t_ops`, the seconds
    its operations take at their types' peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


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
                bound, bound_by = bound_of(nbytes, flops / F32_FLOP_PER_S)
                print(f"{name:7s} {dname:8s} {p:3d} {d:7d}  {err:.3e}  "
                      f"{ms:.4f}  {plain_ms:.4f}  {lib_ms:.4f}  "
                      f"{bound:.4f}", flush=True)
                if dtype == torch.float32 and (p, d) == MAIN_SHAPE:
                    rows[name] = {
                        "name": name, "route": "cuda",
                        "source": SOURCES[name],
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
    # row 0 always active, so the second derivatives are not all zero
    # (at P = 2 every row may draw inactive)
    act = (o["x"].float() > -0.5).float()
    act[0] = 1.0
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

FUSED_STEPS = dict(eta_z=0.05, eta_s=0.05, eta_dual=0.05, rho2=1.0)
ROUND_ARGS = ("a", "v", "g_other", "mask", "c", "active", "s", "gamma")


def round_operands(p, d, dtype, seed):
    """One round's operands: A scaled so A v is O(1), a third of the
    columns masked out, about a third of the cuts inactive (row 0
    active)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    active = (rnd(p) > -0.4).float()
    active[0] = 1.0      # at P = 2 every row may draw inactive
    return {"a": rnd(p, d, scale=d ** -0.5).to(dtype), "v": rnd(d),
            "g_other": rnd(d),
            "mask": (torch.arange(d, device="cuda") % 3 > 0).float(),
            "c": rnd(p), "active": active,
            "s": rnd(p).abs(), "gamma": rnd(p).abs()}


def round_work(o):
    """(bytes, flops) of one round: A and the three D-vectors read once,
    v_new written once, the (P,) rows in and out; three passes of 2PD
    operations over A plus the D-wide update."""
    p, d = o["a"].shape
    nbytes = p * d * o["a"].element_size() + 3 * d * 4 + d * 4 \
        + 4 * p * 4 + 3 * p * 4
    return nbytes, 6 * p * d + 4 * d


def fused_phase(rows):
    import torch
    from repro_torch.kernels import inner_round as R
    from repro_torch.kernels import ops

    print("fused   dtype     P      D   max_abs_err(v_new/cv1/s/gamma)  "
          "ms  plain_ms  3call_ms  bound_ms")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        rtol, atol = TOL[dname]
        for i, (p, d) in enumerate((MAIN_SHAPE, DA_SHAPE, (3, 1_025))):
            o = round_operands(p, d, dtype, seed=200 + i)
            n_copies = min(16, -(-2 * L2_BYTES // round_work(o)[0]))
            copies = [round_operands(p, d, dtype, seed=300 + k)
                      for k in range(n_copies)]

            def kern(o):
                return R.fused_cut_round(*(o[k] for k in ROUND_ARGS),
                                         **FUSED_STEPS)

            def plain(o):
                return R.fused_cut_round_ref(*(o[k] for k in ROUND_ARGS),
                                             **FUSED_STEPS)

            def three_calls(o):
                # no single library call computes the round: the three
                # contractions it chains, each one PyTorch call (f32 only:
                # torch.mv takes no mixed operand types)
                a = o["a"]
                return torch.mv(a, torch.mv(a, o["v"]) @ a)

            got, want = kern(o), plain(o)
            try:
                errs = [close(x, y, rtol, atol) for x, y in zip(got, want)]
            except AssertionError as e:
                fail(f"fused_round {dname} ({p}, {d}) vs plain: {e}")
            again = kern(o)
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"fused_round {dname} ({p}, {d}) not bitwise repeatable")
            ms = median_ms(kern, copies)
            plain_ms = median_ms(plain, copies)
            lib_ms = median_ms(three_calls, copies) \
                if dtype == torch.float32 else float("nan")
            nbytes, flops = round_work(o)
            bound, bound_by = bound_of(nbytes, flops / F32_FLOP_PER_S)
            print(f"fused   {dname:8s} {p:3d} {d:7d}  "
                  + "/".join(f"{e:.2e}" for e in errs)
                  + f"  {ms:.4f}  {plain_ms:.4f}  {lib_ms:.4f}  "
                  f"{bound:.4f}  (bitwise repeatable: yes)", flush=True)
            if dtype == torch.float32 and (p, d) == MAIN_SHAPE:
                rows["fused_round"] = {
                    "name": "fused_round", "route": "cuda",
                    "source": SOURCES["fused_round"],
                    "replaces": REPLACES["fused_round"],
                    "max_abs_err": max(errs), "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": bound_by, "library_ms": None}
                print(f"  three-call composition torch.mv / u @ A / "
                      f"torch.mv (no single library call computes the "
                      f"round): {lib_ms:.4f} ms")
            if (p, d) != (3, 1_025):
                round_grads_check(o, dname, R, ops)


def round_grads_check(o, dname, R, ops):
    """FusedRound's first derivatives w.r.t. (A, v, s, gamma) against
    plain-torch autograd of the plain version, and its grad-of-grad
    w.r.t. (A, v) against a float64 computation of the same round."""
    import torch
    p, d = o["a"].shape
    wrt = ("a", "v", "s", "gamma")
    steps = tuple(FUSED_STEPS[k] for k in STEP_NAMES)

    def derivs(impl, dtype=None):
        x = {k: o[k].detach().clone().to(dtype or o[k].dtype)
             .requires_grad_(k in wrt) for k in ROUND_ARGS}
        args = [x[k] for k in ROUND_ARGS]
        if impl is None:
            outs = R.fused_round_math(lambda a, v: a @ v,
                                      lambda g, a: g @ a, *args, *steps)
        else:
            outs = ops.fused_cut_round(*args, impl=impl, **FUSED_STEPS)
        loss = sum(torch.sum(t.to(outs[0].dtype) ** 2) for t in outs)
        g = torch.autograd.grad(loss, [x[k] for k in wrt],
                                create_graph=True)
        inner = sum(torch.sum(t.to(outs[0].dtype) ** 2) for t in g)
        gg = torch.autograd.grad(inner, [x["a"], x["v"]])
        return g, gg

    rtol, atol = TOL[dname]
    (g_k, gg_k), (g_p, gg_p) = derivs("kernel"), derivs("ref")
    truth = derivs(None, dtype=torch.float64)[1]
    try:
        errs = [close(x, y, rtol, atol) for x, y in zip(g_k, g_p)]
    except AssertionError as e:
        fail(f"FusedRound first derivatives {dname} ({p}, {d}): {e}")
    gog = []
    for k_, p_, t, name in zip(gg_k, gg_p, truth, ("dda", "ddv")):
        t = t.detach()
        scale = float(t.abs().max())
        e_k = float((k_.double() - t).abs().max()) / scale
        e_p = float((p_.double() - t).abs().max()) / scale
        check(e_k <= 2 * e_p + GOG_FLOOR[dname],
              f"FusedRound grad-of-grad {name} {dname} ({p}, {d}): error "
              f"{e_k:.2e} of max |entry| vs the plain route's {e_p:.2e}")
        gog.append((e_k, e_p))
    print(f"FusedRound grads {dname} ({p}, {d}): max abs err vs plain "
          + " ".join(f"d{k} {e:.2e}" for k, e in zip(wrt, errs))
          + f" | grad-of-grad err vs float64 (of max |entry|) kernel/plain "
          f"dda {gog[0][0]:.1e}/{gog[0][1]:.1e} ddv {gog[1][0]:.1e}/"
          f"{gog[1][1]:.1e}", flush=True)


# ---------------------------------------------------------------------------
# phases 4 and 5: the main paths
# ---------------------------------------------------------------------------

N_ITERATIONS = 120
DA_ITERATIONS = 40
# final-state agreement between routes, relative to the tensor's largest
# entry: the routes sum in other orders, so only the cut rows and inner
# states that the cut values move may differ, by f32 rounding carried
# through 120 iterations
STATE_RTOL = 1e-4


def timed_run(spec):
    """(result, seconds, kernel launches) of one run, counts set to 0
    just before it."""
    import torch
    from repro_torch.core import run
    from repro_torch.kernels import cut_eval as K

    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    res = run(spec)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(K.LAUNCHES)


def in_turns(specs, order):
    """Run `specs[name]` for each name of `order`; keep each route's
    first result and launches and every time.  `order` is symmetric, so
    each route sees the same mean position."""
    first, times = {}, {name: [] for name in specs}
    for name in order:
        res, secs, launches = timed_run(specs[name])
        times[name].append(secs)
        first.setdefault(name, (res, launches))
    return first, times


def final_state_diffs(st, ref):
    """{name: max |diff| / max |entry|} of the final II-layer cuts,
    gamma_k and level-2 inner state of two runs."""
    from repro_torch.utils.tree import tree_leaves
    pairs = {"cuts_ii.a": (st.cuts_ii.a, ref.cuts_ii.a),
             "cuts_ii.c": (st.cuts_ii.c, ref.cuts_ii.c),
             "gamma_k": (st.gamma_k, ref.gamma_k)}
    for k in ("x2", "z2", "phi", "s", "gamma"):
        pairs[f"inner2.{k}"] = (getattr(st.inner2, k),
                                getattr(ref.inner2, k))
    out = {}
    for name, (x, y) in pairs.items():
        num = max(float((a - b).abs().max())
                  for a, b in zip(tree_leaves(x), tree_leaves(y)))
        den = max(float(b.abs().max()) for b in tree_leaves(y))
        out[name] = num / den if den > 0 else num
    return out


def compare_routes(label, h, hr, keys, rtol):
    for k in keys:
        rel = float(np.max(np.abs(h[k] - hr[k]) / np.abs(hr[k])))
        print(f"  {label} {k}: max rel diff {rel:.3e}")
        check(bool(np.all(np.isfinite(h[k]))), f"{label} {k} not finite")
        check(bool(np.allclose(h[k], hr[k], rtol=rtol, atol=0.0)),
              f"{label} {k} beyond rtol {rtol}")
    for k in ("n_cuts_i", "n_cuts_ii"):
        check(list(h[k]) == list(hr[k]), f"{label} {k} differs")


def print_multipliers(label, st):
    print(f"  {label} final multipliers: max lam {float(st.lam.max()):.3e},"
          f" max gamma_k {float(st.gamma_k.max()):.3e}, max inner2.s "
          f"{float(st.inner2.s.max()):.3e}, max inner2.gamma "
          f"{float(st.inner2.gamma.max()):.3e}")


def slice_phase(rows):
    from repro_torch.apps.robust_hpo import (default_hyper,
                                             make_robust_hpo_problem)
    from repro_torch.core import RunSpec, StragglerConfig

    n, s, tau = 6, 4, 10
    task = make_robust_hpo_problem("white_wine", n_workers=n, seed=0,
                                   device="cuda")
    hyper = default_hyper(task, n, s, tau)
    cfg = StragglerConfig(n_workers=n, s_active=s, tau=tau, n_stragglers=1,
                          straggler_slowdown=5.0, seed=0)

    def metrics(state):
        w = {k: v.mean(0) for k, v in state.X3.items()}
        return {"mse_clean": task.test_mse(w, 0.0),
                "mse_noisy": task.test_mse(w, 0.3, seed=0)}

    fused = dataclasses.replace(hyper, use_fused_inner=True)
    hypers = {"plain": dataclasses.replace(hyper, cut_impl="ref"),
              "kernel": hyper,
              "fused_plain": dataclasses.replace(fused, cut_impl="ref"),
              "fused": fused}
    specs = {name: RunSpec(problem=task.problem, hyper=hy, scheduler=cfg,
                           n_iterations=N_ITERATIONS, metrics_every=10,
                           metrics_fn=metrics, engine="scan")
             for name, hy in hypers.items()}
    # the first use of each route loads its modules and kernels: keep
    # that out of the timed runs, which then go in turns
    for spec in specs.values():
        timed_run(dataclasses.replace(spec, n_iterations=20))
    order = ("plain", "fused_plain", "kernel", "fused", "fused", "kernel",
             "fused_plain", "plain")
    first, times = in_turns(specs, order)
    ms = {name: [x / N_ITERATIONS * 1e3 for x in t]
          for name, t in times.items()}
    print("white-wine ms/iteration in turns (" + ", ".join(order) + "): "
          + ", ".join(f"{ms[name][order[:i].count(name)]:.3f}"
                      for i, name in enumerate(order)))

    res, launches = first["kernel"]
    h = res.history
    a_shape = tuple(res.state.cuts_ii.a.shape)
    check(a_shape == MAIN_SHAPE, f"cut matrix {a_shape} != {MAIN_SHAPE}")
    print(f"white-wine slice (cut kernels): cut matrix {a_shape}")
    for k in ("t", "gap_sq", "mse_clean", "mse_noisy", "n_cuts_i",
              "n_cuts_ii"):
        print(f"  {k:9s} " + " ".join(f"{x:.6g}" for x in h[k]))
    check(h["gap_sq"][-1] < h["gap_sq"][0], "gap_sq did not decrease")
    check(h["mse_noisy"][-1] < h["mse_noisy"][0],
          "noisy test MSE did not decrease")
    for name in hypers:
        got = first[name][1]
        print(f"  launches, {name} route: " + ", ".join(
            f"{k} {got.get(k, 0)} ({got.get(k, 0) / N_ITERATIONS:.2f}"
            "/iteration)" for k in KERNELS))
    for k in ("matvec", "vecmat"):
        check(launches.get(k, 0) > 0, f"{k} never launched on the main path")
        rows[k]["launches"] = int(launches[k])
    rows["rank1"]["launches"] = int(launches.get("rank1", 0))
    fused_launches = first["fused"][1]
    check(fused_launches.get("fused_round", 0) > 0,
          "fused_round never launched on the fused route")
    rows["fused_round"]["launches"] = int(fused_launches["fused_round"])
    check(launches.get("fused_round", 0) == 0,
          "the unfused kernel route launched the fused round")
    for name in ("plain", "fused_plain"):
        check(sum(first[name][1].values()) == 0,
              f"the {name} route launched kernels: {first[name][1]}")

    keys = ("gap_sq", "mse_clean", "mse_noisy")
    ref_state = first["plain"][0].state
    for name in ("kernel", "fused_plain", "fused"):
        compare_routes(f"{name} vs plain", first[name][0].history,
                       first["plain"][0].history, keys, 1e-4)
        diffs = final_state_diffs(first[name][0].state, ref_state)
        print(f"  {name} vs plain final state (max |diff| / max |entry|): "
              + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))
        for k, v in diffs.items():
            check(v <= STATE_RTOL, f"white-wine {name} vs plain final {k}: "
                  f"{v:.2e} of the largest entry > {STATE_RTOL}")
    for name in hypers:
        print_multipliers(f"white-wine {name}", first[name][0].state)
    return {name: float(np.mean(v)) for name, v in ms.items()}, specs


def da_phase(rows):
    import torch
    from repro_torch.apps.domain_adaptation import (
        default_hyper, make_domain_adaptation_problem)
    from repro_torch.core import RunSpec, StragglerConfig

    # cuDNN's f32 convolutions default to TF32 and may pick
    # nondeterministic algorithms: either would make the routes differ
    # for reasons that have nothing to do with the cut kernels
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    print(f"cudnn: allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"deterministic={torch.backends.cudnn.deterministic} "
          f"benchmark={torch.backends.cudnn.benchmark}")

    n, s, stragglers, tau = 6, 3, 2, 15     # Table 1, SVHN pretrain
    task = make_domain_adaptation_problem(
        n, pretrain_domain="svhn", n_pretrain_per=24, n_finetune_per=12,
        seed=0, device="cuda")
    hyper = default_hyper(n, s, tau, t_pre=20, k_inner=1, p_max=2,
                          use_fused_inner=True)
    cfg = StragglerConfig(n_workers=n, s_active=s, tau=tau,
                          n_stragglers=stragglers, straggler_slowdown=5.0,
                          seed=0)

    def metrics(state):
        return task.test_metrics({k: v.mean(0) for k, v in state.X2.items()})

    specs = {name: RunSpec(problem=task.problem, hyper=hy, scheduler=cfg,
                           n_iterations=DA_ITERATIONS, metrics_every=5,
                           metrics_fn=metrics, engine="scan")
             for name, hy in (("fused", hyper), ("fused_plain",
                              dataclasses.replace(hyper, cut_impl="ref")))}
    # the warm-up reaches the first refresh (t_pre = 20)
    for spec in specs.values():
        timed_run(dataclasses.replace(spec, n_iterations=20))
    order = ("fused_plain", "fused", "fused", "fused_plain")
    first, times = in_turns(specs, order)
    ms = {name: [x / DA_ITERATIONS * 1e3 for x in t]
          for name, t in times.items()}
    print("domain adaptation ms/iteration in turns (" + ", ".join(order)
          + "): " + ", ".join(f"{ms[name][order[:i].count(name)]:.3f}"
                              for i, name in enumerate(order)))
    res, launches = first["fused"]
    h = res.history
    a_shape = tuple(res.state.cuts_ii.a.shape)
    print(f"domain adaptation (fused kernel route): cut matrix {a_shape}")
    check(a_shape == DA_SHAPE, f"cut matrix {a_shape} != {DA_SHAPE}")
    for k in ("t", "gap_sq", "test_acc", "test_loss", "n_cuts_i",
              "n_cuts_ii"):
        print(f"  {k:9s} " + " ".join(f"{x:.6g}" for x in h[k]))
    check(h["test_loss"][-1] < h["test_loss"][0],
          "domain adaptation test_loss did not decrease")
    for name in specs:
        got = first[name][1]
        print(f"  launches, {name} route: " + ", ".join(
            f"{k} {got.get(k, 0)} ({got.get(k, 0) / DA_ITERATIONS:.2f}"
            "/iteration)" for k in KERNELS))
    for k in ("matvec", "fused_round"):
        check(launches.get(k, 0) > 0,
              f"{k} never launched on the domain-adaptation path")
    check(sum(first["fused_plain"][1].values()) == 0,
          "the plain domain-adaptation route launched kernels")
    compare_routes("fused vs plain", h, first["fused_plain"][0].history,
                   ("gap_sq", "test_loss", "test_acc"), 1e-4)
    diffs = final_state_diffs(res.state, first["fused_plain"][0].state)
    print("  fused vs plain final state (max |diff| / max |entry|): "
          + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items()))
    for k, v in diffs.items():
        check(v <= STATE_RTOL, f"domain adaptation fused vs plain final "
              f"{k}: {v:.2e} of the largest entry > {STATE_RTOL}")
    for name in specs:
        print_multipliers(f"domain adaptation {name}", first[name][0].state)
    return {name: float(np.mean(v)) for name, v in ms.items()}, launches, \
        specs["fused"]


# the port's kernels by the names the profiler gives them
OUR_KERNELS = ("matvec", "vecmat", "rank1", "round_mv", "round_update",
               "round_finish", "flash_fwd_sm90", "flash_fwd", "mlstm_y",
               "mlstm_state")


def profile_phase(label, spec):
    """Device time of 20 iterations of `spec` by kernel, and the device's
    busy share of the wall time, under torch.profiler."""
    from repro_torch.core import run

    spec = dataclasses.replace(spec, n_iterations=20, metrics_every=10,
                               metrics_fn=None)
    profile_call(f"{label} (20 iterations, profiler on)",
                 lambda: run(spec))


def profile_call(label, fn):
    """Device time of one call of `fn` by kernel, and the device's busy
    share of the wall time, under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
               if any(k in name for k in OUR_KERNELS))
    n_kernels = sum(n for n, _ in by_name.values())
    print(f"profile, {label}: wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.2f} ms "
          f"({100 * busy_us / wall_us:.1f}%), {n_kernels} kernels, the "
          f"port's kernels {ours / 1e3:.3f} ms ({100 * ours / busy_us:.1f}%"
          " of busy)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (n, us) in top:
        print(f"  {us / 1e3:8.3f} ms  {n:6d}x  {name[:90]}")


# ---------------------------------------------------------------------------
# phase 7: the LLM kernels
# ---------------------------------------------------------------------------

BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 on the tensor cores
FLASH_TOL = {"float32": 2e-3, "bfloat16": 4e-2}   # tests/test_kernels.py:230
MLSTM_TOL = {"float32": 6e-3, "bfloat16": 6e-2}   # tests/test_kernels.py:285
# (B, S, T, H, Hkv, hd, window): Llama-3 8B's prefill first
FLASH_SHAPES = ((4, 1024, 1024, 32, 8, 128, 0),
                (4, 1024, 1024, 32, 8, 128, 1024),
                (4, 1000, 1000, 32, 8, 128, 0),
                (1, 77, 77, 32, 32, 128, 0))
# bf16 only: Whisper's heads and head dim (20 x 64) at 1,500 frames, run
# causal like the others: the tensor-core kernel's hd-64 instance
FLASH_HD64_SHAPE = (1, 1500, 1500, 20, 20, 64, 0)
# (B, H, L, hd): xLSTM-125M's chunk first
MLSTM_SHAPES = ((4, 4, 256, 192), (4, 4, 100, 192))


def flop_rate(dtype) -> float:
    import torch
    return BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S


def causal_pairs(s, t, window):
    """Query-key pairs a causal (windowed) attention of these lengths
    computes: the work this run's masks leave."""
    q = np.arange(s)
    hi = np.minimum(q, t - 1)
    lo = np.maximum(0, q - window + 1) if window else np.zeros_like(q)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash_operands(shape, dtype, seed):
    import torch
    b, s, t, h, hkv, hd, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*sh):
        return torch.randn(sh, generator=g, device="cuda").to(dtype)

    return {"q": rnd(b, s, h, hd), "k": rnd(b, t, hkv, hd),
            "v": rnd(b, t, hkv, hd)}


def flash_work(shape, dtype):
    """(bytes, seconds of operations): q, k, v read and the output written
    once; q k^T and p v over the pairs the masks leave, at the input
    type's rate."""
    b, s, t, h, hkv, hd, window = shape
    es = 2 if "bfloat16" in str(dtype) else 4
    nbytes = (2 * b * s * h * hd + 2 * b * t * hkv * hd) * es
    flops = 4 * hd * causal_pairs(s, t, window) * b * h
    return nbytes, flops / flop_rate(dtype)


def mlstm_operands(shape, dtype, seed):
    import torch
    b, h, l, hd = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*sh, scale=1.0):
        return torch.randn(sh, generator=g, device="cuda") * scale

    return {"q": rnd(b, h, l, hd).to(dtype), "k": rnd(b, h, l, hd).to(dtype),
            "v": rnd(b, h, l, hd).to(dtype), "li": rnd(b, h, l, 1, scale=0.5),
            "lf": torch.nn.functional.logsigmoid(rnd(b, h, l, 1) + 2.0),
            "c": rnd(b, h, hd, hd, scale=0.3), "n": rnd(b, h, 1, hd,
                                                       scale=0.3),
            "m": rnd(b, h, 1, 1)}


MLSTM_ARGS = ("q", "k", "v", "li", "lf", "c", "n", "m")


def mlstm_work(shape, dtype):
    """(bytes, seconds of operations): q/k/v, gates and state read once,
    y and the new state written once; q k^T and p v over the causal pairs
    and k^T v at the input type's rate, q C and q . n (C and n are f32)
    at the f32 rate."""
    b, h, l, hd = shape
    es = 2 if "bfloat16" in str(dtype) else 4
    bh = b * h
    nbytes = bh * (4 * l * hd * es + 2 * l * 4
                   + 2 * (hd * hd + hd + 1) * 4)
    typed = bh * (4 * hd * l * (l + 1) // 2 + 2 * l * hd * hd + 2 * l * hd)
    f32 = bh * (2 * l * hd * hd + 2 * l * hd)
    return nbytes, typed / flop_rate(dtype) + f32 / F32_FLOP_PER_S


def simt_flash(lib, o):
    """The SIMT flash kernel called directly (uncounted) on o's causal
    inputs: the route bf16 took before the tensor-core kernel."""
    import math
    import torch
    q, k, v = o["q"], o["k"], o["v"]
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    err = lib.flash_attention_simt(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, s, k.shape[1], h, k.shape[2], hd,
        1, 0, 1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"flash_attention_simt: launch failed with error {err}")
    return out


def llm_kernel_phase(rows):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import cut_eval as K
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import mlstm_chunk as mk
    from repro_torch.kernels import ref

    lib = build.load()
    print("flash   dtype    kernel               B    S    T  H Hkv  hd "
          "window  max_abs_err  ms  plain_ms  sdpa_ms  bound_ms")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        tol = FLASH_TOL[dname]
        shapes = FLASH_SHAPES + ((FLASH_HD64_SHAPE,)
                                 if dtype == torch.bfloat16 else ())
        for i, shape in enumerate(shapes):
            window = shape[-1]
            name = flash.flash_route(dtype, shape[5])
            o = flash_operands(shape, dtype, seed=400 + i)

            def kern(o, window=window):
                return flash.flash_attention(o["q"], o["k"], o["v"],
                                             causal=True, window=window)

            def plain(o, window=window):
                return ref.flash_attention_ref(o["q"], o["k"], o["v"],
                                               causal=True, window=window)

            K.reset_launches()
            got = kern(o)
            check(dict(K.LAUNCHES) == {name: 1},
                  f"flash_attention {dname} {shape} launched "
                  f"{dict(K.LAUNCHES)}, expected {{{name!r}: 1}}")
            try:
                err = close(got, plain(o), tol, tol)
            except AssertionError as e:
                fail(f"{name} {dname} {shape} vs plain: {e}")
            check(torch.equal(got, kern(o)),
                  f"{name} {dname} {shape} not bitwise repeatable")
            line = (f"flash   {dname:8s} {name:20s} "
                    + " ".join(str(x) for x in shape) + f"  {err:.3e}")
            if i == 0:
                nbytes, t_ops = flash_work(shape, dtype)
                copies = [flash_operands(shape, dtype, seed=500 + k)
                          for k in range(max(2, -(-2 * L2_BYTES // nbytes)))]

                def sdpa(o):
                    return F.scaled_dot_product_attention(
                        o["q"].transpose(1, 2), o["k"].transpose(1, 2),
                        o["v"].transpose(1, 2), is_causal=True,
                        enable_gqa=True)

                lib_err = float((sdpa(o).transpose(1, 2).float()
                                 - plain(o).float()).abs().max())
                ms = median_ms(kern, copies, n_launch=8, reps=5)
                plain_ms = median_ms(plain, copies, n_launch=4, reps=5)
                lib_ms = median_ms(sdpa, copies, n_launch=8, reps=5)
                bound, bound_by = bound_of(nbytes, t_ops)
                line += (f"  {ms:.4f}  {plain_ms:.4f}  {lib_ms:.4f}  "
                         f"{bound:.4f} ({bound_by}; sdpa vs plain "
                         f"{lib_err:.2e})")
                rows[name] = {
                    "name": name, "route": "cuda", "source": SOURCES[name],
                    "replaces": REPLACES[name], "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": bound_by, "library_ms": lib_ms}
                if name != "flash_attention_simt":
                    simt_ms = median_ms(
                        lambda o: simt_flash(lib, o), copies, n_launch=4,
                        reps=5)
                    line += (f"; the SIMT kernel on the same inputs "
                             f"{simt_ms:.4f} ms")
            print(line + "  (bitwise repeatable: yes)", flush=True)

    print("mlstm   dtype     B  H    L   hd  max_abs_err(y/c/n/m)  ms  "
          "plain_ms  bound_ms")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        tol = MLSTM_TOL[dname]
        for i, shape in enumerate(MLSTM_SHAPES):
            o = mlstm_operands(shape, dtype, seed=600 + i)

            def kern(o):
                return mk.mlstm_chunk(*(o[k] for k in MLSTM_ARGS))

            def plain(o):
                return ref.mlstm_chunk_ref(*(o[k] for k in MLSTM_ARGS))

            got = kern(o)
            try:
                errs = [close(x, y, tol, tol) for x, y in zip(got, plain(o))]
            except AssertionError as e:
                fail(f"mlstm_chunk {dname} {shape} vs plain: {e}")
            check(all(torch.equal(x, y) for x, y in zip(got, kern(o))),
                  f"mlstm_chunk {dname} {shape} not bitwise repeatable")
            line = (f"mlstm   {dname:8s} " + " ".join(str(x) for x in shape)
                    + "  " + "/".join(f"{e:.2e}" for e in errs))
            if i == 0:
                nbytes, t_ops = mlstm_work(shape, dtype)
                copies = [mlstm_operands(shape, dtype, seed=700 + k)
                          for k in range(max(2, -(-2 * L2_BYTES // nbytes)))]
                ms = median_ms(kern, copies)
                plain_ms = median_ms(plain, copies, n_launch=8, reps=5)
                bound, bound_by = bound_of(nbytes, t_ops)
                line += (f"  {ms:.4f}  {plain_ms:.4f}  {bound:.4f} "
                         f"({bound_by})")
                if dtype == torch.bfloat16:
                    rows["mlstm_chunk"] = {
                        "name": "mlstm_chunk", "route": "cuda",
                        "source": SOURCES["mlstm_chunk"],
                        "replaces": REPLACES["mlstm_chunk"],
                        "max_abs_err": max(errs), "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": None}
            print(line + "  (bitwise repeatable: yes)", flush=True)
    print("  mlstm_chunk has no single library call (the chunk is a decayed "
          "attention plus a matrix-memory update): library_ms null")


# ---------------------------------------------------------------------------
# phases 8 and 9: LLM serving at full width
# ---------------------------------------------------------------------------

SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1024, 32
# prefill in f32, kernel route vs plain route, max |diff| / max |entry|:
# the kernels' own f32 tolerances (Llama's logits; xLSTM block by block)
ROUTE_TOL = {"llama3-8b": 2e-3, "xlstm-125m": 6e-3}
# bf16 at full depth: each route's logits against an f32 evaluation of
# the same weights (plain route); the kernel route may be at most this
# many times farther from it than the plain route, plus BF16_FLOOR
DISTANCE_FACTOR, BF16_FLOOR = 2.0, 1e-3
# and kernel vs plain route directly, where bf16 rounding leaves a
# margin: Llama-3 8B measured 1.712e-2 on the H100; xLSTM-125M's routes
# differ by as much as bf16 differs from f32 (0.95 vs 0.94), so only the
# f32-distance gate holds it
BF16_ROUTE_TOL = {"llama3-8b": 5e-2, "xlstm-125m": None}


def rel_diff(a, b):
    """max |a - b| / max |b|."""
    return float((a.float() - b.float()).abs().max()) \
        / float(b.float().abs().max())


def prefill_logits(cfg, params, prompts, impl=None):
    """Prefill logits and the kernels launched for them."""
    import torch
    from repro_torch.kernels import cut_eval as K
    from repro_torch.models import transformer as tfm

    with torch.inference_mode():
        K.reset_launches()
        logits = tfm.prefill(cfg, params, prompts, impl=impl)[0]
        launches = dict(K.LAUNCHES)
    check(bool(torch.isfinite(logits).all()),
          f"{cfg.name}: prefill logits not finite")
    check(logits.shape == (prompts.shape[0], prompts.shape[1],
                           cfg.vocab_size),
          f"{cfg.name}: prefill logits of shape {tuple(logits.shape)}")
    return logits, launches


def bf16_route_check(cfg, params, prompts, tol):
    """Kernel and plain routes in bf16 against each other and against an
    f32 evaluation of the same weights; gates: the kernel route no
    farther from the f32 logits than DISTANCE_FACTOR times the plain
    route's distance plus BF16_FLOOR, and within `tol` of the plain route
    where `tol` is given."""
    import dataclasses as dc
    import torch
    from repro_torch.utils.tree import tree_map

    got, _ = prefill_logits(cfg, params, prompts)
    plain, _ = prefill_logits(cfg, params, prompts, impl="ref")
    rel_kp = rel_diff(got, plain)
    params32 = tree_map(lambda a: a.float(), params)
    f32, _ = prefill_logits(dc.replace(cfg, dtype="float32"), params32,
                            prompts, impl="ref")
    del params32
    d_k, d_p = rel_diff(got, f32), rel_diff(plain, f32)
    agree = float((got[:, -1].argmax(-1) == plain[:, -1].argmax(-1))
                  .float().mean())
    print(f"  prefill logits (bf16, full depth), max |diff| / max |logit|: "
          f"kernel vs plain route {rel_kp:.3e}; vs the f32 evaluation of "
          f"the same weights: kernel route {d_k:.3e}, plain route "
          f"{d_p:.3e} (gate {DISTANCE_FACTOR} x plain + {BF16_FLOOR}); "
          f"last-position argmax equal on {agree:.2f} of the rows",
          flush=True)
    check(d_k <= DISTANCE_FACTOR * d_p + BF16_FLOOR,
          f"{cfg.name} bf16: the kernel route is {d_k:.3e} from the f32 "
          f"logits, the plain route {d_p:.3e}")
    if tol is not None:
        print(f"  kernel vs plain route gate (bf16): {tol}")
        check(rel_kp <= tol, f"{cfg.name} bf16 prefill logits of the two "
              f"routes differ by {rel_kp:.3e}")
    del got, plain, f32
    torch.cuda.empty_cache()


def serve_phase(arch, kernel, per_prefill, f32_cfg, per_block=False):
    """Serve `arch` at full width on both routes; check the launches, the
    prefill logits of the two routes (bf16, then f32 on `f32_cfg`: whole
    model, or block by block with `per_block`), and return the kernel
    route's launches of one bf16 prefill and of the f32 prefill."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.kernels import cut_eval as K
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import param_count

    cfg = get_config(arch)
    n_params = param_count(cfg)["total"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    print(f"{arch}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, hd {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}: "
          f"{n_params / 1e9:.3f} B parameters drawn in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB on the card",
          flush=True)
    # first use of every path outside the timed runs
    serve(cfg, SERVE_BATCH, 64, 2, params=params)
    serve(cfg, SERVE_BATCH, 64, 2, params=params, impl="ref")

    runs = {}
    for impl, label in ((None, "kernel"), ("ref", "plain"), (None, "kernel"),
                        ("ref", "plain")):
        K.reset_launches()
        res = serve(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, seed=0,
                    params=params, impl=impl)
        launches = dict(K.LAUNCHES)
        runs.setdefault(label, []).append((res, launches))
        print(f"  {label:6s} route: prefill {res['prefill_s'] * 1e3:.2f} ms,"
              f" decode {res['decode_s'] / (SERVE_GEN - 1) * 1e3:.3f} "
              f"ms/token, {res['tok_per_s']:.1f} tok/s, launches {launches}",
              flush=True)
    res, launches = runs["kernel"][0]
    check(launches == {kernel: per_prefill},
          f"{arch}: the kernel route launched {launches}, expected "
          f"{{{kernel!r}: {per_prefill}}}")
    check(all(sum(x[1].values()) == 0 for x in runs["plain"]),
          f"{arch}: the plain route launched kernels")
    gen_k, gen_p = res["generated"], runs["plain"][0][0]["generated"]
    check(gen_k.shape == (SERVE_BATCH, SERVE_GEN)
          and bool(((gen_k >= 0) & (gen_k < cfg.vocab_size)).all()),
          f"{arch}: generated tokens of shape {gen_k.shape} out of range")
    agree = float((gen_k == gen_p).mean())
    print(f"  greedy tokens equal on the two routes: {agree:.4f} of "
          f"{gen_k.size}; first row (kernel route): "
          f"{gen_k[0, :16].tolist()}")
    prompts = torch.as_tensor(make_token_stream(
        cfg.vocab_size, SERVE_BATCH, SERVE_PROMPT, seed=0), device="cuda")
    bf16_route_check(cfg, params, prompts, BF16_ROUTE_TOL[arch])
    with torch.inference_mode():
        profile_call(f"{arch} prefill, kernel route",
                     lambda: tfm.prefill(cfg, params, prompts))
        _, caches = tfm.prefill(cfg, params, prompts,
                                max_seq=SERVE_PROMPT + SERVE_GEN + 1)
        tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.int32, device="cuda")

        def decode4():
            c = caches
            for i in range(4):
                pos = torch.full((SERVE_BATCH,), SERVE_PROMPT + i,
                                 dtype=torch.int32, device="cuda")
                c = tfm.decode_step(cfg, params, c, tok, pos)[1]

        profile_call(f"{arch} 4 decode steps", decode4)
        del caches

    del params
    torch.cuda.empty_cache()
    params = tfm.init_params(
        f32_cfg, torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    got, launches32 = prefill_logits(f32_cfg, params, prompts)
    plain = prefill_logits(f32_cfg, params, prompts, impl="ref")[0]
    rel32 = rel_diff(got, plain)
    tol = ROUTE_TOL[arch]
    print(f"  prefill logits, kernel vs plain route (f32, "
          f"{f32_cfg.n_layers} layers): max |diff| / max |logit| "
          f"{rel32:.3e}; launches {launches32}", flush=True)
    if per_block:
        f32_depth_check(f32_cfg, params, prompts, got, plain, tol)
    else:
        check(rel32 <= tol, f"{arch} f32 prefill logits differ by "
              f"{rel32:.3e} (gate {tol})")
    del params, got, plain
    torch.cuda.empty_cache()
    return launches, launches32


def f32_depth_check(cfg, params, prompts, got, plain, tol):
    """For a model that amplifies f32 rounding from block to block (the
    random-weight xLSTM: about 3x per block), hold each block's kernel
    route to its plain route on the same input at `tol`, and the kernel
    route's logits to an independent f32 evaluation (the plain route on
    the CPU) no farther than DISTANCE_FACTOR times the plain card route's
    distance plus `tol`."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_index, tree_map

    worst, apart = 0.0, []
    b, s = prompts.shape
    with torch.inference_mode():
        x = x_kern = params["embed"][prompts.long()]
        pos = torch.arange(s, dtype=torch.int32, device="cuda")[None] \
            .expand(b, s)
        for st_params, st in zip(params["stages"], cfg.stages):
            for r in range(st.repeats):
                for i, spec in enumerate(st.pattern):
                    bp = tree_index(st_params[f"pos{i}"], r)
                    out = tfm._block_fwd(cfg, spec, bp, x, pos)[0]
                    x = tfm._block_fwd(cfg, spec, bp, x, pos, impl="ref")[0]
                    worst = max(worst, rel_diff(out, x))
                    # the two routes' residual streams, each run on its own
                    x_kern = tfm._block_fwd(cfg, spec, bp, x_kern, pos)[0]
                    apart.append(rel_diff(x_kern, x))
    print("  f32, the two routes' residual streams run apart, after each "
          "block (max |diff| / max |entry|): "
          + " ".join(f"{a:.1e}" for a in apart), flush=True)
    with torch.inference_mode():
        t0 = time.perf_counter()
        cpu = tfm.prefill(cfg, tree_map(lambda a: a.cpu(), params),
                          prompts.cpu())[0]
        cpu_s = time.perf_counter() - t0
    d_k, d_p = rel_diff(got.cpu(), cpu), rel_diff(plain.cpu(), cpu)
    print(f"  f32, each block on the same input: kernel vs plain route at "
          f"most {worst:.3e} of the block's largest output (gate {tol}); "
          f"logits vs the plain route on the CPU ({cpu_s:.1f} s): kernel "
          f"route {d_k:.3e}, plain card route {d_p:.3e} (gate "
          f"{DISTANCE_FACTOR} x plain + {tol})", flush=True)
    check(worst <= tol, f"{cfg.name} f32: a block's kernel route differs "
          f"by {worst:.3e} from its plain route")
    check(d_k <= DISTANCE_FACTOR * d_p + tol,
          f"{cfg.name} f32: the kernel route is {d_k:.3e} from the CPU "
          f"logits, the plain card route {d_p:.3e}")


def llama_phase(rows):
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.models.config import BlockSpec, uniform_stages

    cfg32 = dc.replace(get_config("llama3-8b"), dtype="float32", n_layers=2,
                       stages=uniform_stages(2, BlockSpec()))
    launches, launches32 = serve_phase("llama3-8b", "flash_attention", 32,
                                       cfg32)
    # bf16 at hd 128 runs the tensor-core kernel only (serve_phase holds
    # the bf16 prefill to exactly {"flash_attention": 32}); f32 the SIMT
    check(launches32 == {"flash_attention_simt": cfg32.n_layers},
          f"llama3-8b f32 prefill launched {launches32}, expected "
          f"{{'flash_attention_simt': {cfg32.n_layers}}}")
    rows["flash_attention"]["launches"] = int(launches["flash_attention"])
    rows["flash_attention_simt"]["launches"] = int(
        launches32["flash_attention_simt"])


def xlstm_phase(rows):
    import dataclasses as dc
    from repro_torch.configs import get_config

    cfg32 = dc.replace(get_config("xlstm-125m"), dtype="float32")
    launches, _ = serve_phase("xlstm-125m", "mlstm_chunk", 40, cfg32,
                              per_block=True)
    rows["mlstm_chunk"]["launches"] = int(launches["mlstm_chunk"])


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
    fused_phase(rows)
    ww_ms, ww_specs = slice_phase(rows)
    da_ms, da_launches, da_spec = da_phase(rows)
    profile_phase("white-wine, cut kernels (two refreshes)",
                  ww_specs["kernel"])
    profile_phase("white-wine, fused kernel (two refreshes)",
                  ww_specs["fused"])
    profile_phase("domain adaptation, fused kernel (one refresh)", da_spec)
    llm_kernel_phase(rows)
    llama_phase(rows)
    xlstm_phase(rows)
    print("ms/iteration, mean of two runs per route: white-wine "
          + ", ".join(f"{k} {v:.3f}" for k, v in ww_ms.items())
          + "; domain adaptation "
          + ", ".join(f"{k} {v:.3f}" for k, v in da_ms.items()))
    print("domain-adaptation launches (fused route): " + ", ".join(
        f"{k} {da_launches.get(k, 0)}" for k in KERNELS))
    print(json.dumps({"kernels": [rows[k] for k in KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
