"""The port's CUDA kernels and main path on a card.

The kernels have no CPU mode, so these tests skip without a card.  This
file imports neither jax nor the reference package, so it also runs on a
machine without them:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.apps import domain_adaptation as da
from repro_torch.core import (Hyper, RunSpec, StragglerConfig,
                              TrilevelProblem, run)
from repro_torch.kernels import inner_round, ops
from repro_torch.kernels import cut_eval as kern

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


def _operands(p, d, seed, dtype, device):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        x = (rng.normal(size=shape) * scale).astype(np.float32)
        return torch.tensor(x).to(dtype).to(device)

    return t(p, d, scale=d ** -0.5), t(d), t(p), t(d)


@pytest.mark.parametrize("p,d", [(3, 33), (8, 57_366), (13, 5000), (13, 5001),
                                 (2, 925_590), (1, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_versions(cuda, p, d, dtype):
    a, v, g, y = _operands(p, d, p, dtype, cuda)
    tol = F32 if dtype == torch.float32 else BF16
    kern.reset_launches()
    for got, want in ((kern.matvec(a, v), kern.matvec_ref(a, v)),
                      (kern.vecmat(g, a), kern.vecmat_ref(g, a)),
                      (kern.rank1(g, y), kern.rank1_ref(g, y))):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **tol)
    assert dict(kern.LAUNCHES) == {"matvec": 1, "vecmat": 1, "rank1": 1}
    assert torch.equal(kern.matvec(a, v), kern.matvec(a, v))


def test_matvec_counter_resets_between_calls(cuda):
    """Back-to-back calls with other P, D and an offset (unaligned) view of
    A on one stream: the ticket counter is back at 0 after each call."""
    a, v, _, _ = _operands(9, 100_003, 3, torch.float32, cuda)
    b, w, _, _ = _operands(2, 4_097, 4, torch.float32, cuda)
    flat = torch.randn(5 * 1001 + 3, device=cuda)
    x = flat[3:].view(5, 1001)
    u = torch.randn(1001, device=cuda)
    kern.reset_launches()
    for _ in range(2):
        for m, vec in ((a, v), (b, w), (a[:4], v), (x, u)):
            np.testing.assert_allclose(
                kern.matvec(m, vec).cpu().numpy(),
                kern.matvec_ref(m, vec).cpu().numpy(), **F32)
    assert dict(kern.LAUNCHES) == {"matvec": 8}
    assert int(kern._ticket(a).item()) == 0


@pytest.mark.parametrize("p,d", [(3, 33), (13, 5000), (2, 925_590)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vecmat_at_ragged_widths(cuda, p, d, dtype):
    """One launch a call, bitwise repeatable, and right on A and on a view
    of A that starts 3 entries into its storage (rows unaligned)."""
    a, _, g, _ = _operands(p, d, 7, dtype, cuda)
    flat = torch.randn(p * d + 3, device=cuda).to(dtype)
    view = flat[3:].view(p, d)
    tol = F32 if dtype == torch.float32 else BF16
    for m in (a, view):
        kern.reset_launches()
        got = kern.vecmat(g, m)
        assert dict(kern.LAUNCHES) == {"vecmat": 1}
        np.testing.assert_allclose(got.cpu().numpy(),
                                   kern.vecmat_ref(g, m).cpu().numpy(), **tol)
        assert torch.equal(got, kern.vecmat(g, m))


def test_mixed_operand_types(cuda):
    a, v, g, y = _operands(5, 3000, 1, torch.float32, cuda)
    for got, want in ((kern.matvec(a.bfloat16(), v), kern.matvec_ref(
                           a.bfloat16(), v)),
                      (kern.vecmat(g, a.bfloat16()), kern.vecmat_ref(
                           g, a.bfloat16())),
                      (kern.rank1(g.bfloat16(), y), kern.rank1_ref(
                           g.bfloat16(), y))):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **F32)


def test_kernel_route_first_derivatives(cuda):
    a0, v0, w, _ = _operands(8, 4096, 9, torch.float32, cuda)
    c = torch.linspace(-1, 1, 8, device=cuda)
    act = (w > -0.5).float()

    def grads(impl):
        a = a0.clone().requires_grad_()
        v = v0.clone().requires_grad_()
        loss = 0.5 * torch.sum(ops.cut_eval(a, v, c, act, impl=impl) ** 2
                               * w)
        return torch.autograd.grad(loss, (a, v))

    for got, want in zip(grads("kernel"), grads("ref")):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   **F32)


def test_quickstart_runs_through_the_kernels(cuda):
    g = torch.Generator().manual_seed(0)
    data = {"A": (torch.randn(4, 3, 3, generator=g) * 0.3).to(cuda),
            "b": torch.randn(4, 3, generator=g).to(cuda)}

    def f1(d, x1, x2, x3):
        return torch.sum((x1 - d["A"] @ x3 - d["b"]) ** 2)

    def f2(d, x1, x2, x3):
        return torch.sum((x2 + x3) ** 2) + 0.1 * torch.sum(x2 ** 2)

    def f3(d, x1, x2, x3):
        return torch.sum((x3 - x1) ** 2) + 0.1 * torch.sum((x3 - x2) ** 2)

    zero = torch.zeros(3, device=cuda)
    problem = TrilevelProblem(f1=f1, f2=f2, f3=f3, data=data, n_workers=4,
                              x1_init=zero, x2_init=zero, x3_init=zero)
    hyper = Hyper(n_workers=4, s_active=3, tau=5, k_inner=3, p_max=6,
                  t_pre=5, t1=100, eta_x=0.05, eta_z=0.05, d1=3)
    spec = RunSpec(problem=problem, hyper=hyper, n_iterations=30,
                   metrics_every=10)
    kern.reset_launches()
    res = run(spec)
    assert kern.LAUNCHES["matvec"] > 0 and kern.LAUNCHES["vecmat"] > 0
    ref = run(dataclasses.replace(
        spec, hyper=dataclasses.replace(hyper, cut_impl="ref")))
    gap = res.history["gap_sq"]
    assert gap[-1] < gap[0]
    np.testing.assert_allclose(gap, ref.history["gap_sq"], rtol=1e-4,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the fused level-2 round
# ---------------------------------------------------------------------------

STEPS = (0.05, 0.05, 0.05, 1.0)   # eta_z, eta_s, eta_dual, rho2


def _round_operands(p, d, seed, dtype, device):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.tensor((rng.normal(size=shape) * scale)
                            .astype(np.float32)).to(device)

    return dict(
        a=t(p, d, scale=d ** -0.5).to(dtype), v=t(d), g_other=t(d),
        mask=torch.tensor((np.arange(d) % 3 > 0).astype(np.float32))
        .to(device),
        c=t(p), active=torch.tensor(
            (rng.uniform(size=p) > 0.3).astype(np.float32)).to(device),
        s=t(p).abs(), gamma=t(p).abs())


ROUND_ARGS = ("a", "v", "g_other", "mask", "c", "active", "s", "gamma")


@pytest.mark.parametrize("p,d", [(1, 7), (3, 1025), (8, 57_366),
                                 (2, 100_000), (13, 5000),
                                 (8, 242_628),     # white-wine
                                 (64, 242_628),    # above what fits on chip
                                 (4096, 37)])      # the most rows it takes
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_round_kernel_matches_plain_version(cuda, p, d, dtype):
    o = _round_operands(p, d, p + d, dtype, cuda)
    args = [o[k] for k in ROUND_ARGS]
    kw = dict(zip(("eta_z", "eta_s", "eta_dual", "rho2"), STEPS))
    kern.reset_launches()
    got = inner_round.fused_cut_round(*args, **kw)
    assert dict(kern.LAUNCHES) == {"fused_round": 1}
    assert int(kern._ticket(o["a"]).item()) == 0
    want = inner_round.fused_cut_round_ref(*args, **kw)
    tol = F32 if dtype == torch.float32 else BF16
    for x, y in zip(got, want):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), **tol)
    again = inner_round.fused_cut_round(*args, **kw)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


def test_fused_round_holds_a_on_chip_where_it_fits(cuda):
    """The main paths' A stays in shared memory; 62 MB of it is streamed,
    in the same kernel; more than 4,096 rows are refused."""
    for p, d, dtype, on_chip in ((8, 242_628, torch.float32, True),
                                 (2, 925_590, torch.float32, True),
                                 (8, 242_628, torch.bfloat16, True),
                                 (64, 242_628, torch.float32, False)):
        a = torch.zeros((p, d), dtype=dtype, device=cuda)
        assert inner_round.plan_for(a).on_chip == on_chip
    o = _round_operands(4097, 9, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match="cut rows"):
        inner_round.fused_cut_round(
            *(o[k] for k in ROUND_ARGS),
            **dict(zip(("eta_z", "eta_s", "eta_dual", "rho2"), STEPS)))


def test_fused_round_derivatives_through_the_kernels(cuda):
    """First derivatives against plain-torch autograd; grad-of-grad
    against a float64 computation of the same round."""
    o = _round_operands(8, 4096, 5, torch.float32, cuda)
    wrt = ("a", "v", "s", "gamma")

    def derivs(impl, dtype=torch.float32):
        x = {k: o[k].detach().clone().to(dtype).requires_grad_(k in wrt)
             for k in o}
        args = [x[k] for k in ROUND_ARGS]
        if impl is None:
            outs = inner_round.fused_round_math(
                lambda a, v: a @ v, lambda g, a: g @ a, *args, *STEPS)
        else:
            outs = ops.fused_cut_round(
                *args, impl=impl,
                **dict(zip(("eta_z", "eta_s", "eta_dual", "rho2"), STEPS)))
        loss = sum(torch.sum(t ** 2) for t in outs)
        g = torch.autograd.grad(loss, [x[k] for k in wrt],
                                create_graph=True)
        gg = torch.autograd.grad(sum(torch.sum(t ** 2) for t in g),
                                 [x["a"], x["v"]])
        return g, gg

    kern.reset_launches()
    g_k, gg_k = derivs("kernel")
    assert kern.LAUNCHES["fused_round"] == 1
    assert kern.LAUNCHES["vecmat"] > 0 and kern.LAUNCHES["rank1"] > 0
    g_p, gg_p = derivs("ref")
    for x, y in zip(g_k, g_p):
        np.testing.assert_allclose(x.detach().cpu().numpy(),
                                   y.detach().cpu().numpy(), **F32)
    _, gg_t = derivs(None, torch.float64)
    for k, p, t in zip(gg_k, gg_p, gg_t):
        scale = float(t.abs().max())
        assert scale > 0.0
        e_k = float((k.double() - t).abs().max()) / scale
        e_p = float((p.double() - t).abs().max()) / scale
        assert e_k <= 2 * e_p + 1e-6, (e_k, e_p)


def test_domain_adaptation_runs_through_the_fused_kernel(cuda):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    task = da.make_domain_adaptation_problem(
        2, n_pretrain_per=8, n_finetune_per=8, seed=0, device=cuda)
    hyper = da.default_hyper(2, 2, 5, t_pre=4, k_inner=1, p_max=2,
                             use_fused_inner=True)
    spec = RunSpec(problem=task.problem, hyper=hyper, n_iterations=8,
                   metrics_every=4,
                   scheduler=StragglerConfig(n_workers=2, s_active=2,
                                             tau=5, seed=0),
                   metrics_fn=lambda s: task.test_metrics(
                       {k: v.mean(0) for k, v in s.X2.items()}))
    kern.reset_launches()
    res = run(spec)
    assert kern.LAUNCHES["fused_round"] > 0 and kern.LAUNCHES["matvec"] > 0
    plain = run(dataclasses.replace(
        spec, hyper=dataclasses.replace(hyper, cut_impl="ref")))
    for k in ("gap_sq", "test_loss", "test_acc"):
        assert np.all(np.isfinite(res.history[k]))
        np.testing.assert_allclose(res.history[k], plain.history[k],
                                   rtol=1e-4, atol=1e-6)
    for k in ("n_cuts_i", "n_cuts_ii"):
        assert list(res.history[k]) == list(plain.history[k])


# ---------------------------------------------------------------------------
# the LLM kernels and the serving path
# ---------------------------------------------------------------------------

FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 4e-2}
MLSTM_TOL = {torch.float32: 6e-3, torch.bfloat16: 6e-2}


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("b,s,t,h,hkv,hd,window", [
    (2, 64, 64, 4, 2, 32, 0), (2, 64, 64, 4, 2, 32, 24),
    (1, 77, 77, 4, 4, 128, 0), (2, 200, 200, 8, 2, 128, 50),
    (1, 20, 37, 2, 1, 16, 0), (1, 37, 20, 2, 1, 64, 8),
    # the tensor-core kernel's instances (bf16, hd 64 / 128): S > T,
    # ragged S, one kv head, windows (rows with no key in the window)
    (1, 200, 77, 4, 1, 128, 0), (1, 200, 130, 4, 2, 64, 24),
    (2, 77, 77, 8, 1, 64, 16), (1, 300, 300, 4, 1, 128, 100),
    # the hd-256 tensor-core kernel (bf16): the same, and S < T
    (1, 200, 77, 4, 1, 256, 0), (1, 200, 130, 4, 2, 256, 24),
    (2, 77, 77, 8, 1, 256, 16), (1, 300, 300, 4, 1, 256, 100),
    (1, 20, 37, 2, 1, 256, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version(cuda, b, s, t, h, hkv, hd,
                                            window, dtype):
    from repro_torch.kernels import flash_attention as flash, ref
    rng = np.random.default_rng(s + t + window)
    q, k, v = (torch.tensor(_normal(rng, b, n, heads, hd)).to(dtype)
               .to(cuda) for n, heads in ((s, h), (t, hkv), (t, hkv)))
    kern.reset_launches()
    got = flash.flash_attention(q, k, v, causal=True, window=window)
    assert dict(kern.LAUNCHES) == {flash.flash_route(dtype, hd): 1}
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    assert torch.equal(got, flash.flash_attention(q, k, v, causal=True,
                                                  window=window))


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_tensor_core_kernel_non_causal(cuda, hd):
    """bf16 at hd 64 / 128 / 256 launches a tensor-core kernel, which
    leaves non-causal inputs unmasked, as the plain version does."""
    from repro_torch.kernels import flash_attention as flash, ref
    rng = np.random.default_rng(hd)
    q, k, v = (torch.tensor(_normal(rng, 2, 256, heads, hd))
               .to(torch.bfloat16).to(cuda) for heads in (4, 2, 2))
    kern.reset_launches()
    got = flash.flash_attention(q, k, v, causal=False)
    route = "flash_attention_hd256" if hd == 256 else "flash_attention"
    assert flash.flash_route(torch.bfloat16, hd) == route
    assert dict(kern.LAUNCHES) == {route: 1}
    want = ref.flash_attention_ref(q, k, v, causal=False)
    tol = FLASH_TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)


def _mlstm_operands(b, h, l, hd, seed, dtype, device):
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.tensor(x).to(device)

    qkv = [t(_normal(rng, b, h, l, hd)).to(dtype) for _ in range(3)]
    li = t(_normal(rng, b, h, l, 1, scale=0.5))
    lf = torch.nn.functional.logsigmoid(t(_normal(rng, b, h, l, 1)) + 2.0)
    c = t(_normal(rng, b, h, hd, hd, scale=0.3))
    n = t(_normal(rng, b, h, 1, hd, scale=0.3))
    m = t(_normal(rng, b, h, 1, 1))
    return (*qkv, li, lf, c, n, m)


@pytest.mark.parametrize("l,hd", [(8, 8), (100, 192), (256, 64), (33, 128),
                                  (512, 64), (600, 192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_kernel_matches_plain_version(cuda, l, hd, dtype):
    """hd 8 and chunks past 512 launch the SIMT kernel; hd 64 / 128 / 192
    up to 512 a tensor-core kernel (bf16, or f32 in three TF32 passes);
    all match the plain version, ragged L included."""
    from repro_torch.kernels import mlstm_chunk as mk, ref
    args = _mlstm_operands(2, 3, l, hd, l + hd, dtype, cuda)
    kern.reset_launches()
    got = mk.mlstm_chunk(*args)
    route = "mlstm_chunk_simt"
    if hd != 8 and l <= 512:
        route = ("mlstm_chunk" if dtype == torch.bfloat16
                 else "mlstm_chunk_f32")
    assert mk.mlstm_route(dtype, hd, l) == route
    assert dict(kern.LAUNCHES) == {route: 1}
    assert got[0].dtype == dtype and got[0].shape == args[0].shape
    want = ref.mlstm_chunk_ref(*args)
    tol = MLSTM_TOL[dtype]
    for g, w, name in zip(got, want, ("y", "c", "n", "m")):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), rtol=tol,
                                   atol=tol, err_msg=name)
    again = mk.mlstm_chunk(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("l", [256, 100])
def test_mlstm_tensor_core_kernel_is_bitwise_repeatable(cuda, l):
    """xLSTM-125M's chunk (B 4, H 4, hd 192) with a carried state: the
    tensor-core kernel gives the same bits call after call."""
    from repro_torch.kernels import mlstm_chunk as mk
    args = _mlstm_operands(4, 4, l, 192, l, torch.bfloat16, cuda)
    kern.reset_launches()
    first = mk.mlstm_chunk(*args)
    for _ in range(3):
        again = mk.mlstm_chunk(*args)
        assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert dict(kern.LAUNCHES) == {"mlstm_chunk": 4}


def _chip_smoke():
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


@pytest.mark.parametrize("b,s,t,h,hkv,hd,window,causal", [
    (1, 77, 77, 4, 4, 128, 0, True), (2, 200, 200, 8, 2, 128, 50, True),
    (1, 200, 77, 4, 1, 128, 0, True), (1, 200, 130, 4, 2, 64, 24, True),
    (2, 77, 77, 8, 1, 64, 16, True), (1, 300, 300, 4, 1, 256, 100, True),
    (1, 20, 37, 2, 1, 256, 0, True), (1, 37, 20, 2, 1, 64, 8, True),
    (1, 1, 70, 2, 1, 256, 0, True), (2, 256, 256, 4, 2, 128, 0, False),
    (2, 256, 200, 4, 2, 256, 0, False), (1, 130, 300, 4, 4, 64, 0, False)])
def test_flash_f32_kernel_is_f32_grade(cuda, b, s, t, h, hkv, hd, window,
                                       causal):
    """f32 at hd 64 / 128 / 256 launches the 3xTF32 tensor-core kernel,
    once a call, bitwise repeatably, within chip_smoke.F32_GRADE_TOL of
    the plain version row by row: S > T, S < T, ragged, windows (rows with
    no key in the window), non-causal."""
    from repro_torch.kernels import flash_attention as flash, ref
    cs = _chip_smoke()
    rng = np.random.default_rng(s + t + hd + window)
    q, k, v = (torch.tensor(_normal(rng, b, n, heads, hd)).to(cuda)
               for n, heads in ((s, h), (t, hkv), (t, hkv)))
    kern.reset_launches()
    got = flash.flash_attention(q, k, v, causal=causal, window=window)
    assert dict(kern.LAUNCHES) == {"flash_attention_f32": 1}
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert cs.row_rel_err(got, want) <= cs.F32_GRADE_TOL["flash"]
    assert torch.equal(got, flash.flash_attention(q, k, v, causal=causal,
                                                  window=window))


@pytest.mark.parametrize("l,hd", [(1, 64), (1, 192), (33, 128), (100, 192),
                                  (256, 64), (256, 192), (512, 64),
                                  (512, 128), (512, 192)])
def test_mlstm_f32_kernel_is_f32_grade(cuda, l, hd):
    """f32 at hd 64 / 128 / 192 up to 512 launches the 3xTF32 tensor-core
    kernel, once a call, bitwise repeatably, each of y, C', n' and m'
    within chip_smoke.F32_GRADE_TOL of the plain version."""
    from repro_torch.kernels import mlstm_chunk as mk, ref
    cs = _chip_smoke()
    args = _mlstm_operands(2, 3, l, hd, 7 + l + hd, torch.float32, cuda)
    kern.reset_launches()
    got = mk.mlstm_chunk(*args)
    assert dict(kern.LAUNCHES) == {"mlstm_chunk_f32": 1}
    for g, w, name in zip(got, ref.mlstm_chunk_ref(*args),
                          ("y", "c", "n", "m")):
        rel = float((g - w).abs().max() / w.abs().max())
        assert rel <= cs.F32_GRADE_TOL["mlstm"], (name, rel)
    again = mk.mlstm_chunk(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_kernel_route_is_taken_on_cuda_tensors(cuda):
    """self_attention and mlstm_apply launch their kernels on CUDA tensors
    (and only there), and agree with the plain route."""
    from repro_torch.models import attention, xlstm
    rng = np.random.default_rng(5)
    b, s, d, h, hkv, hd = 2, 40, 64, 4, 2, 16

    def t(*shape, scale=1.0):
        return torch.tensor(_normal(rng, *shape, scale=scale)).to(cuda)

    p = {"wq": t(d, h, hd, scale=d ** -0.5),
         "wk": t(d, hkv, hd, scale=d ** -0.5),
         "wv": t(d, hkv, hd, scale=d ** -0.5),
         "wo": t(h, hd, d, scale=(h * hd) ** -0.5)}
    x = t(b, s, d)
    pos = torch.arange(s, device=cuda)[None].expand(b, s)
    kw = dict(n_kv_heads=hkv, rope_theta=10_000.0, window=0)
    kern.reset_launches()
    for impl in ("naive", "chunked"):
        out, _ = attention.self_attention(p, x, pos, impl=impl, **kw)
    assert dict(kern.LAUNCHES) == {"flash_attention_simt": 2}   # f32
    want, _ = attention.self_attention(p, x, pos, kernel_impl="ref", **kw)
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-3, atol=2e-3)
    mp = {"wq": t(d, h, hd, scale=d ** -0.5),
          "wk": t(d, h, hd, scale=d ** -0.5),
          "wv": t(d, h, hd, scale=d ** -0.5),
          "wi": t(d, h, scale=d ** -0.5), "wf": t(d, h, scale=d ** -0.5),
          "fb": torch.full((h,), 3.0, device=cuda),
          "wo": t(h, hd, d, scale=(h * hd) ** -0.5)}
    kern.reset_launches()
    y, st = xlstm.mlstm_apply(mp, x, chunk=16)          # 2 chunks of 20
    assert dict(kern.LAUNCHES) == {"mlstm_chunk_simt": 2}   # f32
    y_ref, st_ref = xlstm.mlstm_apply(mp, x, chunk=16, impl="ref")
    assert sum(kern.LAUNCHES.values()) == 2
    for g, w in ((y, y_ref), *((st[k], st_ref[k]) for k in st)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=6e-3, atol=6e-3)


@pytest.mark.parametrize("s,t", [(1500, 1500), (416, 1500)])
def test_flash_non_causal_at_whispers_shapes(cuda, s, t):
    """Whisper large-v3's heads (H = Hkv = 20, hd 64) in bf16: the
    encoder's self-attention over 1,500 frames and the decoder's
    cross-attention of 416 queries over them, unmasked, against the
    plain version; one launch a call, bitwise repeatable."""
    from repro_torch.kernels import flash_attention as flash, ref
    rng = np.random.default_rng(s)
    q, k, v = (torch.tensor(_normal(rng, 1, n, 20, 64)).to(torch.bfloat16)
               .to(cuda) for n in (s, t, t))
    kern.reset_launches()
    got = flash.flash_attention(q, k, v, causal=False)
    assert dict(kern.LAUNCHES) == {"flash_attention": 1}
    want = ref.flash_attention_ref(q, k, v, causal=False)
    tol = FLASH_TOL[torch.bfloat16]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    assert torch.equal(got, flash.flash_attention(q, k, v, causal=False))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_apply_on_the_card_is_bitwise_repeatable(cuda, dtype):
    """The MoE mixer (index-write dispatch, batched expert products, the
    K rows of each token summed in a fixed order) gives the same bits
    twice, drops included, and agrees with the CPU in f32."""
    from repro_torch.models import moe
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = moe.moe_init(gen, 256, 512, 16, dtype, device=cuda)
    x = torch.randn((4, 256, 256), generator=gen, device=cuda).to(dtype)
    with torch.inference_mode():
        a = moe.moe_apply(p, x, 2, 0.75)
        b = moe.moe_apply(p, x, 2, 0.75)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    if dtype == torch.float32:
        cpu = moe.moe_apply({k: v.cpu() for k, v in p.items()}, x.cpu(), 2,
                            0.75)
        np.testing.assert_allclose(a[0].cpu().numpy(), cpu[0].numpy(),
                                   **F32)


def test_reduced_jamba_prefill_on_the_card_matches_the_cpu(cuda):
    """Reduced Jamba (f32; Mamba's chunk scan, MoE, one attention layer
    on the f32 flash kernel): prefill logits and caches on the card
    against the CPU's."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.synthetic import make_token_stream
    from repro_torch.models import transformer as tfm
    from repro_torch.utils.tree import tree_leaves, tree_map
    cfg = reduced(get_config("jamba-v0.1-52b"))
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.tensor(make_token_stream(cfg.vocab_size, 2, 48, seed=0))
    with torch.inference_mode():
        want, wc = tfm.prefill(cfg, params, toks, max_seq=60)
        kern.reset_launches()
        got, gc = tfm.prefill(cfg, tree_map(lambda a: a.to(cuda), params),
                              toks.to(cuda), max_seq=60)
    assert dict(kern.LAUNCHES) == {"flash_attention_f32": 1}
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
    for g, w in zip(tree_leaves(gc), tree_leaves(wc)):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name,prompt_len", [("llama3-8b", 48),
                                             ("xlstm-125m", 40),
                                             ("jamba-v0.1-52b", 32),
                                             ("whisper-large-v3", 16)])
def test_reduced_serve_through_the_kernels(cuda, name, prompt_len):
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.flash_attention import flash_route
    from repro_torch.kernels.mlstm_chunk import mlstm_route
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as tfm
    cfg = reduced(get_config(name))
    params = tfm.init_params(cfg, torch.Generator(device=cuda)
                             .manual_seed(0), device=cuda)
    kern.reset_launches()
    res = serve(cfg, 2, prompt_len, 6, params=params)
    launches = dict(kern.LAUNCHES)
    plain = serve(cfg, 2, prompt_len, 6, params=params, impl="ref")
    if name != "xlstm-125m":
        # one launch a self-attention layer, encoder's included, and one
        # a cross-attention layer
        layers = cfg.all_layers() + [b for st in cfg.encoder_stages
                                     for b in st.pattern * st.repeats]
        route = flash_route(getattr(torch, cfg.dtype), cfg.head_dim)
        assert launches == {route: sum(
            (b.mixer == "attn") + b.cross_attn for b in layers)}
    else:
        route = mlstm_route(getattr(torch, cfg.dtype), cfg.head_dim,
                            prompt_len // 2)
        assert launches == {route: 5 * 2}   # 5 mLSTM layers x 2 chunks
    np.testing.assert_array_equal(res["generated"], plain["generated"])


# ---------------------------------------------------------------------------
# the paper's evaluation
# ---------------------------------------------------------------------------

def test_fig1_on_the_card_matches_the_cpu(cuda):
    """Fig. 1 on diabetes, 20 iterations: the same torch.Generator weights
    on both devices; the card's rows through the cut kernels (a sweep of
    AFTO and SFTO, the default engine: the batched kernels)."""
    from repro_torch.experiments import fig1_robust_hpo as fig1

    want = fig1.run_dataset("diabetes", 20, device="cpu")
    kern.reset_launches()
    got = fig1.run_dataset("diabetes", 20, device=cuda)
    assert kern.LAUNCHES["matvec_runs"] > 0 \
        and kern.LAUNCHES["vecmat_runs"] > 0
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert (g["algo"], g["iter"], g["sim_time"]) == \
            (w["algo"], w["iter"], w["sim_time"])
        for k in ("mse_clean", "mse_noisy", "gap_sq"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=0,
                                       err_msg=k)


def test_baselines_on_the_card_match_the_cpu(cuda):
    from repro_torch.apps import baselines, robust_hpo

    hists = {}
    for dev in ("cpu", cuda):
        task = robust_hpo.make_robust_hpo_problem("diabetes", n_workers=4,
                                                  seed=0, device=dev)
        kern.reset_launches()
        adbo = baselines.run_adbo(task, n_iterations=20, seed=0)
        hists[str(dev)] = (baselines.run_fednest(task, n_iterations=20,
                                                 seed=0)["history"],
                           adbo["history"], dict(kern.LAUNCHES))
    (fed_c, adbo_c, _), (fed_g, adbo_g, launches) = hists.values()
    assert launches["matvec"] > 0 and launches["vecmat"] > 0
    np.testing.assert_allclose(fed_g["val_mse"], fed_c["val_mse"],
                               rtol=1e-4, atol=0)
    np.testing.assert_allclose(adbo_g["val_mse"], adbo_c["val_mse"],
                               rtol=1e-4, atol=0)
    for k in ("n_cuts_i", "n_cuts_ii"):
        assert list(adbo_g[k]) == list(adbo_c[k])


def test_curvature_through_the_cut_kernels(cuda):
    """Reverse over reverse through the MV kernel's autograd Function."""
    from repro_torch.core import curvature_along, estimate_mu
    from repro_torch.kernels import cut_ad

    a, v, _, d = _operands(8, 57_366, 3, torch.float32, cuda)

    def fn(a):
        return lambda x: -torch.sum(cut_ad.MV.apply(a, x) ** 2) \
            + torch.sum(torch.sin(x))

    kern.reset_launches()
    got = curvature_along(fn(a), v, d)
    assert kern.LAUNCHES["matvec"] > 0 and kern.LAUNCHES["vecmat"] > 0
    want = curvature_along(fn(a.cpu()), v.cpu(), d.cpu())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4,
                               atol=1e-5)
    mu = estimate_mu(fn(a), v, torch.Generator().manual_seed(0),
                     n_samples=4)
    assert float(mu) > 0


# ---------------------------------------------------------------------------
# the sweep engine: batched kernels and a swept run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,p,d", [(2, 8, 242_628), (3, 2, 925_590),
                                   (4, 3, 33), (2, 13, 5001),
                                   (3, 8, 242_628), (5, 8, 57_366),
                                   (8, 2, 925_590), (8, 13, 5001),
                                   (5, 1, 10_000_000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_kernels_are_the_single_run_kernels_row_by_row(cuda, r, p,
                                                               d, dtype):
    """Up to R = 8 runs, several waves of blocks; (13, 5001) takes two row
    groups a block and (1, 10,000,000) ten slices of v a block."""
    ops_ = [_operands(p, d, 10 * k + p, dtype, cuda) for k in range(r)]
    a, v, g, y = (torch.stack(x) for x in zip(*ops_))
    kern.reset_launches()
    got = (kern.matvec(a, v), kern.vecmat(g, a), kern.rank1(g, y))
    assert dict(kern.LAUNCHES) == {"matvec_runs": 1, "vecmat_runs": 1,
                                   "rank1_runs": 1}
    assert int(kern._ticket(a, r).abs().sum()) == 0
    tol = F32 if dtype == torch.float32 else BF16
    for out, want in zip(got, (kern.matvec_ref(a, v),
                               kern.vecmat_ref(g, a),
                               kern.rank1_ref(g, y))):
        np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                                   **tol)
    for k in range(r):
        assert torch.equal(got[0][k], kern.matvec(a[k], v[k]))
        assert torch.equal(got[1][k], kern.vecmat(g[k], a[k]))
        assert torch.equal(got[2][k], kern.rank1(g[k], y[k]))
    # a shared operand at run stride 0
    shared = kern.matvec(a, v[0].expand(v.shape))
    for k in range(r):
        assert torch.equal(shared[k], kern.matvec(a[k], v[0]))


@pytest.mark.parametrize("r,p,d,rows", [(2, 8, 242_628, 8),
                                        (4, 8, 242_628, 7),
                                        (8, 8, 242_628, 3),
                                        (8, 2, 1_200_000, 0)])
def test_batched_fused_round_rows_at_its_plan(cuda, r, p, d, rows):
    """White wine: two runs hold A on chip, four hold 7 of its 8 rows,
    eight 3; eight runs of a wider A stream it.  Each row is the single-run
    kernel at the batched plan, and every counter is back at 0."""
    rounds = [_round_operands(p, d, 7 + k, torch.float32, cuda)
              for k in range(r)]
    o = {k: torch.stack([x[k] for x in rounds]) for k in ROUND_ARGS}
    kw = dict(zip(("eta_z", "eta_s", "eta_dual", "rho2"), STEPS))
    plan = inner_round.plan_for(o["a"])
    assert plan.on_chip == (rows == p) and plan.rows_on_chip == rows
    kern.reset_launches()
    got = inner_round.fused_cut_round(*(o[k] for k in ROUND_ARGS), **kw)
    assert dict(kern.LAUNCHES) == {"fused_round_runs": 1}
    assert int(kern._ticket(o["a"], r).abs().sum()) == 0
    want = inner_round.fused_cut_round_ref(*(o[k] for k in ROUND_ARGS), **kw)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), **F32)
    for k in range(r):
        one = inner_round.fused_cut_round(*(o[n][k] for n in ROUND_ARGS),
                                          plan=plan, **kw)
        assert all(torch.equal(x[k], y) for x, y in zip(got, one))
        assert int(kern._ticket(o["a"]).item()) == 0


def test_sweep_launches_only_batched_kernels(cuda):
    from repro_torch.apps.robust_hpo import default_hyper
    from repro_torch.apps.robust_hpo import make_robust_hpo_problem
    task = make_robust_hpo_problem("diabetes", n_workers=4, seed=0,
                                   device=cuda)
    for fused in (False, True):
        hyper = default_hyper(task, 4, 3, 10, use_fused_inner=fused)
        spec = RunSpec(problem=task.problem, hyper=hyper, n_iterations=12,
                       metrics_every=6,
                       scheduler=StragglerConfig(4, 3, 10, n_stragglers=1))
        kern.reset_launches()
        swept = run(dataclasses.replace(spec, engine="sweep", seeds=(0, 1)))
        launched = dict(kern.LAUNCHES)
        assert launched["matvec_runs"] > 0 and launched["vecmat_runs"] > 0
        assert ("fused_round_runs" in launched) == fused
        assert not {"matvec", "vecmat", "fused_round"} & set(launched)
        for k, seed in enumerate((0, 1)):
            one = run(dataclasses.replace(spec, scheduler=StragglerConfig(
                4, 3, 10, n_stragglers=1, seed=seed)))
            np.testing.assert_allclose(swept.run(k).history["gap_sq"],
                                       one.history["gap_sq"], rtol=1e-4)
            assert list(swept.run(k).history["n_cuts_ii"]) == \
                list(one.history["n_cuts_ii"])


# ---------------------------------------------------------------------------
# the worker mesh on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,width", [("nccl", 1), ("gloo", 2)])
def test_worker_mesh_on_the_card(cuda, backend, width):
    """The sharded scan of the quadratic on a 1-rank NCCL mesh and on 2
    gloo ranks sharing the card, held to the unsharded plain-route scan on
    the card at the reference's sharded tolerances (states rtol 5e-5 /
    atol 1e-6, gap_sq rtol 5e-4, cut counts exact): the ranks agree bit
    for bit, all-reduce `traffic_record`'s bytes and launch no kernel."""
    import pathlib

    import torch.utils._pytree as pytree
    import torch_mesh_ranks as ranks
    from repro_torch.core import StragglerScheduler, run_scanned, sharded
    from repro_torch.launch.mesh import spawn_mesh

    rng = np.random.default_rng(0)
    data = {"A": (rng.normal(size=(4, 3, 3)) * 0.3).astype(np.float32),
            "b": rng.normal(size=(4, 3)).astype(np.float32)}
    cfg = StragglerConfig(n_workers=4, s_active=3, tau=5, n_stragglers=1,
                          straggler_slowdown=5.0, seed=0)
    sched = StragglerScheduler(cfg).precompute(40)
    arrays = {"active": sched.active, "sim_time": sched.sim_time,
              "max_staleness": sched.max_staleness}
    out = spawn_mesh("torch_mesh_ranks:card_case", width, backend=backend,
                     device="cuda", args=(data, arrays),
                     pythonpath=[str(pathlib.Path(__file__).parent)],
                     timeout=300)
    want = run_scanned(ranks.quad_problem(data, device=cuda),
                       dataclasses.replace(ranks.hyper(), cut_impl="ref"),
                       sched, metrics_every=5)
    _leaves = pytree.tree_leaves
    got = out[0]
    assert got["device"].startswith("cuda")
    for x, y in zip(_leaves(got["state"]), _leaves(want.state)):
        np.testing.assert_allclose(x.numpy(), y.cpu().numpy(), rtol=5e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(got["history"]["gap_sq"],
                               want.history["gap_sq"], rtol=5e-4, atol=1e-6)
    for k in ("n_cuts_i", "n_cuts_ii", "t"):
        np.testing.assert_array_equal(got["history"][k], want.history[k])
    rec = sharded.traffic_record(want.state.cuts_ii.spec, ranks.hyper())
    for r in out:
        assert all(torch.equal(x, y) for x, y in zip(_leaves(r["state"]),
                                                     _leaves(got["state"])))
        assert r["traffic"]["step"] == 40 * rec["step_bytes"]
        assert r["traffic"]["refresh"] == 8 * rec["refresh_bytes"]
        assert r["traffic"]["gap"] == 8 * rec["gap_bytes"]
        assert sum(r["launches"].values()) == 0


# ---------------------------------------------------------------------------
# the LLM training path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["requires_grad", "torch.func.grad"])
def test_kernel_wrappers_refuse_differentiable_inputs(cuda, how):
    """The flash and mLSTM kernels compute forwards only: handed a tensor
    that a gradient can flow through, each wrapper raises instead of
    returning an output with no gradient."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm_chunk as mc

    q = torch.randn(1, 64, 4, 128, device=cuda, dtype=torch.bfloat16)
    qkv = [torch.randn(1, 4, 64, 128, device=cuda, dtype=torch.bfloat16)
           for _ in range(3)]
    gates = [-torch.rand(1, 4, 64, 1, device=cuda) for _ in range(2)]
    st = [torch.zeros(1, 4, 128, 128, device=cuda),
          torch.zeros(1, 4, 1, 128, device=cuda),
          torch.zeros(1, 4, 1, 1, device=cuda)]
    calls = [(lambda a: fa.flash_attention(a, q, q), q),
             (lambda a: mc.mlstm_chunk(a, *qkv[1:], *gates, *st)[0],
              qkv[0])]
    for call, x in calls:
        with pytest.raises(RuntimeError, match="forward only"):
            if how == "requires_grad":
                call(x.detach().requires_grad_(True))
            else:
                torch.func.grad(lambda a: call(a).float().sum())(x)
        with torch.no_grad():
            call(x.detach().requires_grad_(True))


def test_sketch_on_the_card_is_deterministic_and_matches_the_cpu(cuda):
    """The card's fixed-point scatter-add gives the same bits twice on a
    2^27-element leaf, and agrees with the CPU's f32 sum (the
    reference's order) within 1e-6 of the largest bucket."""
    import importlib
    sk = importlib.import_module("repro_torch.fed.sketch")

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(1 << 27, generator=g, device=cuda)
    a, b = sk.sketch({"w": x}, 3, 256), sk.sketch({"w": x}, 3, 256)
    assert torch.equal(a, b)
    tree = {"w": x[:1 << 22].reshape(1024, -1), "b": x[-5000:],
            "h": x[7:7 + 30_000].to(torch.bfloat16)}
    got = sk.sketch(tree, 5, 4096).cpu()
    want = sk.sketch({k: v.cpu() for k, v in tree.items()}, 5, 4096)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    rows = torch.stack([tree["w"][:8], tree["w"][8:16]])
    assert torch.equal(sk.sketch_rows({"r": rows}, 2, 64, batch_dims=1),
                       sk.sketch_rows({"r": rows}, 2, 64, batch_dims=1))


def test_sketch_on_the_card_marks_a_non_finite_row(cuda):
    """A row holding a NaN sketches to NaN in every bucket; the other rows
    keep the bits they have when sketched without it (the fixed point's
    scale is taken over the finite rows)."""
    import importlib
    sk = importlib.import_module("repro_torch.fed.sketch")

    g = torch.Generator(device=cuda).manual_seed(1)
    rows = torch.randn(3, 40, 50, generator=g, device=cuda)
    rows[1, 7, 3] = float("nan")
    got = sk.sketch_rows({"r": rows}, 2, 64, batch_dims=1)
    assert bool(torch.isnan(got[1]).all())
    for i in (0, 2):
        alone = sk.sketch_rows({"r": rows[i:i + 1]}, 2, 64, batch_dims=1)
        assert torch.equal(got[i], alone[0])
