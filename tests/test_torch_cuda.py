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

from repro_torch.core import Hyper, RunSpec, TrilevelProblem, run
from repro_torch.kernels import ops
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


@pytest.mark.parametrize("p,d", [(3, 33), (8, 57_366), (13, 5000)])
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
