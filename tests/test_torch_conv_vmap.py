"""LeNet-5's convolution under the sweep engine's vmap (the port alone,
on the CPU): `models.simple.Conv2d` runs one convolution per swept run
at the serial run's shapes, forward and in every derivative, so the
convolutions of a swept Fig. 2 refresh (grad-of-grad through LeNet-5)
are each row's serial run's; functorch's own batching of F.conv2d folds
the runs into channel groups, which sum in another order (ROADMAP.md
Queue 3, item 12)."""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.apps.domain_adaptation import (default_hyper,
                                                make_domain_adaptation_problem)
from repro_torch.core.engine import run_scanned, run_swept
from repro_torch.core.scheduler import StragglerConfig, StragglerScheduler
from repro_torch.models import simple
from repro_torch.models.simple import Conv2d

N, S, TAU = 2, 2, 5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run torch's CPU ops on one thread: the suite runs
    files in parallel processes, and torch's default of a thread per
    core oversubscribes the machine (one test ran 7x slower for it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain_conv2d(x, w):
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def _fig2_refresh():
    """Fig. 2's MNIST-pretrain problem cut to two workers (N 2, S 2, tau
    5, K 1, P 2) with t_pre 2: two iterations, one refresh, swept over
    schedule seeds 0 and 1 and run one seed at a time; the largest
    difference of any final state leaf, over its largest magnitude."""
    task = make_domain_adaptation_problem(
        N, pretrain_domain="mnist", n_pretrain_per=8, n_finetune_per=4,
        seed=0, device="cpu")
    hyper = default_hyper(N, S, TAU, t_pre=2, k_inner=1, p_max=2)
    scheds = [StragglerScheduler(StragglerConfig(
        n_workers=N, s_active=S, tau=TAU, n_stragglers=1, seed=seed))
        .precompute(2) for seed in (0, 1)]
    swept = run_swept(task.problem, hyper, scheds, metrics_every=2)
    worst, n_cuts = 0.0, []
    for r, sched in enumerate(scheds):
        one = run_scanned(task.problem, hyper, sched, metrics_every=2)
        row = swept.run(r)
        n_cuts.append(float(one.state.cuts_ii.active.sum()))
        for a, b in zip(torch.utils._pytree.tree_leaves(row.state),
                        torch.utils._pytree.tree_leaves(one.state)):
            if a.is_floating_point() and b.numel():
                scale = max(float(b.abs().max()), 1e-30)
                worst = max(worst, float((a - b).abs().max()) / scale)
    assert all(c >= 1 for c in n_cuts)
    return worst


def test_swept_fig2_refresh_with_and_without_the_rule(monkeypatch):
    """With the rule the swept rows sit within 1e-6 of their serial runs
    (on the CPU the batched matmuls of LeNet's dense layers keep the rest:
    7.7e-8), over ten times closer than with functorch's batching of
    F.conv2d (9.3e-6), which still holds the sweep gate of 1e-4."""
    with_rule = _fig2_refresh()
    monkeypatch.setattr(simple, "_conv2d", _plain_conv2d)
    without = _fig2_refresh()
    assert with_rule <= 1e-6 and without <= 1e-4
    assert with_rule * 10 <= without


@pytest.mark.parametrize("padding", [(0, 0), (1, 1)])
def test_conv2d_derivatives_match_f_conv2d(padding):
    """Values, first and second derivatives equal F.conv2d's (f64), and
    vmap(grad) is bitwise the loop of single runs."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 2, 9, 8, generator=g, dtype=torch.float64)
    w = torch.randn(4, 2, 3, 2, generator=g, dtype=torch.float64)

    def loss(conv):
        return lambda a, b: (conv(a, b) ** 2).sum()

    ours = loss(lambda a, b: Conv2d.apply(a, b, padding))
    ref = loss(lambda a, b: F.conv2d(a, b, padding=padding))
    def grad_sq(f):
        return lambda a, b: sum((t ** 2).sum() for t in torch.func.grad(
            f, argnums=(0, 1))(a, b))

    got = torch.func.grad(ours, argnums=(0, 1))(x, w) \
        + torch.func.grad(grad_sq(ours), argnums=(0, 1))(x, w)
    want = torch.func.grad(ref, argnums=(0, 1))(x, w) \
        + torch.func.grad(grad_sq(ref), argnums=(0, 1))(x, w)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-9)
    xs = torch.randn(2, 3, 2, 9, 8, generator=g, dtype=torch.float64)
    ws = torch.randn(2, 4, 2, 3, 2, generator=g, dtype=torch.float64)
    gv = torch.func.vmap(torch.func.grad(ours, argnums=(0, 1)))(xs, ws)
    for r in range(2):
        gs = torch.func.grad(ours, argnums=(0, 1))(xs[r], ws[r])
        assert torch.equal(gv[0][r], gs[0]) and torch.equal(gv[1][r], gs[1])
