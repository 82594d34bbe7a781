"""The port's Table 2 baselines (`repro_torch.apps.baselines`) and
mu-weak-convexity tools (`repro_torch.core.weakly_convex`) against the
reference on identical inputs, on the CPU.

Histories within rtol 1e-4 with the cut counts exact, as the port's
other trajectory tests (tests/test_torch_engine.py); FedNest's final phi
and the weak-convexity values within 1e-5.  The Prop. 3.3 and estimate_mu
checks are those of tests/test_cuts.py, written with the port's
functions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import baselines as jax_baselines
from repro.apps import robust_hpo as jax_hpo
from repro.core import weakly_convex as jax_wc
from repro.kernels import cut_ad as jax_cut_ad
from repro_torch import convert
from repro_torch.apps import baselines, robust_hpo
from repro_torch.core import curvature_along, estimate_mu, first_order_gap
from repro_torch.kernels import cut_ad

HIST = dict(rtol=1e-4, atol=0.0)
WC = dict(rtol=1e-5, atol=1e-5)
N_ITERATIONS = 30


@pytest.fixture(scope="module")
def tasks():
    """The reference's diabetes task (N=4) and the port's with the
    reference's initial MLP carried over."""
    jt = jax_hpo.make_robust_hpo_problem("diabetes", n_workers=4, seed=0)
    w0 = convert.to_torch(jax.tree.map(np.asarray, jt.problem.x3_init),
                          "cpu")
    tt = robust_hpo.make_robust_hpo_problem("diabetes", n_workers=4,
                                            seed=0, device="cpu", w0=w0)
    return jt, tt


# ---------------------------------------------------------------------------
# Table 2 baselines
# ---------------------------------------------------------------------------

def test_fednest_matches_reference(tasks):
    jt, tt = tasks
    want = jax_baselines.run_fednest(jt, n_iterations=N_ITERATIONS, seed=0)
    got = baselines.run_fednest(tt, n_iterations=N_ITERATIONS, seed=0)
    h, hw = got["history"], want["history"]
    assert set(h) == {"t", "sim_time", "val_mse"}
    assert h["t"] == list(hw["t"]) == [10, 20, 30]
    assert h["sim_time"] == list(hw["sim_time"])
    np.testing.assert_allclose(h["val_mse"], hw["val_mse"], **HIST)
    assert h["val_mse"][-1] < h["val_mse"][0]
    np.testing.assert_allclose(got["phi"].numpy(), np.asarray(want["phi"]),
                               rtol=0, atol=1e-5)
    assert float(got["phi"][0]) != -3.0
    for k, v in want["w"].items():
        np.testing.assert_allclose(got["w"][k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_fednest_hypergradient_reaches_phi_through_the_updates(tasks):
    """phi enters the weights only through the unrolled inner steps'
    gradients: without those paths g_phi would be 0 and phi would stay
    at its initial -3."""
    _, tt = tasks
    out = baselines.run_fednest(tt, n_iterations=2, seed=0)
    assert out["phi"].shape == (1,)
    assert abs(float(out["phi"][0]) + 3.0) > 1e-7
    assert not out["phi"].requires_grad
    assert not any(v.requires_grad for v in out["w"].values())


def test_adbo_matches_reference(tasks):
    jt, tt = tasks
    want = jax_baselines.run_adbo(jt, n_iterations=N_ITERATIONS, seed=0)
    got = baselines.run_adbo(tt, n_iterations=N_ITERATIONS, seed=0)
    h, hw = got["history"], want["history"]
    for k in ("t", "sim_time"):
        np.testing.assert_array_equal(h[k], np.asarray(hw[k]))
    for k in ("val_mse", "gap_sq"):
        assert np.all(np.isfinite(h[k]))
        np.testing.assert_allclose(h[k], np.asarray(hw[k]), **HIST,
                                   err_msg=k)
    for k in ("n_cuts_i", "n_cuts_ii"):
        assert list(h[k]) == list(np.asarray(hw[k])), k
    assert list(h["n_cuts_i"]) != [0.0] * len(h["n_cuts_i"])
    np.testing.assert_allclose(got["phi"].numpy(), np.asarray(want["phi"]),
                               rtol=1e-4, atol=1e-6)
    for k, v in want["w"].items():
        np.testing.assert_allclose(got["w"][k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# mu-weak convexity
# ---------------------------------------------------------------------------

def _cos_bowl(xp):
    """h(v) = ||v||^2 + 0.5 sum cos(2v): curvature in [0, 4]."""
    return lambda v: xp.sum(v ** 2) + 0.5 * xp.sum(xp.cos(2.0 * v))


def _tilted(xp):
    """||x||^2 - 0.3 (sum x)^2: Hessian 2I - 0.6 11^T."""
    return lambda x: xp.sum(x ** 2) - 0.3 * xp.sum(x) ** 2


def _tree_fn(xp):
    """A function of a two-leaf tree, concave along some directions."""
    return lambda p: xp.sum(xp.tanh(p["w"]) ** 2) - 0.5 * xp.sum(
        p["b"] ** 2) + xp.sum(p["w"][:3] * p["b"])


FNS = {"cos_bowl": _cos_bowl, "tilted": _tilted}


def _draws(seed, shape, n):
    key = jax.random.PRNGKey(seed)
    return [np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape))
            for i in range(n)]


@pytest.mark.parametrize("name", sorted(FNS))
def test_curvature_along_matches_reference(name):
    fj, ft = FNS[name](jnp), FNS[name](torch)
    pts, dirs = _draws(0, (5,), 6), _draws(1, (5,), 6)
    for p, d in zip(pts, dirs):
        want = float(jax_wc.curvature_along(fj, jnp.asarray(p),
                                            jnp.asarray(d)))
        got = curvature_along(ft, torch.tensor(p), torch.tensor(d))
        assert got.shape == ()
        np.testing.assert_allclose(float(got), want, **WC)


def test_curvature_along_trees_matches_reference():
    fj, ft = _tree_fn(jnp), _tree_fn(torch)
    ws, bs = _draws(2, (4,), 4), _draws(3, (3,), 4)
    dws, dbs = _draws(4, (4,), 4), _draws(5, (3,), 4)
    for w, b, dw, db in zip(ws, bs, dws, dbs):
        want = float(jax_wc.curvature_along(
            fj, {"w": jnp.asarray(w), "b": jnp.asarray(b)},
            {"w": jnp.asarray(dw), "b": jnp.asarray(db)}))
        got = curvature_along(
            ft, {"w": torch.tensor(w), "b": torch.tensor(b)},
            {"w": torch.tensor(dw), "b": torch.tensor(db)})
        np.testing.assert_allclose(float(got), want, **WC)


def test_curvature_along_through_the_cut_functions():
    """Reverse over reverse through `cut_ad.MV` (the kernel route's
    autograd Function; its plain version on the CPU) against the
    reference's forward over reverse through its `matvec` primitive
    (the Pallas kernel in interpret mode)."""
    a = _draws(6, (4, 7), 1)[0] * 0.5
    pts, dirs = _draws(7, (7,), 3), _draws(8, (7,), 3)
    a_t = torch.tensor(a)
    for p, d in zip(pts, dirs):
        want = float(jax_wc.curvature_along(
            lambda v: -jnp.sum(jax_cut_ad.matvec(jnp.asarray(a), v) ** 2)
            + jnp.sum(jnp.sin(v)), jnp.asarray(p), jnp.asarray(d)))
        got = curvature_along(
            lambda v: -torch.sum(cut_ad.MV.apply(a_t, v) ** 2)
            + torch.sum(torch.sin(v)), torch.tensor(p), torch.tensor(d))
        np.testing.assert_allclose(float(got), want, **WC)


def test_curvature_of_a_linear_function_is_zero():
    got = curvature_along(lambda x: torch.sum(3.0 * x), torch.ones(4),
                          torch.arange(4.0))
    assert float(got) == 0.0


@pytest.mark.parametrize("name", sorted(FNS))
def test_first_order_gap_matches_reference(name):
    fj, ft = FNS[name](jnp), FNS[name](torch)
    xs, refs = _draws(9, (3,), 8), _draws(10, (3,), 8)
    for mu in (0.0, 2.0):
        for x, xr in zip(xs, refs):
            want = float(jax_wc.first_order_gap(fj, jnp.asarray(x),
                                                jnp.asarray(xr), mu))
            got = first_order_gap(ft, torch.tensor(x), torch.tensor(xr), mu)
            np.testing.assert_allclose(float(got), want, **WC)


def test_first_order_gap_nonneg_for_quadratic():
    """tests/test_cuts.py's check, on torch draws: the tilted quadratic is
    2-weakly convex in 3 dimensions."""
    fn = _tilted(torch)
    gen = torch.Generator().manual_seed(1)
    for _ in range(50):
        x, xr = torch.randn(3, generator=gen), torch.randn(3, generator=gen)
        assert float(first_order_gap(fn, x, xr, 2.0)) >= -1e-5


def test_estimate_mu_convex_is_zero():
    mu = estimate_mu(lambda x: torch.sum(x ** 2), torch.zeros(4),
                     torch.Generator().manual_seed(0))
    assert float(mu) <= 1e-6


def test_estimate_mu_detects_concavity():
    mu = estimate_mu(lambda x: -torch.sum(x ** 2), torch.zeros(4),
                     torch.Generator().manual_seed(0))
    assert abs(float(mu) - 2.0) < 0.2


def test_estimate_mu_is_seeded_and_bounds_the_curvature():
    fn = _tree_fn(torch)
    point = {"w": torch.zeros(4), "b": torch.zeros(3)}
    mus = [float(estimate_mu(fn, point, torch.Generator().manual_seed(3)))
           for _ in range(2)]
    assert mus[0] == mus[1] > 0.0
    # -0.5 ||b||^2 alone has curvature -1 along b
    assert mus[0] >= 0.5


def test_mu_cut_validity_on_weakly_convex_fn():
    """The linearization c-bound must contain every feasible point
    (Prop. 3.3): for h mu-weakly convex and any point with h(v) <= eps,
    <g, v> <= c must hold; mu itself is checked with the port's
    estimate_mu and first_order_gap."""
    h = _cos_bowl(torch)
    mu = 2.0 * 0.5 * 2.0  # |d2/dv2 of 0.5*cos(2v)| <= 2
    gen = torch.Generator().manual_seed(0)
    assert float(estimate_mu(h, torch.zeros(3), gen)) <= mu
    alpha = 4.0   # bound ||v||^2 <= alpha
    eps = float(h(torch.zeros(3))) + 0.3

    v0 = (torch.randn(3, generator=gen) * 0.5).requires_grad_(True)
    g, = torch.autograd.grad(h(v0), [v0])
    v0 = v0.detach()
    c = eps + mu * (alpha + float(torch.sum(v0 ** 2))) - float(h(v0)) \
        + float(g @ v0)

    # sample feasible points within the alpha-ball; none may violate
    n_feasible = 0
    for _ in range(200):
        v = torch.randn(3, generator=gen)
        v = v / torch.clamp(torch.linalg.norm(v) / 2.0, min=1.0)  # ||v||<=2
        assert float(first_order_gap(h, v, v0, mu)) >= -1e-5
        if float(h(v)) <= eps:
            n_feasible += 1
            assert float(g @ v) <= c + 1e-4
    assert n_feasible > 0


def test_adbo_equals_afto_while_no_ii_cut_binds(tasks):
    """Table 2's AFTO and ADBO differ only through the cuts: while no
    II-layer cut binds (lam = 0), x3 moves by f1's gradient and the
    consensus duals alone, so on the same arrival schedule the two give
    the same weights, in the reference as in the port."""
    from repro.core import RunSpec as JaxRunSpec
    from repro.core import StragglerConfig as JaxStragglerConfig
    from repro.core import run as jax_run
    from repro_torch.core import RunSpec, StragglerConfig, run

    jt, tt = tasks
    n, cfg = 4, dict(n_workers=4, s_active=3, tau=10, n_stragglers=1,
                     seed=0)
    ref_afto = jax_run(JaxRunSpec(
        problem=jt.problem, hyper=jax_hpo.default_hyper(jt, n, 3, 10),
        scheduler=JaxStragglerConfig(**cfg), n_iterations=20)).state
    ref_adbo = jax_baselines.run_adbo(jt, n_iterations=20, seed=0)["w"]
    afto = run(RunSpec(
        problem=tt.problem, hyper=robust_hpo.default_hyper(tt, n, 3, 10),
        scheduler=StragglerConfig(**cfg), n_iterations=20,
        device="cpu")).state
    adbo = baselines.run_adbo(tt, n_iterations=20, seed=0)["w"]
    assert float(np.max(np.abs(np.asarray(ref_afto.lam)))) == 0.0
    assert float(afto.lam.abs().max()) == 0.0
    for k, v in ref_adbo.items():
        np.testing.assert_array_equal(
            np.asarray(jnp.mean(ref_afto.X3[k], 0)), np.asarray(v))
        np.testing.assert_array_equal(afto.X3[k].mean(0).numpy(),
                                      adbo[k].numpy())
