"""The port's core modules (`repro_torch.core`, utils, data, models)
against the reference on identical inputs, on the CPU.

Tolerances are the reference's own: cut-row maintenance and the
scheduler and dataset arrays bitwise; rollout states 1e-5/1e-6
(tests/test_inner_fused.py); f32 values and gradients 1e-4/1e-5
(tests/test_kernels.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_hyper, make_quadratic_problem
from repro.apps import robust_hpo as jax_hpo
from repro.core import afto as jax_afto
from repro.core import cuts as jax_cuts
from repro.core import inner as jax_inner
from repro.core import lagrangian as jax_lag
from repro.core import scheduler as jax_sched
from repro.core import stationarity as jax_stat
from repro.core import types as jax_types
from repro.data import synthetic as jax_synth
from repro_torch import convert
from repro_torch.apps import robust_hpo
from repro_torch.core import afto, cuts, inner, lagrangian, scheduler
from repro_torch.core import stationarity, types
from repro_torch.data import synthetic
from repro_torch.models.simple import mlp_init
from repro_torch.utils import tree

STATE = dict(rtol=1e-5, atol=1e-6)
F32 = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    return np.asarray(x)


def assert_trees_close(got, want, **tol):
    """Port tree vs reference tree, leaf by leaf in the shared sorted-key
    order; state dataclasses field by field (their leaves follow field
    order in the reference)."""
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            if f.name != "spec":
                assert_trees_close(getattr(got, f.name),
                                   getattr(want, f.name), **tol)
        return
    got_l = jax.tree.leaves(convert.to_numpy(got))
    want_l = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), **tol)


assert_states_close = assert_trees_close


# ---------------------------------------------------------------------------
# problems on both sides
# ---------------------------------------------------------------------------

def quad_problems(n_workers=4, dim=3):
    """`conftest.make_quadratic_problem` and its port on the same data."""
    jp = make_quadratic_problem(n_workers=n_workers, dim=dim)
    data = {k: torch.tensor(_np(v)) for k, v in jp.data.items()}

    def f1(d, x1, x2, x3):
        return torch.sum((x1 - d["A"] @ x3 - d["b"]) ** 2)

    def f2(d, x1, x2, x3):
        return torch.sum((x2 + x3) ** 2) + 0.1 * torch.sum(x2 ** 2)

    def f3(d, x1, x2, x3):
        return torch.sum((x3 - x1) ** 2) + 0.1 * torch.sum((x3 - x2) ** 2)

    tp = types.TrilevelProblem(
        f1=f1, f2=f2, f3=f3, data=data, n_workers=n_workers,
        x1_init=torch.zeros(dim), x2_init=torch.zeros(dim),
        x3_init=torch.zeros(dim))
    return jp, tp


def port_hyper(**kw):
    base = dict(n_workers=4, s_active=3, tau=5, k_inner=3, p_max=6,
                t_pre=5, t1=100, eta_x=0.05, eta_z=0.05, d1=3)
    base.update(kw)
    return types.Hyper(**base)


def stepped_states(n_steps=7):
    """A reference state with live cuts (steps plus one refresh), and the
    same state carried into the port."""
    jp, tp = quad_problems()
    jh = make_hyper()
    st = jax_afto.init_state(jp, jh)
    masks = np.random.default_rng(0).uniform(size=(n_steps, 4)) > 0.3
    for it in range(n_steps):
        st = jax_afto.afto_step(jp, jh, st,
                                jnp.asarray(masks[it], jnp.float32))
        if it == 4:
            st = jax_afto.cut_refresh(jp, jh, st)
    host = jax.tree.map(np.asarray, st)
    return jp, tp, jh, port_hyper(), st, convert.state_from_reference(
        host, "cpu")


# ---------------------------------------------------------------------------
# utils, spec, cut rows
# ---------------------------------------------------------------------------

def test_tree_leaves_follow_jax_sorted_key_order():
    t = {"w0": np.ones(2), "b0": np.zeros(1), "w1": np.full(3, 2.0),
         "b1": np.zeros(2), "nested": {"z": 1.0, "a": [np.ones(1), 2.0]}}
    got = tree.tree_leaves(t)
    want = jax.tree.leaves(t)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    leaves, tdef = tree.tree_flatten(t)
    rebuilt = tree.tree_unflatten(tdef, leaves)
    assert set(rebuilt) == set(t) and tree.tree_leaves(rebuilt) == leaves


def _templates(which):
    if which == "quickstart":
        return 4, [np.zeros(3, np.float32)] * 3
    n = 6 if which == "white_wine" else 4
    task = jax_hpo.make_robust_hpo_problem(which, n_workers=n, seed=0)
    p = task.problem
    return n, [jax.tree.map(np.asarray, t)
               for t in (p.x1_init, p.x2_init, p.x3_init)]


@pytest.mark.parametrize("which", ["quickstart", "diabetes", "white_wine"])
def test_flat_spec_layout_matches_reference(which):
    n, tpls = _templates(which)
    want = jax_cuts.spec_from_templates(n, *tpls)
    got = cuts.spec_from_templates(
        n, *(convert.to_torch(t, "cpu") for t in tpls))
    assert got.offsets == want.offsets
    assert got.sizes == want.sizes
    assert got.shapes == want.shapes
    assert got.nleaves == want.nleaves
    assert got.d_total == want.d_total
    if which == "white_wine":
        assert got.d_total == 242_628


def test_cut_row_maintenance_is_bitwise_equal():
    """add_cut (including eviction of the oldest row) and drop_inactive
    leave a/c/active/age bitwise equal to the reference's."""
    rng = np.random.default_rng(11)
    n, dim, p_max = 4, 3, 3
    tpl = np.zeros(dim, np.float32)
    fj = jax_cuts.empty_cuts(p_max, n, tpl, tpl, tpl)
    ft = cuts.empty_cuts(p_max, n, *(torch.zeros(dim),) * 3)
    for t in range(9):
        coeffs = {"a1": rng.normal(size=dim), "a3": rng.normal(size=dim),
                  "b3": rng.normal(size=(n, dim))}
        if t % 2:
            coeffs["b2"] = rng.normal(size=(n, dim))
        coeffs = {k: v.astype(np.float32) for k, v in coeffs.items()}
        c = np.float32(rng.normal())
        fj = jax_cuts.add_cut(fj, jax.tree.map(jnp.asarray, coeffs),
                              jnp.float32(c), jnp.int32(t))
        ft = cuts.add_cut(ft, convert.to_torch(coeffs, "cpu"),
                          torch.tensor(c), torch.tensor(t, dtype=torch.int32))
        if t % 3 == 2:
            mult = np.array([0.0, 5e-9, 1.0], np.float32)[rng.permutation(3)]
            fj = jax_cuts.drop_inactive(fj, jnp.asarray(mult))
            ft = cuts.drop_inactive(ft, torch.tensor(mult))
        for k in ("a", "c", "active", "age"):
            np.testing.assert_array_equal(getattr(ft, k).numpy(),
                                          _np(getattr(fj, k)), err_msg=k)
    assert float(cuts.n_active(ft)) == float(jax_cuts.n_active(fj))


def test_flatten_and_contractions_match_reference():
    jp, tp, jh, th, js, ts = stepped_states()
    spec_j, spec_t = js.cuts_ii.spec, ts.cuts_ii.spec
    vj = jax_cuts.flatten_point(spec_j, js.z1, js.z2, js.z3, js.X2, js.X3)
    vt = cuts.flatten_point(spec_t, ts.z1, ts.z2, ts.z3, ts.X2, ts.X3)
    np.testing.assert_array_equal(vt.numpy(), _np(vj))
    np.testing.assert_allclose(
        cuts.eval_cuts(ts.cuts_ii, ts.z1, ts.z2, ts.z3, ts.X2, ts.X3)
        .numpy(),
        _np(jax_cuts.eval_cuts(js.cuts_ii, js.z1, js.z2, js.z3, js.X2,
                               js.X3)), **F32)
    w = np.random.default_rng(3).normal(size=(6,)).astype(np.float32)
    assert_trees_close(
        cuts.cut_weighted_coeff_flat(spec_t, ts.cuts_ii.a, torch.tensor(w)),
        jax_cuts.cut_weighted_coeff_flat(spec_j, js.cuts_ii.a,
                                         jnp.asarray(w)), **F32)
    wn = np.random.default_rng(4).normal(size=(4, 6)).astype(np.float32)
    for block in ("b2", "b3"):
        assert_trees_close(
            cuts.cut_coeff_per_worker(ts.cuts_ii, torch.tensor(wn), block),
            jax_cuts.cut_coeff_per_worker(js.cuts_ii, jnp.asarray(wn),
                                          block), **F32)
    assert_trees_close(cuts.unflatten_coeff(spec_t, vt),
                       jax_cuts.unflatten_coeff(spec_j, vj), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# scheduler, data, hyper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n_workers=4, s_active=3, tau=5, n_stragglers=1, seed=0),
    dict(n_workers=6, s_active=4, tau=10, n_stragglers=1, seed=0),
    dict(n_workers=5, s_active=2, tau=4, n_stragglers=2,
         straggler_slowdown=20.0, seed=3),
])
def test_schedule_equals_reference_exactly(kw):
    want = jax_sched.StragglerScheduler(
        jax_sched.StragglerConfig(**kw)).precompute(60)
    got = scheduler.StragglerScheduler(
        scheduler.StragglerConfig(**kw)).precompute(60)
    for k in ("active", "sim_time", "max_staleness"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    sub = got.slice(10, 20)
    np.testing.assert_array_equal(sub.active, want.active[10:20])


def test_hyper_validates_arrival_params_like_reference():
    for kw in (dict(n_workers=3, s_active=4), dict(tau=0)):
        with pytest.raises(ValueError):
            jax_types.Hyper(**kw)
        with pytest.raises(ValueError):
            types.Hyper(**kw)


@pytest.mark.parametrize("name", ["diabetes", "white_wine"])
def test_regression_data_identical(name):
    n = 6 if name == "white_wine" else 4
    want = jax_synth.make_regression(name, n, seed=0)
    got = synthetic.make_regression(name, n, seed=0)
    for f in ("x_train", "y_train", "x_val", "y_val", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


# ---------------------------------------------------------------------------
# rollouts and the h functions
# ---------------------------------------------------------------------------

def _toy(seed=0, n=3, p=5, d2=7, d1=4):
    """The tests/test_inner_fused.py toy problem, from numpy, in both
    packages: a small trilevel problem and a partly active polytope."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    data = r(n, d2)
    z1, z2, z3 = r(d1), r(d2), r(d1)
    X3, X2 = r(n, d1), r(n, d2)
    phi = r(n, d2, scale=0.1)
    s, gamma = np.abs(r(p)), np.abs(r(p))
    spec_j = jax_cuts.spec_from_templates(n, z1, z2, z3)
    a = np.zeros((p, spec_j.d_total), np.float32)
    a[:, :d1 + d2 + d1] = r(p, d1 + d2 + d1, scale=0.1)   # a1, a2, a3
    a[:, -n * d1:] = r(p, n * d1, scale=0.1)              # b3
    c = np.linspace(-1.0, 1.0, p).astype(np.float32)
    active = np.array([1.0, 1.0, 0.0, 1.0, 1.0], np.float32)
    age = np.zeros(p, np.int32)

    def jf2(dj, z1, x2, x3):
        return jnp.sum((x2 - dj) ** 2) \
            + jnp.sum(z1) * jnp.sum(x2) + 0.1 * jnp.sum(x3) * jnp.sum(x2)

    def jf3(dj, z1, z2, x3):
        return jnp.sum((x3 - z2[:d1]) ** 2)

    def tf2(dj, z1, x2, x3):
        return torch.sum((x2 - dj) ** 2) \
            + torch.sum(z1) * torch.sum(x2) + 0.1 * torch.sum(x3) \
            * torch.sum(x2)

    def tf3(dj, z1, z2, x3):
        return torch.sum((x3 - z2[:d1]) ** 2)

    jp = jax_types.TrilevelProblem(f1=None, f2=jf2, f3=jf3,
                                   data=jnp.asarray(data), n_workers=n,
                                   x1_init=None, x2_init=None, x3_init=None)
    tp = types.TrilevelProblem(f1=None, f2=tf2, f3=tf3,
                               data=torch.tensor(data), n_workers=n,
                               x1_init=None, x2_init=None, x3_init=None)
    fj = jax_types.FlatCuts(a=jnp.asarray(a), c=jnp.asarray(c),
                            active=jnp.asarray(active), age=jnp.asarray(age),
                            spec=spec_j)
    ft = types.FlatCuts(
        a=torch.tensor(a), c=torch.tensor(c), active=torch.tensor(active),
        age=torch.tensor(age),
        spec=cuts.spec_from_templates(n, *map(torch.tensor, (z1, z2, z3))))
    arrays = dict(z1=z1, z2=z2, z3=z3, X2=X2, X3=X3, phi=phi, s=s,
                  gamma=gamma)
    return jp, tp, fj, ft, arrays


HYP = dict(n_workers=3, k_inner=4)


def test_rollout2_final_state_matches_reference():
    jp, tp, fj, ft, a = _toy()
    J = {k: jnp.asarray(v) for k, v in a.items()}
    T = {k: torch.tensor(v) for k, v in a.items()}
    want = jax_inner.rollout2(
        jp, jax_types.Hyper(**HYP), J["z1"], J["z3"], J["X3"], fj,
        jax_types.InnerState2(x2=J["X2"], z2=J["z2"], phi=J["phi"],
                              s=J["s"], gamma=J["gamma"]))
    got = inner.rollout2(
        tp, types.Hyper(**HYP), T["z1"], T["z3"], T["X3"], ft,
        types.InnerState2(x2=T["X2"], z2=T["z2"], phi=T["phi"], s=T["s"],
                          gamma=T["gamma"]))
    for name in ("x2", "z2", "phi", "s", "gamma"):
        assert_trees_close(getattr(got, name), getattr(want, name), **STATE)


def test_rollout3_final_state_matches_reference():
    jp, tp, _, _, a = _toy(seed=1)
    J = {k: jnp.asarray(v) for k, v in a.items()}
    T = {k: torch.tensor(v) for k, v in a.items()}
    phi = np.random.default_rng(2).normal(size=a["X3"].shape) \
        .astype(np.float32)
    want = jax_inner.rollout3(
        jp, jax_types.Hyper(**HYP), J["z1"], J["z2"],
        jax_types.InnerState3(x3=J["X3"], z3=J["z3"], phi=jnp.asarray(phi)))
    got = inner.rollout3(
        tp, types.Hyper(**HYP), T["z1"], T["z2"],
        types.InnerState3(x3=T["X3"], z3=T["z3"], phi=torch.tensor(phi)))
    for name in ("x3", "z3", "phi"):
        assert_trees_close(getattr(got, name), getattr(want, name), **STATE)


def test_h_i_and_h_ii_values_and_gradients_match_reference():
    jp, tp, fj, ft, a = _toy(seed=2)
    J = {k: jnp.asarray(v) for k, v in a.items()}
    jh, th = jax_types.Hyper(**HYP), types.Hyper(**HYP)
    init3_j = jax_types.InnerState3(x3=J["X3"], z3=J["z3"],
                                    phi=jnp.zeros_like(J["X3"]))
    init2_j = jax_types.InnerState2(x2=J["X2"], z2=J["z2"], phi=J["phi"],
                                    s=J["s"], gamma=J["gamma"])

    def hi_j(X3, z3, z1, z2):
        return jax_inner.h_i(jp, jh, X3, z3, z1, z2, init3_j)

    def hii_j(X2, z2, z1, z3, X3):
        return jax_inner.h_ii(jp, jh, X2, z2, z1, z3, X3, fj, init2_j)

    for fn_j, names in ((hi_j, ("X3", "z3", "z1", "z2")),
                        (hii_j, ("X2", "z2", "z1", "z3", "X3"))):
        val_j, grads_j = jax.value_and_grad(
            fn_j, argnums=tuple(range(len(names))))(*(J[k] for k in names))
        T = {k: torch.tensor(a[k]).requires_grad_() for k in names}
        T0 = {k: torch.tensor(v) for k, v in a.items()}
        if fn_j is hi_j:
            val = inner.h_i(tp, th, *(T[k] for k in names),
                            types.InnerState3(x3=T0["X3"], z3=T0["z3"],
                                              phi=torch.zeros_like(T0["X3"])))
        else:
            val = inner.h_ii(tp, th, *(T[k] for k in names), ft,
                             types.InnerState2(x2=T0["X2"], z2=T0["z2"],
                                               phi=T0["phi"], s=T0["s"],
                                               gamma=T0["gamma"]))
        grads = torch.autograd.grad(val, [T[k] for k in names],
                                    allow_unused=True, materialize_grads=True)
        np.testing.assert_allclose(float(val.detach()), float(val_j), **F32)
        for g, w, k in zip(grads, grads_j, names):
            np.testing.assert_allclose(g.numpy(), _np(w), **F32, err_msg=k)


# ---------------------------------------------------------------------------
# one step, one refresh, the gap and the Lagrangians from one state
# ---------------------------------------------------------------------------

def test_afto_step_aux_from_identical_state():
    jp, tp, jh, th, js, ts = stepped_states()
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    want, aux_j = jax_afto.afto_step_aux(jp, jh, js, jnp.asarray(mask))
    got, aux_t = afto.afto_step_aux(tp, th, ts, torch.tensor(mask))
    assert_states_close(got, want, **STATE)
    np.testing.assert_allclose(aux_t["cutval"].numpy(),
                               _np(aux_j["cutval"]), **F32)


def test_cut_refresh_from_identical_state():
    jp, tp, jh, th, js, ts = stepped_states(n_steps=9)
    want = jax_afto.cut_refresh(jp, jh, js)
    got = afto.cut_refresh(tp, th, ts)
    assert_states_close(got, want, **STATE)


def test_stationarity_gap_and_lagrangians_from_identical_state():
    jp, tp, jh, th, js, ts = stepped_states()
    np.testing.assert_allclose(
        float(stationarity.stationarity_gap_sq(tp, th, ts)),
        float(jax_stat.stationarity_gap_sq(jp, jh, js)), **F32)
    sv_j = (js.X1, js.X2, js.X3, js.z1, js.z2, js.z3)
    sv_t = (ts.X1, ts.X2, ts.X3, ts.z1, ts.z2, ts.z3)
    np.testing.assert_allclose(
        float(lagrangian.l_p_hat(tp, th, ts.t, sv_t, ts.cuts_ii, ts.lam,
                                 ts.theta)),
        float(jax_lag.l_p_hat(jp, jh, js.t, sv_j, js.cuts_ii, js.lam,
                              js.theta)), **F32)


def test_convert_round_trips_a_reference_state():
    _, _, _, _, js, ts = stepped_states(n_steps=6)
    assert_states_close(ts, js, rtol=0, atol=0)
    assert ts.t.dtype == torch.int32 and ts.cuts_i.age.dtype == torch.int32


# ---------------------------------------------------------------------------
# robust HPO pieces
# ---------------------------------------------------------------------------

def test_robust_hpo_objectives_and_test_mse_match_reference():
    jt = jax_hpo.make_robust_hpo_problem("diabetes", n_workers=4, seed=0)
    w0 = convert.to_torch(jax.tree.map(np.asarray, jt.problem.x3_init),
                          "cpu")
    tt = robust_hpo.make_robust_hpo_problem("diabetes", n_workers=4, seed=0,
                                            device="cpu", w0=w0)
    rng = np.random.default_rng(0)
    x1 = {"phi": np.float32([-2.5])}
    x2 = rng.normal(size=tt.problem.x2_init.shape).astype(np.float32) * 0.1
    for name in ("f1", "f2", "f3"):
        fj, ft = getattr(jt.problem, name), getattr(tt.problem, name)
        for j in range(4):
            dj = jax.tree.map(lambda x: x[j], jt.problem.data)
            want = fj(dj, jax.tree.map(jnp.asarray, x1), jnp.asarray(x2),
                      jt.problem.x3_init)
            got = ft(tt.problem.worker_data(j), convert.to_torch(x1, "cpu"),
                     torch.tensor(x2), w0)
            np.testing.assert_allclose(float(got), float(want), **F32)
    np.testing.assert_allclose(
        float(tt.test_mse(w0, 0.3, seed=1)),
        float(jt.test_mse(jt.problem.x3_init, 0.3, seed=1)), **F32)
    assert robust_hpo.default_hyper(tt, 4, 3, 10) == types.Hyper(
        **{f.name: getattr(jax_hpo.default_hyper(jt, 4, 3, 10), f.name)
           for f in dataclasses.fields(jax_types.Hyper)})


def test_mlp_init_distribution_and_leaf_order():
    w = mlp_init(torch.Generator().manual_seed(0), (11, 16, 1))
    assert tree.tree_leaves(w)[0] is w["b0"]
    assert w["w0"].shape == (11, 16) and float(w["b0"].abs().sum()) == 0.0
    big = mlp_init(torch.Generator().manual_seed(1), (400, 300))
    np.testing.assert_allclose(float(big["w0"].std()), 400 ** -0.5,
                               rtol=0.02)
