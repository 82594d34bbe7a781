"""The port's fused level-2 round and the domain-adaptation app against
the reference on identical numpy inputs, on the CPU.

Tolerances are the reference's own: f32 values and gradients 1e-4/1e-5
and bf16 inputs 5e-2 (tests/test_kernels.py), rollout states and h_II
gradients 1e-5/1e-6, h_II grad-of-grad 1e-4/1e-5
(tests/test_inner_fused.py), trajectories as in test_torch_engine.py.
On the CPU `ops.fused_cut_round` routes to the plain version; the tests
that name the `FusedRound` route replace the routing point with
`FusedRound.apply`, so the autograd wiring that runs on the card (plain
forward here, derivatives through the `cut_ad` Functions) is exercised.
The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import domain_adaptation as jax_da
from repro.core import RunSpec as JaxRunSpec
from repro.core import StragglerConfig as JaxStragglerConfig
from repro.core import afto as jax_afto
from repro.core import inner as jax_inner
from repro.core import run as jax_run
from repro.core import types as jax_types
from repro.data import synthetic as jax_synth
from repro.kernels import ops as jax_ops
from repro.models import simple as jax_models
from repro_torch import convert
from repro_torch.apps import domain_adaptation as da
from repro_torch.core import (RunSpec, StragglerConfig, afto, inner, run,
                              types)
from repro_torch.data import synthetic
from repro_torch.kernels import inner_round, ops
from repro_torch.models import simple as models
from repro_torch.utils import tree
from test_torch_core import STATE, _toy, assert_states_close, \
    assert_trees_close

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
GOG = dict(rtol=1e-4, atol=1e-5)
STEPS = dict(eta_z=0.05, eta_s=0.05, eta_dual=0.05, rho2=1.0)
OUT_NAMES = ("v_new", "cv1", "s_new", "gamma_new")


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# the fused op
# ---------------------------------------------------------------------------

def _round_operands(p, d, seed):
    """Numpy operands of one round, as tests/test_inner_fused.py:112 draws
    them: some cuts inactive, alternate columns masked."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return dict(
        a=r(p, d, scale=d ** -0.5), v=r(d), g_other=r(d),
        mask=(np.arange(d) % 2).astype(np.float32), c=r(p),
        active=(rng.uniform(size=p) > 0.3).astype(np.float32),
        s=np.abs(r(p)), gamma=np.abs(r(p)))


ARGS = ("a", "v", "g_other", "mask", "c", "active", "s", "gamma")
WRT = ("a", "v", "s", "gamma")


def _jax_round(o, impl, a_dtype=jnp.float32):
    def outs(a, v, s, gam):
        return jax_ops.fused_cut_round(
            a.astype(a_dtype), v, jnp.asarray(o["g_other"]),
            jnp.asarray(o["mask"]), jnp.asarray(o["c"]),
            jnp.asarray(o["active"]), s, gam, impl=impl, **STEPS)
    return outs


def _sq_loss(outs, xp):
    return sum(xp.sum(x ** 2) for x in outs)


def _port_round(route):
    """The port's round by route: "plain" = the routing point on CPU
    tensors (plain version, torch autograd), "function" = FusedRound."""
    if route == "plain":
        return lambda *args: ops.fused_cut_round(*args, **STEPS)
    return lambda *args: ops.FusedRound.apply(
        *args, *(STEPS[k] for k in ("eta_z", "eta_s", "eta_dual", "rho2")))


@pytest.fixture(scope="module")
def jax_rounds():
    """The reference's values and first gradients per (shape, impl),
    computed once."""
    cache = {}

    def get(p, d, impl):
        key = (p, d, impl)
        if key not in cache:
            o = _round_operands(p, d, seed=p + d)
            fn = _jax_round(o, impl)
            x = [jnp.asarray(o[k]) for k in WRT]
            vals = fn(*x)
            grads = jax.grad(lambda *x: _sq_loss(fn(*x), jnp),
                             argnums=(0, 1, 2, 3))(*x)
            cache[key] = (o, [_np(t) for t in vals], [_np(g) for g in grads])
        return cache[key]
    return get


@pytest.mark.parametrize("p,d", [(5, 300), (8, 4096)])
@pytest.mark.parametrize("jax_impl", ["ref", "pallas"])
@pytest.mark.parametrize("route", ["plain", "function"])
def test_fused_round_values_and_gradients_match_reference(
        jax_rounds, p, d, jax_impl, route):
    o, want_vals, want_grads = jax_rounds(p, d, jax_impl)
    T = {k: torch.tensor(o[k]) for k in ARGS}
    for k in WRT:
        T[k].requires_grad_(True)
    outs = _port_round(route)(*(T[k] for k in ARGS))
    for got, want, name in zip(outs, want_vals, OUT_NAMES):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), want, **F32,
                                   err_msg=name)
    grads = torch.autograd.grad(_sq_loss(outs, torch), [T[k] for k in WRT])
    for got, want, name in zip(grads, want_grads, WRT):
        np.testing.assert_allclose(got.numpy(), want, **F32,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("route", ["plain", "function"])
def test_fused_round_grad_of_grad_matches_reference(route):
    """d/d(a, v) of ||d loss / d(a, v, s, gamma)||^2 through the round:
    the second order a cut refresh takes through a fused rollout."""
    o = _round_operands(5, 300, seed=7)
    fn = _jax_round(o, "ref")

    def gsum(*x):
        g = jax.grad(lambda *x: _sq_loss(fn(*x), jnp),
                     argnums=(0, 1, 2, 3))(*x)
        return sum(jnp.sum(t ** 2) for t in g)

    want = jax.grad(gsum, argnums=(0, 1))(*(jnp.asarray(o[k]) for k in WRT))
    T = {k: torch.tensor(o[k]) for k in ARGS}
    for k in WRT:
        T[k].requires_grad_(True)
    outs = _port_round(route)(*(T[k] for k in ARGS))
    g = torch.autograd.grad(_sq_loss(outs, torch), [T[k] for k in WRT],
                            create_graph=True)
    got = torch.autograd.grad(sum(torch.sum(t ** 2) for t in g),
                              [T["a"], T["v"]])
    assert float(np.max(np.abs(_np(want[0])))) > 0.0
    for x, y, name in zip(got, want, ("dda", "ddv")):
        np.testing.assert_allclose(x.numpy(), _np(y), **GOG, err_msg=name)


def test_fused_round_bf16_matrix_matches_reference():
    o = _round_operands(5, 3000, seed=3)
    want = _jax_round(o, "pallas", jnp.bfloat16)(
        *(jnp.asarray(o[k]) for k in WRT))
    T = {k: torch.tensor(o[k]) for k in ARGS}
    T["a"] = T["a"].bfloat16()
    got = inner_round.fused_cut_round(*(T[k] for k in ARGS), **STEPS)
    for x, y, name in zip(got, want, OUT_NAMES):
        np.testing.assert_allclose(x.numpy(), _np(y), **BF16, err_msg=name)


def test_fused_round_wrapper_and_routing_reject_bad_operands():
    o = _round_operands(3, 40, seed=1)
    T = {k: torch.tensor(o[k]) for k in ARGS}

    def call(**change):
        args = dict(T, **change)
        return inner_round.fused_cut_round(*(args[k] for k in ARGS),
                                           **STEPS)

    with pytest.raises(ValueError, match="mask"):
        call(mask=T["mask"][:-1])
    with pytest.raises(ValueError, match="gamma"):
        call(gamma=T["gamma"][:2])
    with pytest.raises(TypeError, match="v dtype"):
        call(v=T["v"].double())
    with pytest.raises(TypeError, match="matrix dtype"):
        call(a=T["a"].half())
    with pytest.raises(ValueError, match="contiguous"):
        call(a=torch.tensor(o["a"].T.copy()).T)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_cut_round(*(T[k] for k in ARGS), impl="kernel", **STEPS)
    with pytest.raises(ValueError, match="impl"):
        ops.fused_cut_round(*(T[k] for k in ARGS), impl="pallas", **STEPS)


# ---------------------------------------------------------------------------
# the fused rollout and h_II
# ---------------------------------------------------------------------------

HYP = dict(n_workers=3, k_inner=4)


def _hypers(fused):
    return (jax_types.Hyper(use_fused_inner=fused, **HYP),
            types.Hyper(use_fused_inner=fused, **HYP))


@pytest.fixture
def function_route(monkeypatch):
    """Route the port's fused rollout through `FusedRound` on the CPU."""
    def through_function(*args, eta_z, eta_s, eta_dual, rho2, impl=None):
        return ops.FusedRound.apply(*args, eta_z, eta_s, eta_dual, rho2)
    monkeypatch.setattr(ops, "fused_cut_round", through_function)


def _init2(mod, X):
    return mod.InnerState2(x2=X["X2"], z2=X["z2"], phi=X["phi"], s=X["s"],
                           gamma=X["gamma"])


@pytest.mark.parametrize("route", ["plain", "function"])
def test_rollout2_fused_matches_reference(request, route):
    if route == "function":
        request.getfixturevalue("function_route")
    jp, tp, fj, ft, a = _toy()
    J = {k: jnp.asarray(v) for k, v in a.items()}
    T = {k: torch.tensor(v) for k, v in a.items()}
    jh_fused, th_fused = _hypers(True)
    got = inner.rollout2(tp, th_fused, T["z1"], T["z3"], T["X3"], ft,
                         _init2(types, T))
    for jh in (jh_fused, _hypers(False)[0]):   # the fused op and the oracle
        want = jax_inner.rollout2(jp, jh, J["z1"], J["z3"], J["X3"], fj,
                                  _init2(jax_types, J))
        for name in ("x2", "z2", "phi", "s", "gamma"):
            assert_trees_close(getattr(got, name), getattr(want, name),
                               **STATE)


def _h_ii(mod, inner_mod, prob, fc, X, hyp):
    def h(z1, z3, X3):
        return inner_mod.h_ii(prob, hyp, X["X2"], X["z2"], z1, z3, X3, fc,
                              _init2(mod, X))
    return h


@pytest.mark.parametrize("route", ["plain", "function"])
def test_h_ii_gradients_through_fused_round_match_reference(request, route):
    if route == "function":
        request.getfixturevalue("function_route")
    jp, tp, fj, ft, a = _toy(seed=1)
    J = {k: jnp.asarray(v) for k, v in a.items()}
    T = {k: torch.tensor(v) for k, v in a.items()}
    jh, th = _hypers(True)
    want = jax.grad(_h_ii(jax_types, jax_inner, jp, fj, J, jh),
                    argnums=(0, 1, 2))(J["z1"], J["z3"], J["X3"])
    x = [T[k].clone().requires_grad_(True) for k in ("z1", "z3", "X3")]
    got = torch.autograd.grad(_h_ii(types, inner, tp, ft, T, th)(*x), x)
    for g, w, name in zip(got, want, ("z1", "z3", "X3")):
        np.testing.assert_allclose(g.numpy(), _np(w), **STATE, err_msg=name)


@pytest.mark.parametrize("route", ["plain", "function"])
def test_h_ii_grad_of_grad_through_fused_round_matches_reference(request,
                                                                 route):
    if route == "function":
        request.getfixturevalue("function_route")
    jp, tp, fj, ft, a = _toy(seed=2)
    J = {k: jnp.asarray(v) for k, v in a.items()}
    T = {k: torch.tensor(v) for k, v in a.items()}
    jh, th = _hypers(True)
    hj = _h_ii(jax_types, jax_inner, jp, fj, J, jh)

    def gsum_j(z1):
        return jnp.sum(jax.grad(hj)(z1, J["z3"], J["X3"]) ** 2)

    want = jax.grad(gsum_j)(J["z1"])
    z1 = T["z1"].clone().requires_grad_(True)
    g = torch.autograd.grad(_h_ii(types, inner, tp, ft, T, th)(
        z1, T["z3"], T["X3"]), z1, create_graph=True)[0]
    got = torch.autograd.grad(torch.sum(g ** 2), z1)[0]
    assert float(jnp.max(jnp.abs(want))) > 0.0
    np.testing.assert_allclose(got.numpy(), _np(want), **GOG)


# ---------------------------------------------------------------------------
# domain adaptation: data, LeNet, the problem
# ---------------------------------------------------------------------------

def test_digits_data_identical():
    want = jax_synth.make_digits(3, n_pretrain_per=5, n_finetune_per=4,
                                 n_test=7, pretrain_domain="mnist", seed=2)
    got = synthetic.make_digits(3, n_pretrain_per=5, n_finetune_per=4,
                                n_test=7, pretrain_domain="mnist", seed=2)
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg=f.name)


def _lenet_params(seed):
    return jax.tree.map(np.asarray,
                        jax_models.lenet_init(jax.random.PRNGKey(seed)))


def test_lenet_pieces_match_reference():
    """Values and gradients (w.r.t. every weight and the input) of
    LeNet-5, its convolution and pooling, in the reference's layouts."""
    params = _lenet_params(0)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 32, 32, 1)).astype(np.float32)
    y = np.array([1, 7, 3], np.int32)

    def loss_j(w, x):
        return jax_models.cross_entropy(jax_models.lenet_apply(w, x),
                                        jnp.asarray(y))

    want_l, (want_gw, want_gx) = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1)))(jax.tree.map(jnp.asarray, params),
                                 jnp.asarray(x))
    w = {k: torch.tensor(v).requires_grad_(True) for k, v in params.items()}
    xt = torch.tensor(x).requires_grad_(True)
    logits = models.lenet_apply(w, xt)
    np.testing.assert_allclose(
        logits.detach().numpy(),
        _np(jax_models.lenet_apply(params, jnp.asarray(x))), **F32)
    loss = models.cross_entropy(logits, torch.tensor(y))
    np.testing.assert_allclose(float(loss), float(want_l), **F32)
    gw = torch.autograd.grad(loss, [w[k] for k in sorted(w)] + [xt])
    for g, k in zip(gw, sorted(w)):
        np.testing.assert_allclose(g.numpy(), _np(want_gw[k]), **F32,
                                   err_msg=k)
    np.testing.assert_allclose(gw[-1].numpy(), _np(want_gx), **F32)
    np.testing.assert_allclose(
        float(models.accuracy(logits, torch.tensor(y))),
        float(jax_models.accuracy(jnp.asarray(logits.detach().numpy()),
                                  jnp.asarray(y))))
    h = rng.normal(size=(2, 14, 14, 6)).astype(np.float32)
    np.testing.assert_allclose(
        models._conv2d(torch.tensor(h), torch.tensor(params["c2"])).numpy(),
        _np(jax_models._conv2d(jnp.asarray(h), jnp.asarray(params["c2"]))),
        **F32)
    np.testing.assert_allclose(
        models._avgpool2(torch.tensor(h)).numpy(),
        _np(jax_models._avgpool2(jnp.asarray(h))), **F32)


def test_lenet_init_distribution_and_leaf_layout():
    w = models.lenet_init(torch.Generator().manual_seed(0))
    ref = _lenet_params(0)
    assert list(w) and sorted(w) == sorted(ref)
    for k in ref:
        assert tuple(w[k].shape) == ref[k].shape, k
    assert tree.tree_leaves(w)[0] is w["c1"]
    assert sum(v.numel() for v in w.values()) == 61_706
    np.testing.assert_allclose(float(w["f1"].std()), 400 ** -0.5, rtol=0.02)
    assert float(w["f1b"].abs().sum()) == 0.0


DA_SIZE = dict(n_pretrain_per=8, n_finetune_per=8, seed=0)


@pytest.fixture(scope="module")
def da_tasks():
    """The reference's DA task (N=2, tests/test_apps.py:48-57's size) and
    the port's with the reference's three LeNets carried over."""
    jt = jax_da.make_domain_adaptation_problem(2, **DA_SIZE)
    p = jt.problem
    x_init = [jax.tree.map(np.asarray, x)
              for x in (p.x1_init, p.x2_init, p.x3_init)]
    tt = da.make_domain_adaptation_problem(2, **DA_SIZE, device="cpu",
                                           x_init=x_init)
    return jt, tt


def test_domain_adaptation_objectives_match_reference(da_tasks):
    jt, tt = da_tasks
    jp, tp = jt.problem, tt.problem
    for k, v in tp.data.items():
        np.testing.assert_array_equal(v.numpy(), _np(jp.data[k]))
    xs_j = (jp.x1_init, jp.x2_init, jp.x3_init)
    for name in ("f1", "f2", "f3"):
        fj, ft = getattr(jp, name), getattr(tp, name)
        vg = jax.jit(jax.value_and_grad(fj, argnums=(1, 2, 3)))
        for j in range(2):
            dj = jax.tree.map(lambda x: x[j], jp.data)
            want, want_g = vg(dj, *xs_j)
            xs_t = [tree.tree_map(lambda v: v.clone().requires_grad_(True),
                                  x)
                    for x in (tp.x1_init, tp.x2_init, tp.x3_init)]
            got = ft(tp.worker_data(j), *xs_t)
            np.testing.assert_allclose(float(got), float(want), **F32,
                                       err_msg=name)
            leaves = tree.tree_leaves(xs_t)
            grads = torch.autograd.grad(got, leaves, allow_unused=True,
                                        materialize_grads=True)
            for g, w in zip(grads, jax.tree.leaves(want_g)):
                np.testing.assert_allclose(g.numpy(), _np(w), **F32,
                                           err_msg=name)
    v = tp.x2_init
    for k, val in tt.test_metrics(v).items():
        np.testing.assert_allclose(float(val),
                                   float(jt.test_metrics(jp.x2_init)[k]),
                                   **F32, err_msg=k)
    assert da.default_hyper(2, 2, 5, k_inner=1) == types.Hyper(
        **{f.name: getattr(jax_da.default_hyper(2, 2, 5, k_inner=1), f.name)
           for f in dataclasses.fields(jax_types.Hyper)})


def _da_hypers(**kw):
    base = dict(t_pre=4, k_inner=1, p_max=2, use_fused_inner=True)
    base.update(kw)
    return jax_da.default_hyper(2, 2, 5, **base), \
        da.default_hyper(2, 2, 5, **base)


@pytest.fixture(scope="module")
def jax_refresh(da_tasks):
    """The reference's `cut_refresh` of the DA problem, compiled once per
    `use_fused_inner` (op-by-op it takes half a minute)."""
    jt, _ = da_tasks
    return {fused: jax.jit(lambda st, jh=_da_hypers(use_fused_inner=fused)[0]:
                           jax_afto.cut_refresh(jt.problem, jh, st))
            for fused in (True, False)}


@pytest.fixture(scope="module")
def da_states(da_tasks, jax_refresh):
    """A reference DA state after four steps and one refresh (live cuts,
    nonzero inner slacks), and the same state carried into the port."""
    jt, _ = da_tasks
    jh, _ = _da_hypers()
    step = jax.jit(lambda st, m: jax_afto.afto_step(jt.problem, jh, st, m))
    st = jax_afto.init_state(jt.problem, jh)
    for m in np.array([[1, 1], [1, 0], [0, 1], [1, 1]], np.float32):
        st = step(st, jnp.asarray(m))
    st = jax_refresh[True](st)
    return st, convert.state_from_reference(jax.tree.map(np.asarray, st),
                                            "cpu")


def test_domain_adaptation_step_from_identical_state(da_tasks, da_states):
    (jt, tt), (js, ts) = da_tasks, da_states
    jh, th = _da_hypers()
    mask = np.array([1.0, 0.0], np.float32)
    want, aux_j = jax.jit(lambda st, m: jax_afto.afto_step_aux(
        jt.problem, jh, st, m))(js, jnp.asarray(mask))
    got, aux_t = afto.afto_step_aux(tt.problem, th, ts, torch.tensor(mask))
    assert_states_close(got, want, **STATE)
    np.testing.assert_allclose(aux_t["cutval"].numpy(),
                               _np(aux_j["cutval"]), **F32)


@pytest.mark.parametrize("fused", [True, False])
def test_domain_adaptation_cut_refresh_from_identical_state(
        da_tasks, da_states, jax_refresh, fused):
    (_, tt), (js, ts) = da_tasks, da_states
    _, th = _da_hypers(use_fused_inner=fused)
    assert ts.cuts_ii.a.shape == (2, 7 * 61_706)
    assert float(ts.inner2.s.max()) > 0.0
    want = jax_refresh[fused](js)
    got = afto.cut_refresh(tt.problem, th, ts)
    assert_states_close(got, want, **STATE)


def test_domain_adaptation_trajectory_matches_reference(da_tasks):
    """8 iterations with a refresh every 4 through the fused round; the
    gap and test histories within 1e-4, cut counts exact."""
    jt, tt = da_tasks
    jh, th = _da_hypers()
    cfg = dict(n_workers=2, s_active=2, tau=5, seed=0)

    def metrics(task, mean):
        return lambda s: task.test_metrics(mean(s.X2))

    want = jax_run(JaxRunSpec(
        problem=jt.problem, hyper=jh, scheduler=JaxStragglerConfig(**cfg),
        n_iterations=8, metrics_every=4,
        metrics_fn=metrics(jt, lambda X: jax.tree.map(
            lambda x: jnp.mean(x, 0), X))))
    got = run(RunSpec(
        problem=tt.problem, hyper=th, scheduler=StragglerConfig(**cfg),
        n_iterations=8, metrics_every=4, device="cpu",
        metrics_fn=metrics(tt, lambda X: {k: v.mean(0)
                                          for k, v in X.items()})))
    h, hw = got.history, want.history
    for k in ("gap_sq", "test_loss", "test_acc"):
        assert np.all(np.isfinite(h[k]))
        np.testing.assert_allclose(h[k], _np(hw[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for k in ("n_cuts_i", "n_cuts_ii"):
        assert list(h[k]) == list(_np(hw[k]))
    assert list(h["n_cuts_i"]) != [0.0, 0.0]
