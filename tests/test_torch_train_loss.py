"""The port's training loss (`repro_torch.models.transformer.train_loss`)
against the reference's, on the CPU: reduced llama3-8b, xlstm-125m,
jamba-v0.1-52b and mixtral-8x22b (f32) with the reference's weights
through `convert`. The loss with and without an embedding perturbation
within rtol 1e-5, for Jamba and Mixtral with the MoE aux loss (its
router_aux_coef share included, the aux itself held to the
reference's); its gradients w.r.t. the parameters and the perturbation
within rtol 1e-4 / atol 1e-5 for llama3-8b, Jamba and Mixtral.  Reduced
xLSTM's f32 gradients carry about 1e-4 of each leaf's largest magnitude
of rounding in either package (an
f64 run of the port reads the reference's f32 gradients up to 1.3e-4
from it, the port's up to 2.0e-4), so they miss 1e-4 / 1e-5
elementwise (ROADMAP.md Queue 3 item 17); each of their leaves, the
perturbation's among them, is held to the reference as max|diff| /
max|reference| within XLSTM_LEAF_TOL with no absolute floor, and the
f64 run witnesses that the port is no farther from exact than the
reference is.  `remat` (each block under `torch.utils.checkpoint`)
equals no remat in value, gradient and grad-of-grad."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import init_params as jax_init_params
from repro.models import transformer as jax_tfm
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.data.synthetic import make_token_stream
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.utils.tree import tree_flatten, tree_unflatten

ARCHS = ("llama3-8b", "xlstm-125m", "jamba-v0.1-52b", "mixtral-8x22b")
# the archs whose gradients are held elementwise at GRAD_TOL
ELEMENTWISE = ("llama3-8b", "jamba-v0.1-52b", "mixtral-8x22b")
B, S = 2, 33
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# reduced xLSTM, per leaf: max|port - reference| / max|reference| (read
# at most 2.0e-4 on the CPU), and the port's worst distance from the f64
# run within F64_FACTOR x the reference's worst (read 2.0e-4 / 1.3e-4)
XLSTM_LEAF_TOL, F64_FACTOR = 5e-4, 2.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run torch's CPU ops on one thread: the suite runs
    files in parallel processes, and torch's default of a thread per
    core oversubscribes the machine (one test ran 7x slower for it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch):
    jcfg, cfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    params = convert.params_from_reference(jax.tree.map(np.asarray, jparams),
                                           "cpu")
    toks = make_token_stream(cfg.vocab_size, B, S, seed=3)
    pert = (np.random.default_rng(2).standard_normal(
        (B, S - 1, cfg.d_model)) * 0.1).astype(np.float32)
    return jcfg, cfg, jparams, params, toks, pert


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return _setup(request.param)


def test_loss_with_and_without_perturbation(setup):
    jcfg, cfg, jparams, params, toks, pert = setup
    for p in (None, pert):
        want = jax_tfm.train_loss(jcfg, jparams, jnp.asarray(toks),
                                  embed_perturbation=None if p is None
                                  else jnp.asarray(p))
        got = tfm.train_loss(cfg, params, torch.from_numpy(toks),
                             embed_perturbation=None if p is None
                             else torch.from_numpy(p))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    if cfg.n_experts:
        _, jaux, _ = jax_tfm.forward(jcfg, jparams, jnp.asarray(toks[:, :-1]))
        _, aux, _ = tfm.forward(cfg, params, torch.from_numpy(toks[:, :-1]),
                                impl="ref")
        assert float(aux) > 0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def _grads(cfg, params, toks, pert):
    """[d loss / d leaf for each parameter leaf] + [d loss / d pert]."""
    g = torch.func.grad(lambda w, p: tfm.train_loss(
        cfg, w, torch.from_numpy(toks), embed_perturbation=p),
        argnums=(0, 1))(params, pert)
    return [np.asarray(x, np.float64) for x in
            jax.tree.leaves(convert.to_numpy(g[0]))] + \
        [g[1].double().numpy()]


def _f64_grads(monkeypatch, cfg, params, toks, pert):
    """The port's gradients with every weight, the perturbation and the
    recurrent states in f64, and its f32 casts (`.float()`) leaving f64
    alone: the witness the f32 runs are measured from."""
    from repro_torch.models import xlstm

    keep = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda x, *a, **k: x
                        if x.dtype == torch.float64 else keep(x, *a, **k))
    for name in ("init_mlstm_state", "init_slstm_state"):
        init = getattr(xlstm, name)
        monkeypatch.setattr(xlstm, name, lambda *a, _i=init, **k: {
            key: v.double() for key, v in _i(*a, **k).items()})
    wide = [x.double() for x in tree_flatten(params)[0]]
    out = _grads(cfg, tree_unflatten(tree_flatten(params)[1], wide), toks,
                 torch.from_numpy(pert).double())
    monkeypatch.undo()
    return out


def _rel(a, b, scale):
    return float(np.max(np.abs(a - b))) / scale if scale else 0.0


def test_gradients_wrt_params_and_perturbation(setup, monkeypatch):
    jcfg, cfg, jparams, params, toks, pert = setup
    jg = jax.grad(lambda w, p: jax_tfm.train_loss(
        jcfg, w, jnp.asarray(toks), embed_perturbation=p),
        argnums=(0, 1))(jparams, jnp.asarray(pert))
    want = [np.asarray(x, np.float64) for x in jax.tree.leaves(jg[0])] + \
        [np.asarray(jg[1], np.float64)]
    got = _grads(cfg, params, toks, torch.from_numpy(pert))
    assert len(got) == len(want)
    if cfg.name.startswith(ELEMENTWISE):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, **GRAD_TOL)
        return
    exact = _f64_grads(monkeypatch, cfg, params, toks, pert)
    worst_port = worst_ref = 0.0
    for i, (a, b, e) in enumerate(zip(got, want, exact)):
        scale = float(np.max(np.abs(b))) if b.size else 0.0
        assert _rel(a, b, scale) <= XLSTM_LEAF_TOL, (i, _rel(a, b, scale))
        scale = float(np.max(np.abs(e))) if e.size else 0.0
        worst_port = max(worst_port, _rel(a, e, scale))
        worst_ref = max(worst_ref, _rel(b, e, scale))
    assert worst_port <= F64_FACTOR * worst_ref, (worst_port, worst_ref)
    # the witness itself is exact to f32's rounding of these gradients
    assert 0.0 < worst_ref <= XLSTM_LEAF_TOL


def test_remat_equals_no_remat_to_second_order(setup):
    """Loss, gradient and grad-of-grad (autograd, create_graph) with
    each block checkpointed equal those without."""
    _, cfg, _, params, toks, pert = setup
    leaves, tdef = tree_flatten(params)

    def run(remat):
        live = [x.detach().clone().requires_grad_(True) for x in leaves]
        p = torch.from_numpy(pert).requires_grad_(True)
        loss = tfm.train_loss(cfg, tree_unflatten(tdef, live),
                              torch.from_numpy(toks), remat=remat,
                              embed_perturbation=p)
        grads = [g for g in torch.autograd.grad(
            loss, live + [p], create_graph=True, allow_unused=True)
            if g is not None]
        gog = torch.autograd.grad(sum(torch.sum(g * g) for g in grads),
                                  [p])[0]
        return [loss] + grads + [gog]

    for a, b in zip(run(True), run(False)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_softmax_cross_entropy_mask():
    from repro.models import layers as jax_layers
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.4).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jax_layers.softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = layers.softmax_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_normaliser_overflow_gives_the_references_nan_gradients():
    """Where the gates push an mLSTM position's stabiliser m_t below
    -88.7, the normaliser max(|den|, exp(-m_t)) overflows and its
    gradient is NaN (inf x 0 in exp's backward) in both packages, at the
    same entries: the NaN of the driver's lr 3e-3 at xLSTM-125M's full
    width (ROADMAP.md Queue 3 item 17) is the reference's math."""
    from repro.models import xlstm as jax_xlstm
    from repro_torch.models import xlstm

    rng = np.random.default_rng(5)
    b, l, h, hd = 1, 8, 2, 4
    q, k, v = (rng.standard_normal((b, l, h, hd)).astype(np.float32)
               for _ in range(3))
    li = rng.standard_normal((b, l, h)).astype(np.float32)
    lf = np.full((b, l, h), -1.0, np.float32)
    li[0, 0, 1], lf[0, 0, 1] = -95.0, -100.0   # m_0 = -95 in head 1
    st = {"c": np.zeros((b, h, hd, hd), np.float32),
          "n": np.zeros((b, h, hd), np.float32),
          "m": np.zeros((b, h), np.float32)}

    def jloss(li):
        y, _ = jax_xlstm.mlstm_chunk_body(
            *map(jnp.asarray, (q, k, v)), li, jnp.asarray(lf),
            {key: jnp.asarray(x) for key, x in st.items()})
        return jnp.sum(y)

    def loss(li):
        y, _ = xlstm.mlstm_chunk_body(
            *map(torch.from_numpy, (q, k, v)), li, torch.from_numpy(lf),
            {key: torch.from_numpy(x) for key, x in st.items()})
        return torch.sum(y)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(li)))
    got = torch.func.grad(loss)(torch.from_numpy(li)).numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=1e-5)
