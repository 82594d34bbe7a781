"""The port's MoE channel mixer (`repro_torch.models.moe`) against the
reference's (`repro/models/moe.py`), on the CPU.

Weights come from the reference's `moe_init(PRNGKey(0))` through
`convert`, tokens from numpy with a seed.  At each (T, E, K, capacity
factor) setting, drops included and Kimi K2's E 384 / K 8 at d 32: the
routing indices are equal first (a near-tie flipped would move a token's
output by O(1)), then outputs, aux loss and the gradients with respect to
x and every parameter are held at rtol 1e-4 / atol 1e-5.  Under
`torch.func.vmap` over a worker axis (the LLM step's) the result is a
loop over workers, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jax_moe
from repro_torch import convert
from repro_torch.models import moe

TOL = dict(rtol=1e-4, atol=1e-5)

# (batch, seq, d, d_ff, experts, top_k, capacity factor)
CASES = {
    "fits": (2, 8, 16, 24, 4, 2, 1.25),
    "drops": (2, 8, 16, 24, 4, 2, 0.5),
    "top1": (3, 4, 16, 24, 8, 1, 1.0),
    "decode": (4, 1, 16, 24, 16, 2, 1.25),     # capacity 1, as at decode
    "kimi": (2, 16, 32, 16, 384, 8, 1.25),      # E 384, K 8: capacity 1
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs files in parallel
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(name, seed=0):
    b, s, d, d_ff, e, k, cf = CASES[name]
    jparams = jax_moe.moe_init(jax.random.PRNGKey(0), d, d_ff, e,
                               jnp.float32)
    params = convert.params_from_reference(
        jax.tree.map(np.asarray, jparams), "cpu")
    x = np.random.default_rng(seed).standard_normal((b, s, d)) \
        .astype(np.float32)
    return jparams, params, x, k, cf


@pytest.mark.parametrize("name", sorted(CASES))
def test_routing_then_values_and_aux(name):
    jparams, params, x, k, cf = _setup(name)
    b, s, d = x.shape
    jidx, jw, jaux = jax.jit(jax_moe._route, static_argnums=2)(
        jparams["router"], jnp.asarray(x.reshape(b * s, d)), k)
    idx, w, aux = moe._route(params["router"],
                             torch.from_numpy(x.reshape(b * s, d)), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)

    jout, jaux = jax.jit(jax_moe.moe_apply, static_argnums=(2, 3))(
        jparams, jnp.asarray(x), k, cf)
    out, aux = moe.moe_apply(params, torch.from_numpy(x), k, cf)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_slots_are_the_references_and_drops_occur(name):
    """Each assignment's slot is its stable rank among its expert's
    assignments (the reference's argsort / searchsorted), and the
    capacity drops what the reference drops."""
    jparams, params, x, k, cf = _setup(name)
    b, s, d = x.shape
    t = b * s
    e = CASES[name][4]
    idx = moe._route(params["router"],
                     torch.from_numpy(x.reshape(t, d)), k)[0].reshape(-1)
    flat_e = jnp.asarray(idx.numpy())

    @jax.jit
    def ref_slots(flat_e):      # the reference's moe.py:70-76
        order = jnp.argsort(flat_e, stable=True)
        start = jnp.searchsorted(flat_e[order], jnp.arange(e), side="left")
        return jnp.zeros_like(flat_e).at[order].set(
            jnp.arange(flat_e.shape[0]) - start[flat_e[order]])

    want = ref_slots(flat_e)
    got = moe.slots(idx, e)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cap = moe.capacity_of(t, k, e, cf)
    assert cap == max(1, int(cf * t * k / e))
    n_drop = int((got >= cap).sum())
    if name in ("drops", "decode", "kimi"):
        assert n_drop > 0
    disp = moe.dispatch(params["router"], torch.from_numpy(x.reshape(t, d)),
                        k, cap)
    assert int((~disp.keep).sum()) == n_drop
    # every kept row holds its token; every other row is zero
    rows = disp.buf.reshape(-1, d)
    tok = torch.arange(t).repeat_interleave(k)
    kept = disp.keep.nonzero()[:, 0]
    assert torch.equal(rows[disp.dest[kept]],
                       torch.from_numpy(x.reshape(t, d))[tok[kept]])
    assert int((rows.abs().sum(-1) > 0).sum()) == len(kept)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_wrt_x_and_every_parameter(name):
    jparams, params, x, k, cf = _setup(name)
    ct = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jax_moe.moe_apply(p, xx, k, cf)
        return jnp.sum(out * ct) + 0.37 * aux

    def loss(p, xx):
        out, aux = moe.moe_apply(p, xx, k, cf)
        return torch.sum(out * torch.from_numpy(ct)) + 0.37 * aux

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jparams, jnp.asarray(x))
    g = torch.func.grad(loss, argnums=(0, 1))(params, torch.from_numpy(x))
    np.testing.assert_allclose(g[1].numpy(), np.asarray(jg[1]), **TOL)
    for key in ("router", "wi", "wg", "wo"):
        np.testing.assert_allclose(g[0][key].numpy(),
                                   np.asarray(jg[0][key]), err_msg=key,
                                   **TOL)


@pytest.mark.parametrize("name", ["drops", "kimi"])
def test_vmap_over_workers_is_the_loop_bitwise(name):
    """Each worker with its own weights and tokens (the LLM step's
    `vmap` over workers): outputs and aux bitwise a loop over workers;
    so is each worker's gradient of its loss."""
    _, params, x, k, cf = _setup(name)
    n = 3
    rng = np.random.default_rng(4)
    ws = {key: torch.stack([v * (1.0 + 0.1 * j) for j in range(n)])
          for key, v in params.items()}
    xs = torch.from_numpy(rng.standard_normal((n,) + x.shape)
                          .astype(np.float32))

    def f(p, xx):
        return moe.moe_apply(p, xx, k, cf)

    out, aux = torch.func.vmap(f)(ws, xs)
    for j in range(n):
        o, a = f({key: v[j] for key, v in ws.items()}, xs[j])
        assert torch.equal(out[j], o) and torch.equal(aux[j], a), j

    def loss(p, xx):
        o, a = f(p, xx)
        return torch.sum(o * o) + a

    g = torch.func.vmap(torch.func.grad(loss))(ws, xs)
    for j in range(n):
        gj = torch.func.grad(loss)({key: v[j] for key, v in ws.items()},
                                   xs[j])
        for key in ws:
            assert torch.equal(g[key][j], gj[key]), (j, key)


def test_grad_of_grad_runs_and_matches_reference():
    """Second order (the refresh's grad-of-grad): d/dx of |d loss/dx|^2
    against the reference's."""
    jparams, params, x, k, cf = _setup("drops")

    def jinner(xx):
        out, aux = jax_moe.moe_apply(jparams, xx, k, cf)
        return jnp.sum(jnp.sin(out)) + aux

    def inner(xx):
        out, aux = moe.moe_apply(params, xx, k, cf)
        return torch.sum(torch.sin(out)) + aux

    want = jax.jit(jax.grad(lambda xx: jnp.sum(jax.grad(jinner)(xx) ** 2)))(
        jnp.asarray(x))
    got = torch.func.grad(lambda xx: torch.sum(
        torch.func.grad(inner)(xx) ** 2))(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_draws_the_references_tree():
    d, d_ff, e = 16, 24, 4
    want = jax.eval_shape(lambda kk: jax_moe.moe_init(kk, d, d_ff, e,
                                                      jnp.bfloat16),
                          jax.random.PRNGKey(0))
    got = moe.moe_init(torch.Generator().manual_seed(0), d, d_ff, e,
                       torch.bfloat16, lead=(2,))
    for key, w in want.items():
        assert tuple(got[key].shape) == (2,) + tuple(w.shape), key
        assert str(got[key].dtype).split(".")[-1] == str(w.dtype), key
    # each expert drawn on its own: distinct, unit scale over fan-in
    wi = got["wi"].float()
    assert not torch.equal(wi[0, 0], wi[0, 1])
    assert abs(float(wi.std()) * d ** 0.5 - 1.0) < 0.1
