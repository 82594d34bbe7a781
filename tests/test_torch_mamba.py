"""The port's Mamba mixer (`repro_torch.models.mamba`) against the
reference's (`repro/models/mamba.py`), on the CPU.

Weights come from the reference's `mamba_init(PRNGKey(0))` through
`convert` (with dt_bias, conv_b and d_skip moved off their constant
inits by numpy noise, so that the scan decays and every weight matters),
tokens from numpy with a seed.  `mamba_apply` over several chunks with a
carried state, and `mamba_decode` token by token, against the
reference and against `mamba_apply` on the same tokens; outputs, states
and gradients at rtol 1e-4 / atol 1e-5.  The log-depth chunk scan
reorders the reference's products, so it is held to tolerance, and
within the port to a sequential loop over the positions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jax_mamba
from repro_torch import convert
from repro_torch.models import mamba

TOL = dict(rtol=1e-4, atol=1e-5)
D, EXPAND, D_STATE, D_CONV = 16, 2, 4, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs files in parallel
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jp = jax.tree.map(np.asarray, jax_mamba.mamba_init(
        jax.random.PRNGKey(0), D, EXPAND, D_STATE, D_CONV, jnp.float32))
    rng = np.random.default_rng(7)
    di = EXPAND * D
    jp = dict(jp)
    jp["dt_bias"] = (rng.standard_normal(di) * 0.5 - 1.0).astype(np.float32)
    jp["conv_b"] = (rng.standard_normal(di) * 0.1).astype(np.float32)
    jp["d_skip"] = (1.0 + rng.standard_normal(di) * 0.1).astype(np.float32)
    return jax.tree.map(jnp.asarray, jp), convert.params_from_reference(
        jp, "cpu")


def _x(b, s, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, D)) \
        .astype(np.float32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               err_msg=msg, **TOL)


def test_apply_in_chunks_with_a_carried_state(weights):
    """32 tokens in four chunks of 8, then 24 more (three chunks) from
    the carried state: outputs and states against the reference; the
    two calls equal one call over the 56 tokens in chunks of 8, bit for
    bit."""
    jp, p = weights
    x = _x(2, 56)
    jy1, jst = jax_mamba.mamba_apply(jp, jnp.asarray(x[:, :32]), chunk=8)
    y1, st = mamba.mamba_apply(p, torch.from_numpy(x[:, :32]), chunk=8)
    _close(y1, jy1)
    for key in ("conv", "ssm"):
        _close(st[key], jst[key], key)
    jy2, jst = jax_mamba.mamba_apply(jp, jnp.asarray(x[:, 32:]), chunk=8,
                                     state=jst)
    y2, st = mamba.mamba_apply(p, torch.from_numpy(x[:, 32:]), chunk=8,
                               state=st)
    _close(y2, jy2)
    for key in ("conv", "ssm"):
        _close(st[key], jst[key], key)
    whole, st_w = mamba.mamba_apply(p, torch.from_numpy(x), chunk=8)
    assert torch.equal(torch.cat([y1, y2], 1), whole)
    assert torch.equal(st["ssm"], st_w["ssm"])


def test_decode_token_by_token(weights):
    """From a 16-token prefill, 6 decode steps: each against the
    reference's decode, and against `mamba_apply` over the same 22
    tokens (outputs and the final state)."""
    jp, p = weights
    x = _x(2, 22, seed=1)
    _, jst = jax_mamba.mamba_apply(jp, jnp.asarray(x[:, :16]), chunk=8)
    _, st = mamba.mamba_apply(p, torch.from_numpy(x[:, :16]), chunk=8)
    ys = []
    for i in range(16, 22):
        xt = x[:, i:i + 1]
        jy, jst = jax_mamba.mamba_decode(jp, jnp.asarray(xt), jst)
        y, st = mamba.mamba_decode(p, torch.from_numpy(xt), st)
        _close(y, jy, f"token {i}")
        for key in ("conv", "ssm"):
            _close(st[key], jst[key], f"token {i} {key}")
        ys.append(y)
    full, st_full = mamba.mamba_apply(p, torch.from_numpy(x), chunk=22)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(),
                               full[:, 16:].numpy(), **TOL)
    np.testing.assert_allclose(st["ssm"].numpy(), st_full["ssm"].numpy(),
                               **TOL)


def test_gradients_wrt_x_and_every_parameter(weights):
    jp, p = weights
    x = _x(2, 24, seed=2)
    ct = np.random.default_rng(3).standard_normal((2, 24, D)) \
        .astype(np.float32)

    def jloss(w, xx):
        y, st = jax_mamba.mamba_apply(w, xx, chunk=8)
        return jnp.sum(y * ct) + jnp.sum(st["ssm"] ** 2)

    def loss(w, xx):
        y, st = mamba.mamba_apply(w, xx, chunk=8)
        return torch.sum(y * torch.from_numpy(ct)) + torch.sum(st["ssm"] ** 2)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    g = torch.func.grad(loss, argnums=(0, 1))(p, torch.from_numpy(x))
    _close(g[1], jg[1], "x")
    for key in jp:
        _close(g[0][key], jg[0][key], key)


@pytest.mark.parametrize("length", [1, 5, 8, 12])
def test_log_depth_scan_is_the_sequential_recurrence(length):
    """h_t = a_t h_{t-1} + b_t from h0, in log2(L) steps, for L a power
    of two and not."""
    rng = np.random.default_rng(length)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, length, 3, 4))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, length, 3, 4))
                         .astype(np.float32))
    h0 = torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32))
    h, last = mamba._chunk_scan(a, b, h0)
    want, cur = [], h0
    for t in range(length):
        cur = a[:, t] * cur + b[:, t]
        want.append(cur)
    torch.testing.assert_close(h, torch.stack(want, 1), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(last, h[:, -1])
    assert mamba.scan_steps(256) == 8 and mamba.scan_steps(length) == (
        0 if length == 1 else int(np.ceil(np.log2(length))))


@pytest.mark.parametrize("s,chunk", [(13, 4), (513, 256)])
def test_refuses_lengths_the_reference_cannot_reshape(weights, s, chunk):
    jp, p = weights
    x = _x(1, s)
    with pytest.raises(ValueError, match="equal chunks"):
        mamba.mamba_apply(p, torch.from_numpy(x), chunk=chunk)
    with pytest.raises(TypeError):
        jax_mamba.mamba_apply(jp, jnp.asarray(x), chunk=chunk)


def test_init_draws_the_references_tree():
    want = jax.eval_shape(lambda k: jax_mamba.mamba_init(
        k, D, EXPAND, D_STATE, D_CONV, jnp.bfloat16), jax.random.PRNGKey(0))
    got = mamba.mamba_init(torch.Generator().manual_seed(0), D, EXPAND,
                           D_STATE, D_CONV, torch.bfloat16)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == tuple(w.shape), key
        assert str(got[key].dtype).split(".")[-1] == str(w.dtype), key
    ref = jax.tree.map(np.asarray, jax_mamba.mamba_init(
        jax.random.PRNGKey(0), D, EXPAND, D_STATE, D_CONV, jnp.bfloat16))
    for key in ("a_log", "d_skip", "dt_bias", "conv_b"):
        np.testing.assert_array_equal(convert.to_numpy(got[key]),
                                      np.asarray(ref[key], np.float32))
