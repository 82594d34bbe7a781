"""The arithmetic of the port's f32 mLSTM chunk kernel on the tensor
cores (`csrc/mlstm_chunk_sm90_f32.cu`, route "mlstm_chunk_f32") against
the reference.

The kernel takes each of its four products (q C, q k^T, P V and
(k w_k)^T v) as three TF32 products of hi / lo halves, as the f32 flash
kernel does (tests/test_torch_flash_f32.py, whose emulation helpers this
file uses): q C slab by slab of 32 rows of C, P V and (k w_k)^T v key
tile by key tile of 16, each into a fresh accumulator added to the
running sum in f32, and the scores with their hi x hi halves and cross
terms apart.  The gates, stabilisers and weights are f32 as in the plain
version.  `_tf32x3_arithmetic` repeats that on the CPU and the tests hold
it to the reference's Pallas kernel (interpret mode, through
`repro.kernels.ops`) at the reference's f32 tolerance 6e-3
(tests/test_kernels.py) and to the port's plain version within
`chip_smoke.F32_GRADE_TOL`, which one TF32 pass exceeds, with and
without a carried state.  The kernel itself runs only on a card:
tests/test_torch_cuda.py.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import cut_eval as kern
from repro_torch.kernels import ops, ref
from repro_torch.kernels.mlstm_chunk import mlstm_route
from test_torch_flash_f32 import chain, chip_smoke, products, scores

F32_TOL = 6e-3               # tests/test_kernels.py, mLSTM in f32
KEY_TILE = 16
SLAB = 32


def _tiled(a, b, step, passes):
    """a @ b summed over K in blocks of `step`, each block's products into
    a fresh accumulator (one truncating sum a product) added in f32."""
    acc = torch.zeros(a.shape[:-1] + (b.shape[-1],))
    for k0 in range(0, a.shape[-1], step):
        acc = acc + chain(torch.zeros_like(acc),
                          products(a[..., k0:k0 + step],
                                   b[..., k0:k0 + step, :], passes))
    return acc


def _tf32x3_arithmetic(q, k, v, li, lf, c, n, m, passes=3):
    """One chunk (B,H,L,hd), f32, as the f32 tensor-core kernel computes
    it: q C in slabs of 32 rows of C, scores by `scores`, P = S e^(D -
    m_t) / sqrt(hd) masked to exact zeros, P V and (k w_k)^T v in key
    tiles of 16, q . n, the denominator and n' in f32."""
    hd = q.shape[-1]
    l = q.shape[2]
    scale = 1.0 / math.sqrt(hd)
    bcum = torch.cumsum(lf[..., 0], dim=-1)               # (B,H,L)
    li = li[..., 0]
    m_prev = m[..., 0, 0]                                 # (B,H)
    dmat = (bcum[..., :, None] - bcum[..., None, :]) + li[..., None, :]
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool))
    dmat = torch.where(causal, dmat, torch.tensor(-math.inf))
    m_inter = bcum + m_prev[..., None]
    m_t = torch.maximum(m_inter, dmat.amax(-1))
    w_inter = torch.exp(m_inter - m_t)

    acc = _tiled(q, c, SLAB, passes) * (w_inter * scale)[..., None]
    den = torch.zeros_like(m_t)
    for s0 in range(0, l, KEY_TILE):
        ks = slice(s0, s0 + KEY_TILE)
        sc = scores(q, k[..., ks, :].transpose(-1, -2), passes)
        w = torch.exp(dmat[..., ks] - m_t[..., None])
        p = torch.where(causal[:, ks], sc * scale * w, torch.zeros(()))
        den = den + p.sum(-1)
        acc = acc + _tiled(p, v[..., ks, :], KEY_TILE, passes)
    den = den + (q @ n.transpose(-1, -2))[..., 0] * scale * w_inter
    y = acc / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]

    btot = bcum[..., -1]
    a = (btot[..., None] - bcum) + li
    m_new = torch.maximum(btot + m_prev, a.amax(-1))
    w_c = torch.exp(btot + m_prev - m_new)
    kw = k * torch.exp(a - m_new[..., None])[..., None]
    upd = torch.zeros_like(c)
    for s0 in range(0, l, KEY_TILE):
        ks = slice(s0, s0 + KEY_TILE)
        upd = upd + _tiled(kw[..., ks, :].transpose(-1, -2), v[..., ks, :],
                           KEY_TILE, passes)
    c_new = c * w_c[..., None, None] + upd
    n_new = n * w_c[..., None, None] + kw.sum(-2, keepdim=True)
    return y, c_new, n_new, m_new[..., None, None]


def _inputs(b, h, l, hd, seed, carried=True):
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    qkv = [normal(b, h, l, hd) for _ in range(3)]
    li = normal(b, h, l, 1, scale=0.5)
    lf = np.log(1.0 / (1.0 + np.exp(-(normal(b, h, l, 1) + 2.0))))
    state = [normal(b, h, hd, hd, scale=0.3), normal(b, h, 1, hd, scale=0.3),
             normal(b, h, 1, 1)]
    if not carried:
        # the model's initial state
        state = [np.zeros((b, h, hd, hd), np.float32),
                 np.zeros((b, h, 1, hd), np.float32),
                 np.full((b, h, 1, 1), -1e9, np.float32)]
    return qkv + [li, lf.astype(np.float32)] + state


def _rel(got, want):
    """max |got - want| / max |want| of each output."""
    return [float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
            for g, w in zip(got, want)]


@pytest.mark.parametrize("carried", [True, False])
@pytest.mark.parametrize("l,hd", [(100, 64), (256, 64), (100, 192),
                                  (256, 192)])
def test_tf32x3_arithmetic_fits_the_reference(l, hd, carried):
    """The kernel's arithmetic (B 1, H 2) within the reference's f32
    tolerance of the Pallas kernel and within F32_GRADE_TOL of the port's
    plain version, for each of y, C', n' and m', with ragged L (100 is not
    a multiple of the 64-row tiles)."""
    x = _inputs(1, 2, l, hd, l + hd + carried, carried)
    t = [torch.tensor(a) for a in x]
    got = _tf32x3_arithmetic(*t)
    want = jax_ops.mlstm_chunk(*(jnp.asarray(a) for a in x))
    for g, w, name in zip(got, want, ("y", "c", "n", "m")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=name)
    plain = ops.mlstm_chunk(*t)
    assert max(_rel(got, plain)) <= chip_smoke.F32_GRADE_TOL["mlstm"]


@pytest.mark.parametrize("l,hd", [(100, 64), (256, 192)])
def test_one_tf32_pass_is_not_f32_grade(l, hd):
    """One TF32 product per product reads beyond F32_GRADE_TOL, though
    within the reference's own f32 tolerance."""
    t = [torch.tensor(a) for a in _inputs(1, 2, l, hd, 9 + l + hd)]
    plain = ops.mlstm_chunk(*t)
    one = _tf32x3_arithmetic(*t, passes=1)
    assert max(_rel(one, plain)) > 4 * chip_smoke.F32_GRADE_TOL["mlstm"]
    for g, w in zip(one, plain):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=F32_TOL,
                                   atol=F32_TOL)


@pytest.mark.parametrize("l,hd", [(1, 64), (512, 128), (33, 192)])
def test_cpu_tensors_take_the_plain_version(l, hd):
    """f32 at the kernel's head dims and lengths routes to
    "mlstm_chunk_f32" on a card; CPU tensors run the plain version and
    launch nothing."""
    assert mlstm_route(torch.float32, hd, l) == "mlstm_chunk_f32"
    t = [torch.tensor(a) for a in _inputs(1, 2, l, hd, l)]
    kern.reset_launches()
    got = ops.mlstm_chunk(*t)
    assert sum(kern.LAUNCHES.values()) == 0
    for g, w in zip(got, ref.mlstm_chunk_ref(*t)):
        assert torch.equal(g, w)
