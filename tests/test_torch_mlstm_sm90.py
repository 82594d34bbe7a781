"""The routing between the port's two mLSTM chunk kernels, and the
arithmetic of the tensor-core kernel (`csrc/mlstm_chunk_sm90.cu`) against
the reference.

`mlstm_route` picks the kernel from the dtype, head dim and chunk length:
bf16 at hd 64, 128 or 192 in chunks of at most 512 runs on the tensor
cores, f32 there on the tensor cores in three TF32 passes
(`mlstm_chunk_sm90_f32.cu`, tests/test_torch_mlstm_f32.py), everything
else on the SIMT kernel.  The tensor-core kernel rounds at other places than the plain
version: the carried state C and the weighted keys k w_k enter bf16
products as two halves hi = bf16(x), lo = bf16(x - hi), and the decayed
scores P are rounded to bf16 before P V while their f32 row sums form the
denominator.  `_tensor_core_arithmetic` repeats those roundings in
PyTorch on the CPU, and the tests hold it to the reference's Pallas
kernel (interpret mode, through `repro.kernels.ops`) at the reference's
bf16 tolerance 6e-2 (tests/test_kernels.py), with a carried state and a
ragged L.  The kernel itself runs only on a card:
tests/test_torch_cuda.py.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import ops
from repro_torch.kernels.mlstm_chunk import (SM90_HEAD_DIMS, SM90_MAX_LEN,
                                             mlstm_route)

BF16_TOL = 6e-2


@pytest.mark.parametrize("l", [1, 256, 512, 513, 4096])
@pytest.mark.parametrize("hd", [8, 64, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_route(dtype, hd, l):
    want = "mlstm_chunk_simt"
    if hd in (64, 128, 192) and l <= 512:
        want = ("mlstm_chunk" if dtype == torch.bfloat16
                else "mlstm_chunk_f32")
    assert mlstm_route(dtype, hd, l) == want
    assert SM90_HEAD_DIMS == (64, 128, 192) and SM90_MAX_LEN == 512


def _split(x):
    """x as the kernel feeds it to a bf16 product: hi = bf16(x) and
    lo = bf16(x - hi), both back in f32."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def test_hi_lo_split_keeps_sixteen_bits():
    """Two bf16 halves carry x to about 2^-16 of its size (one bf16 keeps
    2^-9, TF32 2^-11)."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=4096).astype(np.float32)
                     * np.exp2(rng.integers(-20, 20, size=4096)))
    hi, lo = _split(x)
    assert torch.all((hi + lo - x).abs() <= x.abs() * 2.0 ** -16)
    assert torch.any((hi - x).abs() > x.abs() * 2.0 ** -12)


def _tensor_core_arithmetic(q, k, v, li, lf, c, n, m):
    """One chunk (B,H,L,hd) as the tensor-core kernel computes it: f32
    scores and q C of bf16 q with C split into hi and lo, the decay weights
    and stabilisers in f32, P = S e^(D - m_t) / sqrt(hd) summed in f32 and
    rounded to bf16 before P V, y in bf16; the state from k w_k split into
    hi and lo times v, n' from the f32 products."""
    hd = q.shape[-1]
    l = q.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf = q.float(), k.float(), v.float()
    bcum = torch.cumsum(lf[..., 0], dim=-1)               # (B,H,L)
    li = li[..., 0]
    m_prev = m[..., 0, 0]                                 # (B,H)
    dmat = (bcum[..., :, None] - bcum[..., None, :]) + li[..., None, :]
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool))
    dmat = torch.where(causal, dmat, torch.tensor(-math.inf))
    m_inter = bcum + m_prev[..., None]
    m_t = torch.maximum(m_inter, dmat.amax(-1))
    w_inter = torch.exp(m_inter - m_t)

    c_hi, c_lo = _split(c)
    acc = (qf @ c_hi + qf @ c_lo) * (w_inter * scale)[..., None]
    p = (qf @ kf.transpose(-1, -2)) * scale * torch.exp(dmat - m_t[..., None])
    den = p.sum(-1) + (qf @ n.transpose(-1, -2))[..., 0] * scale * w_inter
    acc = acc + p.bfloat16().float() @ vf
    y = acc / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]

    btot = bcum[..., -1]
    a = (btot[..., None] - bcum) + li
    m_new = torch.maximum(btot + m_prev, a.amax(-1))
    w_c = torch.exp(btot + m_prev - m_new)
    kw = kf * torch.exp(a - m_new[..., None])[..., None]
    kw_hi, kw_lo = _split(kw)
    c_new = c * w_c[..., None, None] + kw_hi.transpose(-1, -2) @ vf \
        + kw_lo.transpose(-1, -2) @ vf
    n_new = n * w_c[..., None, None] + kw.sum(-2, keepdim=True)
    return (y.to(q.dtype), c_new, n_new, m_new[..., None, None])


def _inputs(b, h, l, hd, seed):
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    qkv = [normal(b, h, l, hd) for _ in range(3)]
    li = normal(b, h, l, 1, scale=0.5)
    lf = np.log(1.0 / (1.0 + np.exp(-(normal(b, h, l, 1) + 2.0))))
    return qkv, [li, lf.astype(np.float32), normal(b, h, hd, hd, scale=0.3),
                 normal(b, h, 1, hd, scale=0.3), normal(b, h, 1, 1)]


@pytest.mark.parametrize("l,hd", [(100, 64), (64, 128), (37, 192)])
def test_tensor_core_rounding_fits_the_reference(l, hd):
    """The kernel's roundings stay within the reference's bf16 tolerance of
    the Pallas kernel and of the port's plain version, with a carried
    state and ragged L (100 and 37 are not multiples of the 64-row
    tiles)."""
    qkv, rest = _inputs(1, 2, l, hd, l + hd)
    tqkv = [torch.tensor(x).bfloat16() for x in qkv]
    trest = [torch.tensor(x) for x in rest]
    jqkv = [jnp.asarray(x).astype(jnp.bfloat16) for x in qkv]
    jrest = [jnp.asarray(x) for x in rest]
    got = _tensor_core_arithmetic(*tqkv, *trest)
    assert got[0].dtype == torch.bfloat16
    for want_all, who in ((jax_ops.mlstm_chunk(*jqkv, *jrest), "Pallas"),
                          (ops.mlstm_chunk(*tqkv, *trest), "plain")):
        for g, w, name in zip(got, want_all, ("y", "c", "n", "m")):
            if isinstance(w, torch.Tensor):
                w = w.float()
            np.testing.assert_allclose(
                g.float().numpy(), np.asarray(w, np.float32), rtol=BF16_TOL,
                atol=BF16_TOL, err_msg=f"{name} vs {who}")
