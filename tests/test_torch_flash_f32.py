"""The arithmetic of the port's f32 flash kernel on the tensor cores
(`csrc/flash_attention_sm90_f32.cu`, route "flash_attention_f32") against
the reference, and what makes it f32-grade.

A TF32 product rounds its operands to 10 mantissa bits.  The kernel
splits every f32 operand x into hi = tf32(x) and lo = tf32(x - hi) (both
rounded to nearest, ties away, as `cvt.rna.tf32.f32`) and takes each
product as lo_a hi_b + hi_a lo_b + hi_a hi_b ("3xTF32").  The tensor
cores round each wgmma's sum toward zero, so the kernel keeps every
chain of products into one accumulator short: a score's hi x hi products
over each half of the head dim and its cross terms go to accumulators of
their own, summed in f32; P V goes to a fresh accumulator each key tile,
added to O in f32.  `_tf32x3_arithmetic` repeats all of that in PyTorch
on the CPU (key tiles of 4,096 / hd, the base-2 online softmax with
masked scores at -2^20, one truncating sum per 8-wide product) and the
tests hold it to the reference's Pallas kernel (interpret mode, through
`repro.kernels.ops`) at the reference's f32 tolerance 2e-3
(tests/test_kernels.py), and to the port's plain version within
`chip_smoke.F32_GRADE_TOL`, which one TF32 pass exceeds.  The kernel
itself runs only on a card: tests/test_torch_cuda.py.
"""
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import cut_eval as kern
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import F32_HEAD_DIMS, flash_route

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
try:
    import chip_smoke
finally:
    sys.path.remove(str(REPO))

F32_TOL = 2e-3               # tests/test_kernels.py, flash in f32
MASKED = -1048576.0          # -2^20, the reference's masked score


def tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as an f32: the low 13 bits of the magnitude rounded off."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return bits.to(torch.int32).view(torch.float32)


def split(x):
    """hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def to_zero(x):
    """A float64 tensor rounded to f32 toward zero, as the tensor cores
    round a wgmma's sum."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def chain(acc, terms):
    """acc after one truncating wgmma sum per (a, b) in `terms`, in
    order: each a @ b taken exactly (8-wide, as one TF32 k-step)."""
    for a, b in terms:
        acc = to_zero(acc.double() + a.double() @ b.double())
    return acc


def products(a, b, passes=3):
    """The terms of a @ b as the kernel issues them, k-step by k-step of
    8: lo_a hi_b, hi_a lo_b, hi_a hi_b (passes 3) or hi_a hi_b alone
    (passes 1: one TF32 product)."""
    (ah, al), (bh, bl) = split(a), split(b)
    out = []
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if passes == 3:
            out += [(al[..., ks], bh[..., ks, :]),
                    (ah[..., ks], bl[..., ks, :])]
        out.append((ah[..., ks], bh[..., ks, :]))
    return out


def scores(a, b, passes=3):
    """a @ b as the kernel's scores: hi x hi over each half of K in an
    accumulator of its own, the cross terms in a third, summed in f32."""
    zero = torch.zeros(a.shape[:-1] + (b.shape[-1],))
    terms = products(a, b, passes)
    if passes == 1:
        return chain(zero, terms)
    big = terms[2::3]
    half = len(big) // 2
    cross = [t for i, t in enumerate(terms) if i % 3 != 2]
    return (chain(zero, cross) + chain(zero, big[:half])) \
        + chain(zero, big[half:])


def _tf32x3_arithmetic(q, k, v, window, passes=3):
    """Causal GQA attention (f32) as the f32 tensor-core kernel computes
    it: key tiles of 4,096 / hd, unscaled scores (`scores`), masked keys
    at -2^20 before scaling, the online softmax in base 2, P split into
    hi and lo, P V of each tile (`products`, one truncating sum a
    product) added to O in f32, O / max(l, 1e-30)."""
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qf = q.transpose(1, 2)                                       # b h s d
    kf = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    vf = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    c = torch.tensor(1.0 / math.sqrt(hd) * math.log2(math.e),
                     dtype=torch.float32)
    masked = torch.tensor(MASKED) / c
    m = torch.full((b, h, s, 1), float(masked))
    l = torch.zeros((b, h, s, 1))
    o = torch.zeros((b, h, s, hd))
    rows = torch.arange(s)[:, None]
    tile = 4096 // hd
    for k0 in range(0, t, tile):
        keys = torch.arange(k0, min(k0 + tile, t))[None, :]
        sc = scores(qf, kf[:, :, k0:k0 + tile].transpose(-1, -2), passes)
        out = keys > rows
        if window:
            out = out | (keys <= rows - window)
        sc = torch.where(out, masked, sc)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(sc * c - m_new * c)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = chain(torch.zeros_like(o),
                   products(p, vf[:, :, k0:k0 + tile], passes))
        o = o * alpha + pv
        m = m_new
    return (o / torch.clamp(l, min=1e-30)).transpose(1, 2)


def _inputs(hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, 256, heads, hd)).astype(np.float32)
            for heads in (4, 2, 2)]


def test_hi_lo_split_keeps_twenty_one_bits():
    """Two TF32 halves carry x to 2^-21 of its size (one TF32 keeps about
    2^-11)."""
    rng = np.random.default_rng(0)
    x = torch.tensor((rng.normal(size=4096)
                      * np.exp2(rng.integers(-20, 20, size=4096)))
                     .astype(np.float32))
    hi, lo = split(x)
    assert torch.all((hi + lo - x).abs() <= x.abs() * 2.0 ** -21)
    assert torch.any((hi - x).abs() > x.abs() * 2.0 ** -12)
    assert torch.all((tf32(hi) == hi) & (tf32(lo) == lo))


@pytest.mark.parametrize("hd,window", [(128, 0), (128, 24), (256, 0),
                                       (256, 24)])
def test_tf32x3_arithmetic_fits_the_reference(hd, window):
    """The kernel's arithmetic (B 1, S 256, H 4, Hkv 2) within the
    reference's f32 tolerance of the Pallas kernel, and within
    F32_GRADE_TOL of the port's plain version, row by row."""
    x = _inputs(hd, hd + window)
    tq, tk, tv = (torch.tensor(a) for a in x)
    got = _tf32x3_arithmetic(tq, tk, tv, window)
    want = jax_ops.flash_attention(*(jnp.asarray(a) for a in x),
                                   causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    plain = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    assert chip_smoke.row_rel_err(got, plain) \
        <= chip_smoke.F32_GRADE_TOL["flash"]


@pytest.mark.parametrize("hd,window", [(128, 0), (256, 24)])
def test_one_tf32_pass_is_not_f32_grade(hd, window):
    """One TF32 product per product reads beyond F32_GRADE_TOL (about
    1e-3 of a row's size), though within the reference's own f32
    tolerance: that limit is what tells three passes from one."""
    tq, tk, tv = (torch.tensor(a) for a in _inputs(hd, 5 + hd + window))
    plain = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    one = _tf32x3_arithmetic(tq, tk, tv, window, passes=1)
    assert chip_smoke.row_rel_err(one, plain) \
        > 10 * chip_smoke.F32_GRADE_TOL["flash"]
    np.testing.assert_allclose(one.numpy(), plain.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_cpu_tensors_take_the_plain_version(hd):
    """f32 at the kernel's head dims routes to "flash_attention_f32" on a
    card; CPU tensors run the plain version and launch nothing."""
    assert flash_route(torch.float32, hd) == "flash_attention_f32"
    assert hd in F32_HEAD_DIMS
    tq, tk, tv = (torch.tensor(a[:, :40]) for a in _inputs(hd, 3))
    kern.reset_launches()
    got = ops.flash_attention(tq, tk, tv, causal=True, window=16)
    assert sum(kern.LAUNCHES.values()) == 0
    from repro_torch.kernels import ref
    assert torch.equal(got, ref.flash_attention_ref(tq, tk, tv, causal=True,
                                                    window=16))
