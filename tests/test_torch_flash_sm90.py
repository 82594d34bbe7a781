"""The routing between the port's two flash attention kernels, and the
arithmetic of the tensor-core kernel (`csrc/flash_attention_sm90.cu`)
against the reference.

`flash_route` picks the kernel from the dtype and head dim alone: bf16 at
hd 64 or 128 runs on the tensor cores, everything else on the SIMT
kernel.  The tensor-core kernel rounds the probabilities P to bf16 before
P V (the A operand of a bf16 wgmma); `_tensor_core_arithmetic` repeats
its tiles, base-2 online softmax and roundings in PyTorch on the CPU, and
the test holds that to the reference's Pallas kernel (interpret mode,
through `repro.kernels.ops`) at the reference's bf16 tolerance 4e-2
(tests/test_kernels.py).  The kernel itself runs only on a card:
tests/test_torch_cuda.py.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import SM90_HEAD_DIMS, flash_route

BF16_TOL = 4e-2
MASKED = -1048576.0          # -2^20, the reference's masked score
KEY_TILE = 128               # keys per tile of the tensor-core kernel


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_route(dtype, hd):
    want = ("flash_attention" if dtype == torch.bfloat16 and hd in (64, 128)
            else "flash_attention_simt")
    assert flash_route(dtype, hd) == want
    assert SM90_HEAD_DIMS == (64, 128)


def _tensor_core_arithmetic(q, k, v, window):
    """Causal GQA attention as the tensor-core kernel computes it: f32
    scores of bf16 inputs over 128-key tiles, scaled to base 2, masked
    keys at -2^20, a running max m and denominator l summed from the f32
    probabilities, P rounded to bf16 before P V with f32 accumulation,
    and the output divided by max(l, 1e-30) in bf16."""
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)                               # b h s d
    kf = k.float().repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    scale_log2 = torch.tensor(1.0 / math.sqrt(hd) * math.log2(math.e),
                              dtype=torch.float32)
    m = torch.full((b, h, s, 1), MASKED)
    l = torch.zeros((b, h, s, 1))
    o = torch.zeros((b, h, s, hd))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, t, KEY_TILE):
        keys = torch.arange(k0, min(k0 + KEY_TILE, t))[None, :]
        sc = (qf @ kf[:, :, k0:k0 + KEY_TILE].transpose(-1, -2)) * scale_log2
        masked = keys > rows
        if window:
            masked = masked | (keys <= rows - window)
        sc = torch.where(masked, torch.tensor(MASKED), sc)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.bfloat16().float() @ vf[:, :, k0:k0 + KEY_TILE]
        m = m_new
    out = o / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("hd,window", [(128, 0), (64, 24)])
def test_tensor_core_rounding_fits_the_reference(hd, window):
    """P in bf16 keeps the kernel within the reference's bf16 tolerance of
    the Pallas kernel (B 1, S 256, H 4, Hkv 2: two key tiles, GQA)."""
    rng = np.random.default_rng(hd + window)
    x = [rng.normal(size=(1, 256, heads, hd)).astype(np.float32)
         for heads in (4, 2, 2)]
    tq, tk, tv = (torch.tensor(a).bfloat16() for a in x)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in x)
    got = _tensor_core_arithmetic(tq, tk, tv, window)
    want = jax_ops.flash_attention(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)
    # and within the same tolerance of the port's own plain version
    plain = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=BF16_TOL, atol=BF16_TOL)
