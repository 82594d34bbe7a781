"""The port's LLM kernels (`flash_attention`, `mlstm_chunk`) against the
reference.

On the CPU the wrappers run their plain versions (`repro_torch.kernels.
ref`); they are held to the reference's Pallas kernels (interpret mode,
through `repro.kernels.ops`) and to its jnp oracles (`repro.kernels.ref`)
at the reference's own tolerances (tests/test_kernels.py): flash 2e-3
for f32 and 4e-2 for bf16, mLSTM 6e-3 and 6e-2.  The CUDA kernels
themselves run only on a card: tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models.xlstm import init_mlstm_state as jax_init_mlstm_state
from repro_torch.kernels import cut_eval as kern
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import mlstm_chunk as mlstm_kernel
from repro_torch.kernels import ops, ref

FLASH_TOL = {"float32": 2e-3, "bfloat16": 4e-2}
MLSTM_TOL = {"float32": 6e-3, "bfloat16": 6e-2}


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _both(x, dtype):
    """One numpy array as (jax array, torch tensor) of `dtype`."""
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.tensor(x).to(getattr(torch, dtype)))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _qkv(b, s, t, h, hkv, hd, seed, dtype):
    rng = np.random.default_rng(seed)
    return [_both(_normal(rng, b, n, heads, hd), dtype)
            for n, heads in ((s, h), (t, hkv), (t, hkv))]


@pytest.mark.parametrize("s,h,hkv,hd,blk", [
    (64, 4, 2, 32, 16), (48, 4, 4, 64, 16), (128, 8, 2, 32, 32),
])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_reference(s, h, hkv, hd, blk, window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, s, s, h, hkv, hd, s + h + window,
                                        dtype)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                              block_q=blk, block_k=blk)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = FLASH_TOL[dtype]
    _close(got, jax_ops.flash_attention(jq, jk, jv, causal=True,
                                        window=window, block_q=blk,
                                        block_k=blk), tol, "vs Pallas")
    _close(got, jax_ref.flash_attention_ref(jq, jk, jv, causal=True,
                                            window=window), tol, "vs oracle")


@pytest.mark.parametrize("s,t,window", [(37, 37, 0), (37, 37, 10),
                                        (20, 37, 0), (37, 20, 0)])
def test_flash_ragged_lengths(s, t, window):
    """Lengths that are no block multiple, and S != T, causal: the plain
    version against the oracle (and the padded Pallas route where the
    reference's padding is exact, S <= T)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, s, t, 2, 1, 16, s * t, "float32")
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                              block_q=16, block_k=16)
    assert got.shape == (1, s, 2, 16)
    _close(got, jax_ref.flash_attention_ref(jq, jk, jv, causal=True,
                                            window=window), 2e-3)
    if s <= t:
        _close(got, jax_ops.flash_attention(jq, jk, jv, causal=True,
                                            window=window, block_q=16,
                                            block_k=16), 2e-3)


def test_flash_noncausal_unaligned_raises():
    """The reference wrapper's contract: non-causal inputs must be block
    aligned, with a ValueError naming the shapes and blocks."""
    rng = np.random.default_rng(0)
    q = torch.tensor(_normal(rng, 1, 37, 2, 16))
    with pytest.raises(ValueError, match=r"non-causal.*37.*block"):
        ops.flash_attention(q, q, q, causal=False, block_q=16, block_k=16)
    # aligned non-causal still works, unmasked as in the reference
    x = _normal(rng, 1, 32, 2, 16)
    got = ops.flash_attention(torch.tensor(x), torch.tensor(x),
                              torch.tensor(x), causal=False, block_q=16,
                              block_k=16)
    jx = jnp.asarray(x)
    _close(got, jax_ops.flash_attention(jx, jx, jx, causal=False,
                                        block_q=16, block_k=16), 2e-3)


def test_flash_wrapper_checks():
    """The kernel wrapper refuses what the kernel does not take (on the
    CPU before it runs the plain version)."""
    rng = np.random.default_rng(1)
    q = torch.tensor(_normal(rng, 1, 8, 3, 16))
    q2 = q[:, :, :2].contiguous()
    kv = torch.tensor(_normal(rng, 1, 8, 2, 16))
    with pytest.raises(ValueError, match="group"):
        flash_kernel.flash_attention(q, kv, kv)
    with pytest.raises(TypeError, match="f32 or all bf16"):
        flash_kernel.flash_attention(q2, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="not contiguous"):
        flash_kernel.flash_attention(q[:, :, :2], kv, kv)
    with pytest.raises(ValueError, match="impl='kernel' needs CUDA"):
        ops.flash_attention(q2, kv, kv, impl="kernel")


# ---------------------------------------------------------------------------
# mLSTM chunk
# ---------------------------------------------------------------------------

def _mlstm_inputs(b, h, l, hd, seed, carried):
    rng = np.random.default_rng(seed)
    q, k, v = (_normal(rng, b, h, l, hd) for _ in range(3))
    li = _normal(rng, b, h, l, 1, scale=0.5)
    lf = np.asarray(jax.nn.log_sigmoid(_normal(rng, b, h, l, 1) + 2.0))
    if carried:
        c = _normal(rng, b, h, hd, hd, scale=0.3)
        n = _normal(rng, b, h, 1, hd, scale=0.3)
        m = _normal(rng, b, h, 1, 1)
    else:
        c = np.zeros((b, h, hd, hd), np.float32)
        n = np.zeros((b, h, 1, hd), np.float32)
        m = np.full((b, h, 1, 1), -1e9, np.float32)
    return (q, k, v), (li, lf, c, n, m)


@pytest.mark.parametrize("l,hd", [(8, 8), (16, 16), (32, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_plain_matches_reference(l, hd, dtype, carried):
    qkv, rest = _mlstm_inputs(2, 3, l, hd, l + hd, carried)
    jqkv, tqkv = zip(*(_both(x, dtype) for x in qkv))
    jrest = [jnp.asarray(x) for x in rest]
    trest = [torch.tensor(x) for x in rest]
    got = ops.mlstm_chunk(*tqkv, *trest)
    assert got[0].dtype == tqkv[0].dtype
    assert all(x.dtype == torch.float32 for x in got[1:])
    tol = MLSTM_TOL[dtype]
    for want_all, who in ((jax_ops.mlstm_chunk(*jqkv, *jrest), "Pallas"),
                          (jax_ref.mlstm_chunk_ref(*jqkv, *jrest), "oracle")):
        for g, w, name in zip(got, want_all, ("y", "c", "n", "m")):
            _close(g, w, tol, f"{name} vs {who}")


def test_mlstm_sequence_ragged_tail():
    """Full chunks plus one ragged tail (S % chunk != 0), state carried
    across every boundary: the reference's `mlstm_sequence`."""
    b, h, s, hd = 1, 2, 40, 8
    rng = np.random.default_rng(3)
    q, k, v = (_normal(rng, b, s, h, hd) for _ in range(3))
    li = _normal(rng, b, s, h, scale=0.5)
    lf = np.asarray(jax.nn.log_sigmoid(_normal(rng, b, s, h) + 2.0))
    jstate = jax_init_mlstm_state(b, h, hd)
    y_want, st_want = jax_ops.mlstm_sequence(
        *(jnp.asarray(x) for x in (q, k, v, li, lf)), jstate, chunk=16)
    tstate = {key: torch.tensor(np.asarray(x)) for key, x in jstate.items()}
    y, st = ops.mlstm_sequence(*(torch.tensor(x) for x in (q, k, v, li, lf)),
                               tstate, chunk=16)
    assert y.shape == (b, s, h, hd)
    _close(y, y_want, 6e-3, "y")
    for key in ("c", "n", "m"):
        _close(st[key], st_want[key], 6e-3, key)


def test_mlstm_wrapper_checks():
    qkv, rest = _mlstm_inputs(1, 2, 8, 8, 0, False)
    t = [torch.tensor(x) for x in (*qkv, *rest)]
    with pytest.raises(ValueError, match="li of shape"):
        mlstm_kernel.mlstm_chunk(*t[:3], t[3][:, :, :4], *t[4:])
    with pytest.raises(TypeError, match="c dtype"):
        mlstm_kernel.mlstm_chunk(*t[:5], t[5].double(), *t[6:])
    with pytest.raises(ValueError, match="impl='kernel' needs CUDA"):
        ops.mlstm_chunk(*t, impl="kernel")


def test_cpu_route_launches_no_kernel():
    kern.reset_launches()
    qkv, rest = _mlstm_inputs(1, 2, 8, 8, 0, False)
    ops.mlstm_chunk(*(torch.tensor(x) for x in (*qkv, *rest)))
    x = torch.tensor(qkv[0]).transpose(1, 2).contiguous()
    ops.flash_attention(x, x, x)
    flash_kernel.flash_attention(x, x, x)
    assert sum(kern.LAUNCHES.values()) == 0
