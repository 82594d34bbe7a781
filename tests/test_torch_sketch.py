"""The port's count sketch (`repro_torch.fed.sketch`) against the
reference's `repro/fed/sketch.py`, on the CPU.

Buckets and signs are bitwise the reference's `_leaf_hashes` (the port
hashes in int64 masked to 32 bits, in slices of the flat index); on the
CPU the sketch sums in the reference's order, so it is within rtol 1e-6
of it (bitwise, in fact); the adjoint identity <unsketch(t, s), w> ==
<s, sketch(w)> holds.  The card's deterministic accumulation is checked
in tests/test_torch_cuda.py.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert

ref_sketch = importlib.import_module("repro.fed.sketch")
sk = importlib.import_module("repro_torch.fed.sketch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run torch's CPU ops on one thread: the suite runs
    files in parallel processes, and torch's default of a thread per
    core oversubscribes the machine (one test ran 7x slower for it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_hashes(shape, seed, r):
    _, _, seeds = ref_sketch._leaf_seeds([0], seed)
    idx, sign = ref_sketch._leaf_hashes(shape, seeds[0], r)
    return np.asarray(idx), np.asarray(sign)


@pytest.mark.parametrize("shape,seed,r", [((7, 5), 3, 16), ((1000,), 11, 128),
                                          ((3, 4, 5), 1, 7),
                                          ((64, 33), 2 ** 31 + 5, 4096)])
def test_buckets_and_signs_bitwise_reference(shape, seed, r):
    want_idx, want_sign = _ref_hashes(shape, seed, r)
    idx, sign = sk.leaf_hashes(shape, sk.leaf_seeds(1, seed)[0], r)
    assert np.array_equal(idx.numpy(), want_idx)
    assert np.array_equal(sign.numpy(), want_sign)


def test_leaf_past_2_24_bitwise_and_sliced(monkeypatch):
    """A leaf of 2^24 + 3 elements: hashes bitwise the reference's, and
    hashing in small slices gives the same sketch bit for bit (the
    hash depends only on the flat index)."""
    n, seed, r = (1 << 24) + 3, 7, 256
    want_idx, want_sign = _ref_hashes((n,), seed, r)
    idx, sign = sk.leaf_hashes((n,), sk.leaf_seeds(1, seed)[0], r)
    assert np.array_equal(idx.numpy(), want_idx)
    assert np.array_equal(sign.numpy(), want_sign)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        n).astype(np.float32))
    whole = sk.sketch({"w": x}, seed, r)
    monkeypatch.setattr(sk, "SLICE", 1 << 20)
    sliced = sk.sketch({"w": x}, seed, r)
    assert torch.equal(whole, sliced)
    want = np.asarray(ref_sketch.sketch({"w": jnp.asarray(x.numpy())},
                                        seed, r))
    np.testing.assert_allclose(whole.numpy(), want, rtol=1e-6)


def _tree(rng):
    return {"emb": rng.standard_normal((50, 12)).astype(np.float32),
            "layers": [{"w": rng.standard_normal((12, 12)).astype(
                np.float32), "b": rng.standard_normal(12).astype(np.float32)}
                for _ in range(2)],
            "half": rng.standard_normal((9, 4)).astype(np.float32)}


@pytest.mark.parametrize("seed,r", [(0, 8), (2, 64), (5, 1024)])
def test_sketch_and_unsketch_match_reference(seed, r):
    rng = np.random.default_rng(seed)
    tree = _tree(rng)
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = convert.to_torch(tree, "cpu")
    ttree["half"] = ttree["half"].to(torch.bfloat16)
    jtree["half"] = jtree["half"].astype(jnp.bfloat16)
    got = sk.sketch(ttree, seed, r)
    want = np.asarray(ref_sketch.sketch(jtree, seed, r))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    s = rng.standard_normal(r).astype(np.float32)
    up = sk.unsketch(ttree, torch.from_numpy(s), seed)
    up_ref = ref_sketch.unsketch(jtree, jnp.asarray(s), seed)
    for a, b in zip(jax.tree.leaves(convert.to_numpy(up)),
                    jax.tree.leaves(up_ref)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    assert up["half"].dtype == torch.bfloat16


def test_adjoint_identity_and_rows():
    """<unsketch(t, s), w> == <s, sketch(w)>; `sketch_rows` of a stacked
    tree is each row's sketch (the reference's vmap)."""
    rng = np.random.default_rng(3)
    w = convert.to_torch(_tree(rng), "cpu")
    r, seed = 32, 4
    s = torch.from_numpy(rng.standard_normal(r).astype(np.float32))
    up = sk.unsketch(w, s, seed)
    lhs = sum(torch.sum(a.double() * b.double())
              for a, b in zip(jax.tree.leaves(up), jax.tree.leaves(w)))
    rhs = torch.sum(s.double() * sk.sketch(w, seed, r).double())
    assert abs(float(lhs - rhs)) <= 1e-5 * abs(float(rhs)) + 1e-6
    stacked = {"a": torch.randn(3, 40), "b": torch.randn(3, 2, 5)}
    rows = sk.sketch_rows(stacked, seed, r, batch_dims=1)
    for j in range(3):
        one = sk.sketch({"a": stacked["a"][j], "b": stacked["b"][j]}, seed, r)
        assert torch.equal(rows[j], one)
    back = sk.unsketch_rows({"a": stacked["a"][0], "b": stacked["b"][0]},
                            rows, seed, batch_dims=1)
    assert back["b"].shape == (3, 2, 5)


def test_sketch_derivatives_match_reference():
    """sketch's derivative is unsketch and back, to second order, as
    the reference's segment_sum / gather are."""
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    ttree = convert.to_torch(tree, "cpu")
    jtree = jax.tree.map(jnp.asarray, tree)
    g = torch.func.grad(lambda t: (sk.sketch(t, 2, 16) ** 2).sum())(ttree)
    gr = jax.grad(lambda t: (ref_sketch.sketch(t, 2, 16) ** 2).sum())(jtree)
    for a, b in zip(jax.tree.leaves(convert.to_numpy(g)),
                    jax.tree.leaves(gr)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    s0 = rng.standard_normal(16).astype(np.float32)
    f = lambda s: (sk.unsketch(ttree, s, 2)["emb"] ** 3).sum()
    fr = lambda s: (ref_sketch.unsketch(jtree, s, 2)["emb"] ** 3).sum()
    h = torch.func.grad(lambda s: torch.func.grad(f)(s).sum())(
        torch.from_numpy(s0))
    hr = jax.grad(lambda s: jax.grad(fr)(s).sum())(jnp.asarray(s0))
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), rtol=1e-5,
                               atol=1e-5)
