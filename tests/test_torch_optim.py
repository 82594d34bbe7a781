"""The port's optimizers and schedules (`repro_torch.optim`) against the
reference's `repro/optim`, on the CPU: five updates of a small tree with
f32 and bf16 leaves, every parameter and state leaf within rtol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.optim import optimizers as jopt_mod
from repro_torch import convert, optim
from repro_torch.optim import optimizers as opt_mod

TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run torch's CPU ops on one thread: the suite runs
    files in parallel processes, and torch's default of a thread per
    core oversubscribes the machine (one test ran 7x slower for it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "h": [rng.standard_normal((3, 4)).astype(np.float32)]}


def _both(tree):
    j = jax.tree.map(jnp.asarray, tree)
    j["h"] = [j["h"][0].astype(jnp.bfloat16)]
    t = convert.to_torch(tree, "cpu")
    t["h"] = [t["h"][0].to(torch.bfloat16)]
    return j, t


def _close(got, want):
    gl = jax.tree.leaves(convert.to_numpy(got))
    wl = jax.tree.leaves(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                      want))
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g, w, **TOL)


SCHEDULES = {
    "constant": lambda m: m.constant(0.05),
    "linear_warmup": lambda m: m.linear_warmup(0.1, 3),
    "cosine_decay": lambda m: m.cosine_decay(0.1, 4, alpha=0.1),
    "warmup_cosine": lambda m: m.warmup_cosine(0.1, 2, 5),
}

OPTIMIZERS = {
    "sgd": lambda m, lr: m.sgd(lr),
    "momentum": lambda m, lr: m.momentum(lr, beta=0.8),
    "nesterov": lambda m, lr: m.momentum(lr, nesterov=True),
    "adam": lambda m, lr: m.adam(lr),
    "adamw": lambda m, lr: m.adamw(lr, weight_decay=0.1),
    "clip_adamw": lambda m, lr: m.chain(m.clip_by_global_norm(0.5),
                                        m.adamw(lr, weight_decay=0.1)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(name):
    fj, ft = SCHEDULES[name](jopt), SCHEDULES[name](optim)
    for step in range(8):
        np.testing.assert_allclose(
            float(ft(torch.tensor(step, dtype=torch.int32))),
            float(fj(jnp.int32(step))), **TOL)
        np.testing.assert_allclose(float(ft(step)), float(fj(step)), **TOL)


@pytest.mark.parametrize("lr", ["float", "schedule"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_match_reference_over_five_updates(name, lr):
    rng = np.random.default_rng(0)
    pj, pt = _both(_params(rng))
    if lr == "float":
        oj, ot = OPTIMIZERS[name](jopt, 0.05), OPTIMIZERS[name](optim, 0.05)
    else:
        oj = OPTIMIZERS[name](jopt, jopt.warmup_cosine(0.1, 2, 5))
        ot = OPTIMIZERS[name](optim, optim.warmup_cosine(0.1, 2, 5))
    sj, st = oj.init(pj), ot.init(pt)
    for _ in range(5):
        gj, gt = _both(_params(rng))
        uj, sj = oj.update(gj, sj, pj)
        ut, st = ot.update(gt, st, pt)
        pj = jopt_mod.apply_updates(pj, uj)
        pt = opt_mod.apply_updates(pt, ut)
        _close(ut, uj)
        _close(pt, pj)
        _close(st, sj)
    assert pt["h"][0].dtype == torch.bfloat16


def test_adamw_without_params_and_state_dtype():
    """update(params=None) decays nothing; the moments stay f32 for a
    bf16 leaf (the reference's default state dtype)."""
    rng = np.random.default_rng(1)
    pj, pt = _both(_params(rng))
    oj, ot = jopt.adamw(0.01, weight_decay=0.5), optim.adamw(0.01,
                                                            weight_decay=0.5)
    gj, gt = _both(_params(rng))
    uj, sj = oj.update(gj, oj.init(pj))
    ut, st = ot.update(gt, ot.init(pt))
    _close(ut, uj)
    assert st["m"]["h"][0].dtype == torch.float32
