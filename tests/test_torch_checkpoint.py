"""The port's checkpoints (`repro_torch.checkpoint`) on the CPU, and
checkpoint files crossing between the port and the reference.

The reference's cases (tests/test_checkpoint_io.py:35-118) on the port:
array-dict round trips, retention, and `CheckpointError` for a missing
checkpoint or step, a flipped byte, a torn write, an unreadable manifest
and a template-format file.  Across packages, in both directions: array
dicts with their crc32 checked, bf16 leaves, leaf order of unsorted dict
keys, and a quickstart `AFTOState` taken after cuts were added, loaded
bitwise and continued, the continuations within the reference's
`_assert_trees_close` tolerance (rtol 1e-4, atol 1e-6), cut counts
exact.  Kill/resume through `chunk_hook` checkpoints is bitwise, streamed
and not.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from conftest import make_hyper, make_straggler_cfg
from repro.checkpoint import io as jax_io
from repro.core import StragglerScheduler as JaxScheduler
from repro.core import afto as jax_afto
from repro.core import run_scanned as jax_run_scanned
from repro_torch.checkpoint import (CheckpointError, latest_step,
                                    load_array_dict, load_checkpoint,
                                    save_array_dict, save_checkpoint)
from repro_torch.core import (RunSpec, Schedule, StragglerConfig,
                              StragglerScheduler, afto, run, run_scanned)
from repro_torch.data import stream as stream_lib
from repro_torch.utils.tree import tree_leaves
from test_torch_core import assert_states_close, port_hyper, quad_problems

CROSS = dict(rtol=1e-4, atol=1e-6)


def _sample():
    return {
        "f32": np.arange(12, dtype=np.float32).reshape(3, 4),
        "i64": np.array([1, -2, 3], np.int64),
        "bools": np.array([True, False, True]),
        "scalar": np.asarray(7, np.int64),
        "empty_hist": np.zeros((0, 4), np.float32),
    }


def _assert_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == v.dtype, k


def _leaves(x):
    return tree_leaves(x)


def _assert_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# array dicts: the reference's cases on the port
# ---------------------------------------------------------------------------

def test_array_dict_round_trip(tmp_path):
    d = os.fspath(tmp_path / "ck")
    path = save_array_dict(d, _sample(), step=3)
    assert path.endswith("step_00000003")
    _assert_dicts_equal(load_array_dict(d), _sample())
    # tensors are taken too, and come back as numpy
    save_array_dict(d, {"t": torch.arange(4, dtype=torch.int32)}, step=4)
    np.testing.assert_array_equal(load_array_dict(d)["t"],
                                  np.arange(4, dtype=np.int32))


def test_array_dict_steps_and_retention(tmp_path):
    d = os.fspath(tmp_path / "ck")
    for step in (1, 2, 3, 4, 5):
        save_array_dict(d, {"x": np.full(2, step)}, step=step, keep=3)
    assert latest_step(d) == 5
    assert sorted(os.listdir(d)) == [f"step_0000000{s}" for s in (3, 4, 5)]
    np.testing.assert_array_equal(load_array_dict(d, step=4)["x"], [4, 4])
    np.testing.assert_array_equal(load_array_dict(d)["x"], [5, 5])


def _corrupt(path, how):
    npz = os.path.join(path, "arrays.npz")
    blob = bytearray(open(npz, "rb").read())
    if how == "flip":
        blob[len(blob) // 2] ^= 0xFF
    else:
        blob = blob[: len(blob) // 2]
    with open(npz, "wb") as f:
        f.write(blob)


@pytest.mark.parametrize("case,match", [
    ("missing", "no checkpoints"),
    ("missing_step", "step 7"),
    ("flip", "checksum"),
    ("truncate", "checksum"),
    ("manifest", "manifest"),
    ("template", "load_checkpoint"),
])
def test_array_dict_faults_raise(tmp_path, case, match):
    d = os.fspath(tmp_path / "ck")
    if case == "template":
        save_checkpoint(d, {"w": np.zeros(3)}, step=1)
    elif case != "missing":
        path = save_array_dict(d, _sample(), step=1)
        if case in ("flip", "truncate"):
            _corrupt(path, case)
        elif case == "manifest":
            with open(os.path.join(path, "manifest.json"), "w") as f:
                f.write("{not json")
    with pytest.raises(CheckpointError, match=match):
        load_array_dict(d, step=7 if case == "missing_step" else None)


def test_first_save_into_a_new_directory(tmp_path):
    """The directory is made before the temporary one, which therefore
    lies beside the target and leaves nothing behind."""
    for i, save in enumerate((save_array_dict, save_checkpoint)):
        d = os.fspath(tmp_path / f"new{i}" / "nested" / "ck")
        assert not os.path.exists(d)
        save(d, {"x": np.arange(3)}, step=2)
        assert os.listdir(d) == ["step_00000002"]


def test_template_checkpoint_faults_raise(tmp_path):
    d = os.fspath(tmp_path / "ck")
    with pytest.raises(CheckpointError, match="no checkpoints"):
        load_checkpoint(d, {"w": np.zeros(3)})
    save_checkpoint(d, {"w": np.zeros(3)}, step=1)
    with pytest.raises(CheckpointError, match="shape"):
        load_checkpoint(d, {"w": np.zeros(4)})
    with pytest.raises(CheckpointError, match="leaves"):
        load_checkpoint(d, {"w": np.zeros(3), "v": np.zeros(1)})
    save_array_dict(d, {"w": np.zeros(3)}, step=2)
    with pytest.raises(CheckpointError, match="load_array_dict"):
        load_checkpoint(d, {"w": np.zeros(3)})


# ---------------------------------------------------------------------------
# files across packages
# ---------------------------------------------------------------------------

def test_array_dicts_cross_both_ways(tmp_path):
    d = os.fspath(tmp_path / "ck")
    save_array_dict(d, _sample(), step=1)
    _assert_dicts_equal(jax_io.load_array_dict(d), _sample())
    jax_io.save_array_dict(d, _sample(), step=2)
    _assert_dicts_equal(load_array_dict(d), _sample())
    # the port checks the reference's crc32 too
    _corrupt(os.path.join(d, "step_00000002"), "flip")
    with pytest.raises(CheckpointError, match="checksum"):
        load_array_dict(d)


def test_bf16_and_leaf_order_cross_both_ways(tmp_path):
    """bf16 is stored as f32 and restored bitwise; dict keys inserted out
    of order number their leaves in sorted order, as the reference's."""
    vals = np.random.default_rng(0).normal(size=(5,)).astype(np.float32)
    w16 = torch.tensor(vals).to(torch.bfloat16)
    tree = {"w0": w16, "b0": torch.arange(2.0), "w1": torch.ones(3),
            "b1": {"z": torch.zeros(1), "a": torch.full((2,), 2.0)}}
    d = os.fspath(tmp_path / "port")
    save_checkpoint(d, tree, step=1)
    template = pytree.tree_map(torch.zeros_like, tree)
    got = load_checkpoint(d, template)
    _assert_equal(got, tree)
    ref = jax_io.load_checkpoint(d, jax.tree.map(
        lambda x: jnp.zeros(x.shape, jnp.bfloat16 if x.dtype ==
                            torch.bfloat16 else jnp.float32), tree))
    assert ref["w0"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(ref["w0"]).view(np.uint16),
        w16.view(torch.int16).numpy().view(np.uint16))
    for path in (("b0",), ("w1",), ("b1", "z"), ("b1", "a")):
        a, b = ref, tree
        for k in path:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # and back: the reference's bf16 into the port's template
    d2 = os.fspath(tmp_path / "ref")
    jax_io.save_checkpoint(d2, {"w0": jnp.asarray(vals.astype(
        ml_dtypes.bfloat16)), "b0": jnp.arange(2.0)}, step=1)
    back = load_checkpoint(d2, {"w0": torch.zeros(5, dtype=torch.bfloat16),
                                "b0": torch.zeros(2)})
    assert torch.equal(back["w0"], w16)


def _port_schedule(schedule):
    return Schedule(active=schedule.active, sim_time=schedule.sim_time,
                    max_staleness=schedule.max_staleness)


def test_state_checkpoints_cross_both_ways(tmp_path):
    """A quickstart state after 10 iterations (two refreshes: live cuts):
    the reference's file loads into the port's `init_state` template
    bitwise and the port's into the reference's; the port's continuation
    from the reference's file matches the reference's continuation, and
    the reference's from the port's file is its own, bit for bit."""
    jp, tp = quad_problems()
    jh, ph = make_hyper(), port_hyper()
    sched = JaxScheduler(make_straggler_cfg()).precompute(20)
    jst = jax_run_scanned(jp, jh, sched.slice(0, 10), metrics_every=10) \
        .state
    assert float(np.asarray(jst.cuts_i.active).sum()) >= 1
    want = jax_run_scanned(jp, jh, sched.slice(10, 20), metrics_every=5,
                           state=jst)

    d = os.fspath(tmp_path / "ref")
    jax_io.save_checkpoint(d, jst, step=10)
    loaded = load_checkpoint(d, afto.init_state(tp, ph))
    assert_states_close(loaded, jst, rtol=0, atol=0)
    got = run_scanned(tp, ph, _port_schedule(sched.slice(10, 20)),
                      metrics_every=5, state=loaded)
    assert_states_close(got.state, want.state, **CROSS)
    for k in ("n_cuts_i", "n_cuts_ii"):
        assert list(got.history[k]) == list(np.asarray(want.history[k]))

    d2 = os.fspath(tmp_path / "port")
    save_checkpoint(d2, loaded, step=10)
    ref_loaded = jax_io.load_checkpoint(d2, jax_afto.init_state(jp, jh))
    for a, b in zip(jax.tree.leaves(ref_loaded), jax.tree.leaves(jst)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    again = jax_run_scanned(jp, jh, sched.slice(10, 20), metrics_every=5,
                            state=ref_loaded)
    for a, b in zip(jax.tree.leaves(again.state),
                    jax.tree.leaves(want.state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# kill and resume through chunk_hook checkpoints
# ---------------------------------------------------------------------------

def _sampler(key, device):
    g = stream_lib.generator(key, device)
    return {"A": torch.randn((3, 3), generator=g, device=device) * 0.3,
            "b": torch.randn((3,), generator=g, device=device)}


@pytest.mark.parametrize("streamed", [True, False])
def test_kill_and_resume_is_bitwise(tmp_path, streamed):
    """A run checkpoints every 7 iterations through `chunk_hook` and is
    killed after iteration 14; a fresh template loaded from step 14 and
    run to 20 ends in the uninterrupted run's state, with its history
    rows, bit for bit."""
    _, tp = quad_problems()
    hyper = port_hyper(t_pre=3)
    data = stream_lib.make_stream(_sampler, 4, 5) if streamed else None
    sched = StragglerScheduler(StragglerConfig(
        n_workers=4, s_active=3, tau=5, n_stragglers=1, seed=2)) \
        .precompute(20)
    spec = RunSpec(problem=tp, hyper=hyper, schedule=sched, metrics_every=1,
                   data=data, device="cpu")
    full = run(spec)
    d = os.fspath(tmp_path / "ck")

    class Killed(Exception):
        pass

    def hook(state, t):
        save_checkpoint(d, state, step=int(state.t))
        if t == 14:
            raise Killed

    with pytest.raises(Killed):
        run(dataclasses.replace(spec, chunk_size=7, chunk_hook=hook))
    assert latest_step(d) == 14 and sorted(os.listdir(d)) == [
        "step_00000007", "step_00000014"]
    state = load_checkpoint(d, afto.init_state(tp, hyper))
    rest = run(dataclasses.replace(spec, schedule=sched.slice(14, 20),
                                   state=state))
    _assert_equal(rest.state, full.state)
    for k, v in rest.history.items():
        if k not in ("t", "host_time"):
            np.testing.assert_array_equal(v, full.history[k][14:], err_msg=k)
