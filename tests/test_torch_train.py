"""The port's training driver (`repro_torch.launch.train`) on the CPU,
with the reference's `_train_args` and `_tiny_cfg`
(tests/test_launchers.py): the chunk, log and checkpoint crossings of
the chunked loop, chunked against eager bit for bit, a streamed run
resumed from step 4 against the uninterrupted one, the driver started
from the reference's state against the reference's eager `run_afto`, the
refusals of `--mesh-workers`, and the CLI as a subprocess, unsharded and
over 2 gloo ranks (the mesh itself: tests/test_torch_train_mesh.py)."""
import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as jax_train
from repro_torch import convert
from repro_torch.launch import train
from repro_torch.models.config import BlockSpec, ModelConfig, Stage
from repro_torch.utils.tree import tree_leaves, tree_map

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run torch's CPU ops on one thread: the suite runs
    files in parallel processes, and torch's default of a thread per
    core oversubscribes the machine (one test ran 7x slower for it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_args(**overrides):
    """The reference's `_train_args` namespace, plus --device cpu."""
    base = dict(arch="xlstm-125m", reduced=True, mode="afto",
                engine="scan", cut_mode="sketch", sketch_r=32, steps=9,
                workers=2, batch=1, seq=17, lr=3e-3, tau=4, t_pre=4,
                t1=10_000, log_every=2, scan_chunk=6, mesh_workers=None,
                ckpt_dir=None, ckpt_every=5, seed=0, stream=False,
                device="cpu")
    base.update(overrides)
    return argparse.Namespace(**base)


def _tiny_cfg(block=BlockSpec, stage=Stage, config=ModelConfig):
    """The reference's `_tiny_cfg`: a 2-layer d_model=32 xLSTM."""
    m = block(mixer="mlstm", mlp="none")
    s = block(mixer="slstm", mlp="none")
    return config(name="xlstm-tiny", arch_type="ssm", n_layers=2,
                  d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
                  d_ff=0, vocab_size=128,
                  stages=(stage((m, s), 1),)).validate()


def _ckpt_steps(ckpt_dir):
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir))


def _run_scan(cfg, args):
    hyper, state, sched, val_loss = train._afto_setup(cfg, args)
    return train.run_afto_scan(cfg, args, hyper, state, sched, val_loss)


@pytest.fixture()
def stub_afto_step(monkeypatch):
    """Identity step / refresh and a constant validation loss: the chunk
    loop's boundary logic alone."""
    monkeypatch.setattr(train, "afto_llm_step",
                        lambda cfg, hyper, st, batch, mask: st)
    monkeypatch.setattr(train, "cut_refresh_llm",
                        lambda cfg, hyper, st, batch: st)

    def run(cfg, args):
        hyper, state, sched, _ = train._afto_setup(cfg, args)
        return train.run_afto_scan(cfg, args, hyper, state, sched,
                                   lambda w, tk: torch.tensor(0.125))
    return run


@pytest.mark.parametrize("stream", [False, True])
def test_chunk_larger_than_log_every_logs_once_per_crossing(
        stub_afto_step, tmp_path, stream):
    """chunk 6 > log_every 2: one log per chunk, the final partial chunk
    [6, 9) logs because stop == steps; ckpt_every 5 is crossed only in
    the first chunk, so one checkpoint, at step 6."""
    out = stub_afto_step(_tiny_cfg(), _train_args(
        steps=9, scan_chunk=6, log_every=2, stream=stream,
        ckpt_dir=str(tmp_path / "ck"), ckpt_every=5))
    assert [h["step"] for h in out["history"]] == [6, 9]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert _ckpt_steps(tmp_path / "ck") == [6]


@pytest.mark.parametrize("steps,chunk,log_every,want", [
    (9, 6, 10, [9]),        # the final partial chunk always logs
    (7, None, 3, [3, 6, 7]),  # the chunk defaults to log_every
])
def test_log_cadence(stub_afto_step, steps, chunk, log_every, want):
    out = stub_afto_step(_tiny_cfg(), _train_args(
        steps=steps, scan_chunk=chunk, log_every=log_every))
    assert [h["step"] for h in out["history"]] == want


def _states_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(la, lb))


def test_chunked_equals_eager_bitwise():
    """The chunked loop (chunks of 2 logging at 4 and 8) and the
    per-step loop run one step and refresh on the same host batches and
    masks: the same bits, the same history (two refreshes in 8
    steps)."""
    cfg = _tiny_cfg()
    kw = dict(steps=8, scan_chunk=2, log_every=4, t_pre=4)
    chunked = _run_scan(cfg, _train_args(**kw))
    eager = train.run_afto(cfg, _train_args(engine="eager", **kw))
    assert _states_equal(chunked["state"], eager["state"])
    strip = lambda h: [{k: v for k, v in r.items() if k != "host_s"}
                       for r in h]
    assert strip(chunked["history"]) == strip(eager["history"])
    assert chunked["history"][-1]["cuts"] >= 1


@pytest.fixture()
def mixing_afto_step(monkeypatch):
    """A cheap step that folds the batch into the state: a resume is
    bit for bit only if (state, key, cursor) all restore."""
    def step(cfg, hyper, st, batch, mask):
        s = sum(torch.sum(x.double()) for x in tree_leaves(batch))
        bump = float(s % 977.0) * 1e-4
        return tree_map(lambda x: x + bump if x.is_floating_point() else x,
                        st)

    monkeypatch.setattr(train, "afto_llm_step", step)
    monkeypatch.setattr(train, "cut_refresh_llm",
                        lambda cfg, hyper, st, batch: st)

    def run(cfg, args):
        hyper, state, sched, _ = train._afto_setup(cfg, args)
        return train.run_afto_scan(cfg, args, hyper, state, sched,
                                   lambda w, tk: torch.tensor(0.125))
    return run


def test_resume_after_restart_is_bitwise_identical(mixing_afto_step,
                                                   tmp_path):
    """Only the step-4 checkpoint survives; the run resumed from it
    writes a step-8 checkpoint bit for bit the uninterrupted run's."""
    full_dir, res_dir = tmp_path / "full", tmp_path / "resume"
    kw = dict(steps=8, scan_chunk=4, log_every=4, stream=True,
              ckpt_every=4)
    mixing_afto_step(_tiny_cfg(), _train_args(ckpt_dir=str(full_dir), **kw))
    assert _ckpt_steps(full_dir) == [4, 8]
    res_dir.mkdir()
    shutil.copytree(full_dir / "step_00000004", res_dir / "step_00000004")
    mixing_afto_step(_tiny_cfg(), _train_args(ckpt_dir=str(res_dir),
                                              resume=True, **kw))
    assert _ckpt_steps(res_dir) == [4, 8]
    a = np.load(full_dir / "step_00000008" / "arrays.npz")
    b = np.load(res_dir / "step_00000008" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k


def test_driver_matches_reference_eager_run():
    """From the reference's initial state (through `convert`), 4 eager
    steps with a refresh at step 4 (the reference's `_tiny_cfg`, bf16):
    history losses within rtol 1e-4, cut counts exact."""
    from repro.launch.train import run_afto as jax_run_afto
    from test_launchers import _tiny_cfg as jax_tiny_cfg

    kw = dict(engine="eager", steps=4, log_every=2, t_pre=4)
    jargs = _train_args(**kw)
    del jargs.device
    _, jstate, _, _ = jax_train._afto_setup(jax_tiny_cfg(), jargs)
    state = convert.fed_state_from_reference(
        jax.tree.map(np.asarray, jstate), "cpu")
    want = jax_run_afto(jax_tiny_cfg(), jargs)["history"]
    got = train.run_afto(_tiny_cfg(), _train_args(**kw),
                         state=state)["history"]
    assert [h["step"] for h in got] == [h["step"] for h in want] == [2, 4]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        assert g["cuts"] == w["cuts"]
        assert g["sim_time"] == w["sim_time"]


@pytest.mark.parametrize("overrides,match", [
    (dict(mesh_workers=2, engine="eager"), "--mesh-workers requires "
     "--engine scan"),
    (dict(mesh_workers=2, resume=True, ckpt_dir="unused"),
     "--resume with --mesh-workers is not supported"),
    (dict(mesh_workers=3, workers=4), "4 workers do not partition over 3 "
     "shards"),
    (dict(engine="eager", stream=True), "--stream requires --engine scan"),
], ids=["mesh-eager", "mesh-resume", "mesh-indivisible", "eager-stream"])
def test_mesh_workers_and_eager_stream_raise(overrides, match):
    """`--mesh-workers` runs (tests/test_torch_train_mesh.py); what it
    refuses, as the reference does (--engine eager, --resume), and N not
    a multiple of the shard count (the reference replicates such a state;
    fed/sharding.py); and --stream without --engine scan."""
    with pytest.raises(ValueError, match=match):
        train.run_afto(_tiny_cfg(), _train_args(**overrides))


@pytest.mark.parametrize("extra", [
    ("--workers", "2"),
    ("--workers", "4", "--mesh-workers", "2"),
], ids=["unsharded", "mesh-workers"])
def test_train_cli_on_the_cpu(tmp_path, extra):
    """The CLI, streamed with a checkpoint, and over 2 gloo ranks (rank 0
    writes the gathered checkpoint; the history lines come back)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--steps", "4", *extra, "--batch", "1",
         "--seq", "17", "--t-pre", "2", "--log-every", "2", "--stream",
         "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "4"],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.count('"loss"') == 2
    assert _ckpt_steps(tmp_path / "ck") == [4]
