"""`launch.train --mesh-workers` on the port: the federated LLM state
split over a worker mesh of gloo ranks on the CPU (`fed.sharding`'s
launcher layout, `fed.sketch`'s blocks, `fed.trilevel_llm_sharded`'s
step and refresh, the driver's rank entry), against the reference and
against the port's unsharded step, refresh and driver.

The ranks are processes started by `launch.mesh.spawn_mesh` that import
only `repro_torch` (`tests/torch_llm_mesh_ranks.py` holds their cases);
one 2-rank spawn runs them all, started with the module's first test,
while the reference runs here on its 8 fake CPU devices
(`tests/conftest.py`).  Tolerances are `tests/test_torch_sharded.py`'s:
STATE (rtol 5e-5, atol 1e-6) for states after a step, ROLLOUT (rtol
1e-5, atol 1e-6) for the refresh's cuts and the rollout VJPs, both on
f32 copies of the tiny configs with X2 / z2 in f32 (ROADMAP.md Queue 3
item 16: bf16 perturbations round differently along different sums);
the driver against the reference's `mesh_workers=2` run at
`test_torch_train.py`'s rtol 1e-4 on losses, cut counts exact.
"""
import dataclasses
import importlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.fed import trilevel_llm as jax_fed
from repro.launch import train as jax_train
from repro_torch import convert
from repro_torch.fed import sharding as shd
from repro_torch.fed import trilevel_llm as fed
from repro_torch.fed import trilevel_llm_sharded as tls
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path
from torch_llm_mesh_ranks import (HYPER, N, STAGE_CASES, driver_args,
                                  stage_hyper, tiny_cfg)

# `repro_torch.fed.sketch` the module (the package exports a function of
# that name)
sk = importlib.import_module("repro_torch.fed.sketch")
TESTS = Path(__file__).resolve().parent
STATE = dict(rtol=5e-5, atol=1e-6)
ROLLOUT = dict(rtol=1e-5, atol=1e-6)
SPAWN_TIMEOUT = 240.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread (the suite runs files in parallel
    processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tiny_cfg():
    from test_launchers import _tiny_cfg
    return _tiny_cfg()


def _jax_args(**kw):
    """The reference's `_train_args` namespace on a 2-device mesh."""
    args = driver_args(**kw)
    for k in ("device", "resume"):
        delattr(args, k)
    return args


_RANKS = {}


def _jax_setup():
    """The reference driver's (hyper, state, sched, val_loss), made once
    (its op-by-op init takes seconds)."""
    if "setup" not in _RANKS:
        _RANKS["setup"] = jax_train._afto_setup(_jax_tiny_cfg(), _jax_args())
    return _RANKS["setup"]


def _start(tmp_dir) -> None:
    """Start the module's one spawn (with the reference's initial state
    for the driver case and `tmp_dir` for its checkpoints)."""
    if "spawn" not in _RANKS:
        _, jstate, _, _ = _jax_setup()
        inputs = {"ref_state": convert.fed_state_from_reference(
            jax.tree.map(np.asarray, jstate), "cpu"),
            "ckpt_dir": str(tmp_dir)}
        _RANKS["ckpt_dir"] = str(tmp_dir)
        pool = ThreadPoolExecutor(1)
        _RANKS["spawn"] = pool.submit(
            mesh_lib.spawn_mesh, "torch_llm_mesh_ranks:run_cases", 2,
            device="cpu", args=(inputs,), pythonpath=[str(TESTS)],
            timeout=SPAWN_TIMEOUT)
        pool.shutdown(wait=False)


def ranks():
    """Both ranks' results of the module's spawn."""
    return _RANKS["spawn"].result(timeout=2 * SPAWN_TIMEOUT)


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """Start the spawn before the first test, so the ranks run while the
    reference compiles."""
    _start(tmp_path_factory.mktemp("mesh_ckpt"))


def _names(state):
    return [".".join(str(e[0]) for e in p)
            for p, _ in tree_leaves_with_path(state)]


def _assert_close(got, want, tol, skip=()):
    for name, g, w in zip(_names(want), tree_leaves(got), tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name.endswith(("active", "age", ".t")) or name == "t":
            assert torch.equal(g, w), name
        elif not name.startswith(skip):
            np.testing.assert_allclose(g.double().numpy(),
                                       w.double().numpy(), err_msg=name,
                                       **tol)


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

def _port_and_reference_states(cut_mode):
    kw = dict(HYPER, cut_mode=cut_mode)
    jhyper = jax_fed.FedHyper(**kw)
    jstate = jax_fed.init_fed_state(_jax_tiny_cfg(), jhyper,
                                    jax.random.PRNGKey(0), 2, 16)
    state = convert.fed_state_from_reference(
        jax.tree.map(np.asarray, jstate), "cpu")
    return jstate, state, fed.FedHyper(**kw)


@pytest.mark.parametrize("cut_mode", ["sketch", "exact"])
def test_layout_matches_reference_worker_mesh_put(cut_mode):
    """`llm_worker_specs` is the reference's `_worker_mesh_put` leaf for
    leaf (N 4 over 2 shards), and `shard_fed_state` cuts each leaf as
    its spec says."""
    jstate, state, _ = _port_and_reference_states(cut_mode)
    _, _, _, named = jax_train._worker_mesh_put(jstate, 2)
    want = [tuple(s.spec) for s in jax.tree.leaves(named)]
    specs = shd.spec_leaves(shd.llm_worker_specs(state, 2), state)
    assert specs == want
    assert ("data",) in specs and (None, "data") in specs and () in specs
    for w in range(2):
        local = tree_leaves(shd.shard_fed_state(state, w, 2))
        for spec, full, part in zip(specs, tree_leaves(state), local):
            if spec == ():
                assert part is full
            else:
                d = len(spec) - 1
                assert torch.equal(part, full.narrow(d, 2 * w, 2))


def _normalised(spec, mesh_shape):
    """A spec with size-1 axes dropped and no trailing Nones."""
    spec = [None if a is not None and shd.axis_size(a, mesh_shape) == 1
            else a for a in spec]
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


@pytest.mark.parametrize("cut_mode", ["sketch", "exact"])
def test_layout_against_dryrun_fed_state_specs(cut_mode):
    """`dryrun.fed_state_specs` names a "model" axis, so it needs a mesh
    that has one: on ("data",) alone it raises.  On ("data", "model") =
    (2, 1) it is the launcher's layout in sketch mode; in exact mode it
    also splits the a2 blocks' worker axis, which the reference's
    launcher replicates."""
    _, state, hyper = _port_and_reference_states(cut_mode)
    with pytest.raises(KeyError, match="model"):
        dryrun.fed_state_specs(state, AbstractMesh(("data",), (2,)), hyper)
    mesh = AbstractMesh(("data", "model"), (2, 1))
    counted = [_normalised(s, mesh.shape) for s in shd.spec_leaves(
        dryrun.fed_state_specs(state, mesh, hyper), state)]
    ours = shd.spec_leaves(shd.llm_worker_specs(state, 2), state)
    differ = sorted({n.split(".")[0] + "." + n.split(".")[1]
                     for n, a, b in zip(_names(state), counted, ours)
                     if a != b})
    assert differ == ([] if cut_mode == "sketch"
                      else ["cuts.a2", "cuts_i.a2"])


def test_indivisible_workers_are_refused():
    _, state, _ = _port_and_reference_states("sketch")
    for call in (lambda: shd.llm_worker_specs(state, 3),
                 lambda: shd.shard_fed_state(state, 0, 3),
                 lambda: tls.Shard(_FakeMesh(3), N)):
        with pytest.raises(ValueError, match="4 workers do not partition "
                           "over 3 shards"):
            call()


@pytest.mark.parametrize("device, n_ranks, cards, want", [
    ("cpu", 2, 0, "gloo"), ("cuda", 2, 4, "nccl"), ("cuda", 4, 4, "nccl"),
    ("cuda", 2, 1, "gloo")])
def test_mesh_backend_follows_the_cards(monkeypatch, device, n_ranks, cards,
                                        want):
    """`--mesh-workers` picks the process group itself: NCCL when every
    rank has a card of its own, gloo on the CPU or when ranks share one."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert train.mesh_backend(torch.device(device), n_ranks) == want


class _FakeMesh:
    """A mesh handle whose all-gather hands back `parts` (no process
    group)."""

    def __init__(self, size, parts=None):
        self.size, self.rank, self.member, self.parts = size, 0, True, parts

    def all_gather(self, x, label="gather"):
        return [x] + [p(x) for p in self.parts]


def test_gather_names_a_replicated_leaf_that_differs():
    _, state, _ = _port_and_reference_states("sketch")
    local = shd.shard_fed_state(state, 0, 2)
    same = shd.gather_fed_state(local, _FakeMesh(2, [lambda x: x]))
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(same), tree_leaves(shd.gather_fed_state(
            local, _FakeMesh(2, [lambda x: x])))))

    def flip_t(x):
        # the int32 leaves are the polytopes' ages, then t
        y = x.clone()
        if y.dtype == torch.int32:
            y[-1] += 1
        return y

    with pytest.raises(RuntimeError, match=r"\['t'\]"):
        shd.gather_fed_state(local, _FakeMesh(2, [flip_t]))


# ---------------------------------------------------------------------------
# sketches of blocks of rows
# ---------------------------------------------------------------------------

def test_block_sketches_sum_to_the_whole():
    """Blocks of z2's rows hashed at their global flat indices: their
    sketches sum to the whole's (f32 sums, the CPU's path), each block's
    lift is the whole lift's rows bit for bit, and at one fixed-point
    scale over the blocks (the card's path) the integer sums add up to
    the whole's bit for bit."""
    g = torch.Generator().manual_seed(0)
    z2 = torch.randn(4, 2, 16, 32, generator=g).to(torch.bfloat16)
    seed, r = 2, 64
    whole = sk.sketch_rows(z2, seed, r)
    parts = [sk.sketch_rows(z2[j:j + 2], seed, r, start=j) for j in (0, 2)]
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-6)
    coeff = torch.randn(r, generator=g)
    lift = sk.unsketch_rows(z2, coeff, seed)
    for j in (0, 2):
        assert torch.equal(sk.unsketch_rows(z2[j:j + 2], coeff, seed,
                                            start=j), lift[j:j + 2])
    scale, finite = sk.shared_scale(torch.cat(
        [sk.block_amax(z2[j:j + 2]) for j in (0, 2)]), z2.numel())
    finite = finite.all().reshape(1)
    want_scale, _ = sk._fixed_point_scale([z2.reshape(1, -1)])
    assert torch.equal(scale, want_scale)
    acc = sum(sk.fixed_point_sums(z2[j:j + 2], seed, r, j, scale, finite)
              for j in (0, 2))
    want = sk._fixed_sums([z2.reshape(1, -1)], sk.leaf_seeds(1, seed), [0],
                          r, scale, finite)[0]
    assert torch.equal(acc, want)
    np.testing.assert_allclose(sk.from_fixed_point(acc, scale, finite),
                               whole.numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="batch_dims"):
        sk.sketch_rows(z2, seed, r, batch_dims=1, start=2)


# ---------------------------------------------------------------------------
# the driver against the reference (first: its compile overlaps the ranks)
# ---------------------------------------------------------------------------

def test_two_rank_driver_matches_reference_mesh_run():
    """The port's 2-rank driver and the reference's in-process
    `run_afto_scan` with `mesh_workers=2` (GSPMD over 2 fake devices),
    both from the reference's initial state (the bf16 `_tiny_cfg`), 4
    iterations in chunks of 2 with a refresh every 2: history losses
    within rtol 1e-4, cut counts and sim_time exact."""
    hyper, jstate, sched, val_loss = _jax_setup()
    want = jax_train.run_afto_scan(_jax_tiny_cfg(), _jax_args(), hyper,
                                   jstate, sched, val_loss)["history"]
    got = ranks()[0]["driver"]["reference"]["history"]
    assert [h["step"] for h in got] == [h["step"] for h in want] == [2, 4]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        assert g["cuts"] == w["cuts"] >= 1
        assert g["sim_time"] == w["sim_time"]


# ---------------------------------------------------------------------------
# the step and the refresh on 2 ranks
# ---------------------------------------------------------------------------

def test_hand_assembled_rollout_vjps_match_torch_func():
    """d rollout3 / d(z1, Z2) and d rollout2 / d(z1, z3, X3) on 2 ranks,
    two inner rounds, against `torch.func` through the unsharded
    rollouts.  The I-cut is planted violated and with b2 columns (a
    refresh writes none), so its multiplier is live and moves X2: the
    summed gamma cotangent and z1's two channels all carry."""
    for r in ranks():
        res = r["vjps"]
        assert res["gamma_live"] > 0
        for key in ("vjp3", "vjp2"):
            got, want = res[key]
            for g, w in zip(tree_leaves(got), tree_leaves(want)):
                np.testing.assert_allclose(g.numpy(), w.numpy(), **ROLLOUT)


@pytest.mark.parametrize("case", STAGE_CASES, ids="-".join)
def test_sharded_step_and_refresh_match_unsharded(case):
    """From a planted state (one cut active in each polytope, lam and
    stale_lam positive: every b-block carries into the step), a sharded
    step then refresh, gathered, against `afto_llm_step` and
    `cut_refresh_llm`, in both cut modes and with `first_order_cuts`;
    the layout round trip is exact."""
    out = [r["stages"][case] for r in ranks()]
    res = out[0]
    assert res["roundtrip_equal"] and res["lam"] > 0
    assert res["cuts"][0] >= 1 and res["cuts"][1] >= 1
    _assert_close(*res["step"], STATE)
    _assert_close(*res["refresh"], ROLLOUT)


@pytest.mark.parametrize("case", STAGE_CASES, ids="-".join)
def test_all_reduced_bytes_equal_llm_traffic(case):
    """Each rank's bytes by label, step and refresh, equal the count;
    for xLSTM-125M the refresh is one z3-sized f32 sum (264 MB) and the
    step under 1 MB."""
    arch, mode = case
    hyper = stage_hyper(mode)
    rec = tls.llm_traffic(tiny_cfg(arch), hyper, 2, 2, 17,
                          x2_dtype=torch.float32)
    for r in ranks():
        res = r["stages"][case]
        assert res["step_traffic"] == {"step": rec["step_bytes"]}
        assert res["refresh_traffic"] == {"refresh": rec["refresh_bytes"]}
    from repro_torch.configs import get_config
    big = tls.llm_traffic(get_config("xlstm-125m"), dataclasses.replace(
        hyper, k_inner=1, sketch_r=256), 2, 2, 129)
    assert big["refresh_terms"]["rollout3 forward"] == 4 * big["z3_elements"]
    assert 250e6 < big["refresh_terms"]["rollout3 forward"] < 280e6
    assert big["refresh_terms"]["rollout3 forward"] \
        > 0.98 * big["refresh_bytes"]
    assert big["step_bytes"] < 1e6


def test_replicated_leaves_bitwise_equal_across_ranks():
    out = ranks()
    for case in STAGE_CASES:
        assert out[0]["stages"][case]["digest"] == \
            out[1]["stages"][case]["digest"]
    assert out[0]["driver"]["reference"]["digest"] == \
        out[1]["driver"]["reference"]["digest"]


# ---------------------------------------------------------------------------
# the driver's other runs
# ---------------------------------------------------------------------------

def test_streamed_sharded_run_matches_streamed_unsharded():
    """Each rank draws its own workers' rows of the stream: the 2-rank
    streamed run against the unsharded streamed run of the same driver
    arguments (f32 tiny xLSTM), state at STATE, losses at rtol 1e-4."""
    res = ranks()[0]["driver"]["stream"]
    hist, state = res["unsharded"]
    _assert_close(res["state"], state, STATE)
    for g, w in zip(res["history"], hist):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        assert g["cuts"] == w["cuts"] and g["step"] == w["step"]


def test_sharded_checkpoint_loads_into_an_unsharded_driver(tmp_path):
    """The 2-rank run's step-4 checkpoint (the gathered global state,
    written by rank 0) loads into the unsharded template bit for bit,
    and the unsharded driver resumes from it."""
    out = ranks()
    assert out[0]["driver"]["ckpt"]["loaded_equal"]
    args = driver_args(mesh_workers=None, steps=6, ckpt_dir=_RANKS["ckpt_dir"],
                       ckpt_every=2, resume=True)
    res = train.run_afto(tiny_cfg("xlstm-tiny"), args)
    assert [h["step"] for h in res["history"]] == [6]
    assert np.isfinite(res["history"][0]["loss"])
