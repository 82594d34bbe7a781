"""The port's LLM trilevel step and refresh (`repro_torch.fed.
trilevel_llm`) against the reference's, on the CPU.

Both packages start from the reference's `init_fed_state` (handed over as
numpy through `convert.fed_state_from_reference`) and the same numpy
token batch, at the reference's `tests/test_fed.py::_setup` (N = 4, B =
2, S = 32, reduced llama3-8b, sketch r 128, p_max 2, k_inner 1, remat
off) in both cut modes, and at the 2-layer xLSTM of
`tests/test_launchers.py::_tiny_cfg`, which puts the sLSTM loop under
second-order AD (in f32: the reference's `_tiny_cfg` is bf16, whose
rounding alone moves leaves by 4e-3); one step of a 2-layer hybrid
Mamba + MoE model.  step -> refresh -> step: every
state leaf within 1e-4 of that leaf's largest magnitude, cut `active`
and `age` exact, except four cut blocks (`COND_LEAVES`, ROADMAP.md
Queue 3 item 16), each held to its own limit for each case
(`COND_TOL`), about three times its reading on the CPU:

- cuts/b2, cuts/b3 and cuts_i/a2 are derivatives through the
  perturbation X2, which the reference keeps in bf16: each package
  rounds its own f32 gradients to bf16, and a flipped rounding moves
  these blocks by up to 1.5e-3 (llama3-8b, exact cuts).  With X2 held
  in f32 in both packages they are within 1e-4
  (`test_f32_perturbation_brings_the_x2_blocks_within_1e_4`).
- cuts_i/a3 is 2 eta_z sum_j (z3 - X3_j) one step in, a difference of
  numbers that agree to five digits, so one-ulp differences (XLA fuses
  multiply-adds) grow by about 1e4 (readings up to 1.9e-3).

Dropping the second-order terms (`first_order_cuts`) moves cuts/b3 and
cuts_i/a2 by 1.0 of their largest magnitude.

The reference side is jitted (op by op it takes minutes).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.data.synthetic import make_token_stream
from repro.fed import trilevel_llm as jax_fed
from repro.models.config import BlockSpec as JBlockSpec
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import Stage as JStage
from repro_torch import convert
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.fed import trilevel_llm as fed
from repro_torch.models.config import BlockSpec, ModelConfig, Stage
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path

N, B, S = 4, 2, 32
LEAF_TOL = 1e-4
EXACT_FIELDS = ("active", "age")
# the cut blocks of ROADMAP.md Queue 3 item 16: the limit of each, for
# each case, about 3x its reading on the CPU (in brackets)
COND_LEAVES = ("cuts/b2", "cuts/b3", "cuts_i/a2", "cuts_i/a3")
COND_TOL = {
    # [2.5e-4, 4.3e-4, 1.7e-4, 1.6e-4]
    ("llama3-8b", "sketch"): (1e-3, 1.5e-3, 1e-3, 1e-3),
    # [1.5e-3, 5.2e-4, 1.4e-3, 1.9e-3]
    ("llama3-8b", "exact"): (5e-3, 1.5e-3, 5e-3, 6e-3),
    # [4.1e-4, 2.8e-4, 2.0e-4, 4.4e-4]
    ("xlstm-tiny", "sketch"): (1.5e-3, 1e-3, 1e-3, 1.5e-3),
    # first-order cuts, workers 0, 2, 3 active: [1.8e-4, 0, 0, 6.1e-4]
    ("llama-tiny", "sketch"): (1e-3, LEAF_TOL, LEAF_TOL, 2e-3),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run torch's CPU ops on one thread: the suite runs
    files in parallel processes, and torch's default of a thread per
    core oversubscribes the machine (one test ran 7x slower for it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfgs():
    """The reference's `_tiny_cfg` (2 layers, d_model 32: an mLSTM and an
    sLSTM block) in both packages."""
    def build(block, stage, config):
        m = block(mixer="mlstm", mlp="none")
        s = block(mixer="slstm", mlp="none")
        return config(name="xlstm-tiny", arch_type="ssm", n_layers=2,
                      d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
                      d_ff=0, vocab_size=128,
                      stages=(stage((m, s), 1),)).validate()

    return (build(JBlockSpec, JStage, JModelConfig),
            build(BlockSpec, Stage, ModelConfig))


def tiny_dense_cfgs():
    """A 1-layer d_model=32 dense (Llama-family) model, f32, in both
    packages: the cases beyond `_setup`'s, at a fraction of the
    reference's compile time."""
    from repro.models.config import uniform_stages as j_uniform
    from repro_torch.models.config import uniform_stages

    def build(block, config, uniform):
        return config(name="llama-tiny", arch_type="dense", n_layers=1,
                      d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
                      d_ff=64, vocab_size=128, dtype="float32",
                      stages=uniform(1, block())).validate()

    return (build(JBlockSpec, JModelConfig, j_uniform),
            build(BlockSpec, ModelConfig, uniform_stages))


def tiny_hybrid_cfgs():
    """A 2-layer d_model=64 hybrid (Jamba-family) model, f32, in both
    packages: a Mamba + MoE block and an attention + dense block."""
    def build(block, stage, config):
        return config(name="hybrid-tiny", arch_type="hybrid", n_layers=2,
                      d_model=64, n_heads=2, n_kv_heads=2, d_head=32,
                      d_ff=64, vocab_size=128, n_experts=4, top_k=2,
                      ssm_d_state=8, ssm_chunk=16, dtype="float32",
                      stages=(stage((block(mixer="mamba", mlp="moe"),
                                     block()), 1),)).validate()

    return (build(JBlockSpec, JStage, JModelConfig),
            build(BlockSpec, Stage, ModelConfig))


def configs(arch):
    if arch == "hybrid-tiny":
        return tiny_hybrid_cfgs()
    if arch == "xlstm-tiny":
        return tuple(dataclasses.replace(c, dtype="float32")
                     for c in tiny_cfgs())
    if arch == "llama-tiny":
        return tiny_dense_cfgs()
    return jax_reduced(jax_get_config(arch)), reduced(get_config(arch))


def setup(arch="llama3-8b", cut_mode="sketch", **hyper_kw):
    """(cfg, port cfg, hyper, port hyper, reference state, port state,
    reference batch, port batch)."""
    jcfg, cfg = configs(arch)
    kw = dict(n_workers=N, cut_mode=cut_mode, sketch_r=128, p_max=2,
              k_inner=1, remat=False, **hyper_kw)
    jhyper, hyper = jax_fed.FedHyper(**kw), fed.FedHyper(**kw)
    jstate = jax_fed.init_fed_state(jcfg, jhyper, jax.random.PRNGKey(0),
                                    B, S)
    state = convert.fed_state_from_reference(
        jax.tree.map(np.asarray, jstate), "cpu")
    toks = make_token_stream(jcfg.vocab_size, N * B, S + 1) \
        .reshape(N, B, S + 1)
    jbatch = {"tokens": jnp.asarray(toks), "val_tokens": jnp.asarray(toks)}
    batch = {"tokens": torch.from_numpy(toks),
             "val_tokens": torch.from_numpy(toks)}
    return jcfg, cfg, jhyper, hyper, jstate, state, jbatch, batch


def run_reference(jcfg, jhyper, jstate, jbatch, active):
    step = jax.jit(lambda st, b, a: jax_fed.afto_llm_step(jcfg, jhyper, st,
                                                          b, a))
    refresh = jax.jit(lambda st, b: jax_fed.cut_refresh_llm(jcfg, jhyper,
                                                            st, b))
    a = jnp.asarray(active)
    st = step(jstate, jbatch, a)
    st = refresh(st, jbatch)
    return step(st, jbatch, a)


def run_port(cfg, hyper, state, batch, active):
    a = torch.as_tensor(active)
    st = fed.afto_llm_step(cfg, hyper, state, batch, a)
    st = fed.cut_refresh_llm(cfg, hyper, st, batch)
    return fed.afto_llm_step(cfg, hyper, st, batch, a)


def assert_states_close(got, want, cond_tol):
    """Every leaf of the port's state within LEAF_TOL of the leaf's
    largest magnitude in the reference's (COND_LEAVES[i] within
    cond_tol[i]); cut active / age exact."""
    paths = [p for p, _ in tree_leaves_with_path(got)]
    g_leaves = [np.asarray(convert.to_numpy(x), np.float64)
                for x in tree_leaves(got)]
    w_leaves = [np.asarray(x, np.float64) for x in jax.tree.leaves(
        jax.tree.map(lambda x: np.asarray(x, np.float32), want))]
    assert len(g_leaves) == len(w_leaves) == len(paths)
    for path, g, w in zip(paths, g_leaves, w_leaves):
        name = "/".join(str(e[0]) for e in path)
        assert g.shape == w.shape, name
        if path[-1][0] in EXACT_FIELDS:
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        scale = max(float(np.max(np.abs(w))), 1e-30) if w.size else 1.0
        err = float(np.max(np.abs(g - w))) / scale if w.size else 0.0
        tol = LEAF_TOL
        for block, limit in zip(COND_LEAVES, cond_tol):
            if name.startswith(block):
                tol = limit
        assert err <= tol, (name, err, tol)


@pytest.fixture(scope="module")
def llama_sketch():
    return setup("llama3-8b", "sketch")


@pytest.fixture(scope="module")
def llama_exact():
    return setup("llama3-8b", "exact")


@pytest.mark.parametrize("arch,cut_mode", [("llama3-8b", "sketch"),
                                           ("llama3-8b", "exact"),
                                           ("xlstm-tiny", "sketch")])
def test_step_refresh_step_matches_reference(arch, cut_mode, request):
    args = request.getfixturevalue("llama_" + cut_mode) \
        if arch == "llama3-8b" else setup(arch, cut_mode)
    jcfg, cfg, jhyper, hyper, jstate, state, jbatch, batch = args
    active = np.ones((N,), np.float32)
    want = run_reference(jcfg, jhyper, jstate, jbatch, active)
    got = run_port(cfg, hyper, state, batch, active)
    assert float(got.cuts.active.sum()) >= 1
    assert float(got.cuts_i.active.sum()) >= 1
    assert int(got.t) == 2
    assert_states_close(got, want, COND_TOL[(arch, cut_mode)])


def test_hybrid_mamba_moe_step_matches_reference():
    """One AFTO step of a hybrid Mamba + MoE model (the worker gradients
    through the scan, the routing and the capacity's drops under the
    step's vmap over workers): every state leaf within 1e-4 of its
    largest magnitude; the MoE aux loss is part of each worker's f1."""
    jcfg, cfg, jhyper, hyper, jstate, state, jbatch, batch = setup(
        "hybrid-tiny", "sketch")
    active = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
    want = jax.jit(lambda st, b, a: jax_fed.afto_llm_step(
        jcfg, jhyper, st, b, a))(jstate, jbatch, jnp.asarray(active))
    got = fed.afto_llm_step(cfg, hyper, state, batch,
                            torch.as_tensor(active))
    assert int(got.t) == 1
    assert_states_close(got, want, (LEAF_TOL,) * len(COND_LEAVES))
    moved = [not torch.equal(a, b) for a, b in
             zip(tree_leaves(state.X3), tree_leaves(got.X3))]
    assert all(moved)


def test_f32_perturbation_brings_the_x2_blocks_within_1e_4():
    """Queue 3 item 16's cause: with X2 / z2 (and the exact cut's x2
    blocks) in f32 in both packages, the blocks derived through X2 hold
    1e-4 too; only cuts_i/a3's cancellation keeps its own limit."""
    jcfg, cfg, jhyper, hyper, jstate, state, jbatch, batch = setup(
        "llama-tiny", "exact")

    def widen(st, cast):
        cuts = {k: dataclasses.replace(getattr(st, k),
                                       a2=cast(getattr(st, k).a2),
                                       b2=cast(getattr(st, k).b2))
                for k in ("cuts", "cuts_i")}
        return dataclasses.replace(st, X2=cast(st.X2), z2=cast(st.z2),
                                   **cuts)

    jstate = widen(jstate, lambda x: x.astype(jnp.float32))
    state = widen(state, lambda x: x.float())
    active = np.ones((N,), np.float32)
    want = run_reference(jcfg, jhyper, jstate, jbatch, active)
    got = run_port(cfg, hyper, state, batch, active)
    assert got.X2.dtype == torch.float32
    paths = ["/".join(str(e[0]) for e in p)
             for p, _ in tree_leaves_with_path(got)]
    for name, g, w in zip(paths, tree_leaves(got), jax.tree.leaves(want)):
        if name.startswith(("cuts/b2", "cuts/b3", "cuts_i/a2")):
            w = np.asarray(w, np.float64)
            err = np.max(np.abs(g.double().numpy() - w)) / np.max(np.abs(w))
            assert err <= LEAF_TOL, (name, err)


def test_first_order_cuts_match_reference():
    """first_order_cuts=True detaches the rollouts (the reference's
    stop_gradient) and still matches; it also differs from the
    second-order cuts, so the detach took effect."""
    jcfg, cfg, jhyper, hyper, jstate, state, jbatch, batch = setup(
        "llama-tiny", "sketch", first_order_cuts=True)
    active = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    want = run_reference(jcfg, jhyper, jstate, jbatch, active)
    got = run_port(cfg, hyper, state, batch, active)
    assert_states_close(got, want, COND_TOL[("llama-tiny", "sketch")])
    second = run_port(cfg, dataclasses.replace(hyper,
                                               first_order_cuts=False),
                      state, batch, active)
    assert not torch.equal(second.cuts.b3, got.cuts.b3)


def test_inactive_workers_frozen(llama_sketch):
    _, cfg, _, hyper, _, state, _, batch = llama_sketch
    active = torch.tensor([1.0, 0.0, 0.0, 1.0])
    new = fed.afto_llm_step(cfg, hyper, state, batch, active)
    for old, now in zip(tree_leaves(state.X3), tree_leaves(new.X3)):
        assert torch.equal(old[1], now[1]) and torch.equal(old[2], now[2])
        assert not torch.equal(old[0], now[0])


def test_sketch_vs_exact_cut_agreement(llama_sketch, llama_exact):
    """The reference's rule (tests/test_fed.py): from one initial state,
    the sketched cut's value at the active slot is within 50% of the
    exact cut's (JL distortion of the sketch)."""
    _, cfg, _, hyper_s, _, state_s, _, batch = llama_sketch
    _, _, _, hyper_e, _, state_e, _, _ = llama_exact
    state_s = fed.cut_refresh_llm(cfg, hyper_s, state_s, batch)
    state_e = fed.cut_refresh_llm(cfg, hyper_e, state_e, batch)
    vals = []
    for st, hy in ((state_s, hyper_s), (state_e, hyper_e)):
        v = fed.eval_llm_cuts(hy, st.cuts, st.z1, st.z2, st.z3, st.X2,
                              st.X3, hy.seed_ii)
        vals.append(float(v[int(torch.argmax(st.cuts.active))]))
    a_s, a_e = vals
    assert np.isfinite(a_s) and np.isfinite(a_e)
    if abs(a_e) > 1e-3:
        assert abs(a_s - a_e) / abs(a_e) < 0.5


def test_fed_state_checkpoint_roundtrip(tmp_path, llama_sketch):
    _, cfg, _, hyper, _, state, _, batch = llama_sketch
    state = fed.afto_llm_step(cfg, hyper, state, batch, torch.ones(N))
    save_checkpoint(str(tmp_path / "fed"), state, step=1)
    restored = load_checkpoint(str(tmp_path / "fed"), state)
    assert isinstance(restored, fed.FedLLMState)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(restored.t) == 1


def test_remat_under_torch_func_raises(llama_sketch):
    """Checkpointing cannot nest under torch.func: remat=True raises
    instead of being dropped."""
    _, cfg, _, hyper, _, state, _, batch = llama_sketch
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fed.afto_llm_step(cfg, dataclasses.replace(hyper, remat=True),
                          state, batch, torch.ones(N))
