"""Rank-side cases of `test_torch_train_mesh.py`, run by `spawn_mesh`.

Each rank imports this module and `repro_torch` only (no jax, no
reference package).  `run_cases(mesh, inputs)` runs every case on the
rank's shard and returns {case: result}, host values compared in the
pytest process against the port's unsharded functions, across ranks and
against the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.checkpoint import load_checkpoint
from repro_torch.data.synthetic import make_token_stream
from repro_torch.fed import sharding as shd
from repro_torch.fed import trilevel_llm as fed
from repro_torch.fed import trilevel_llm_sharded as tls
from repro_torch.launch import train
from repro_torch.models.config import (BlockSpec, ModelConfig, Stage,
                                       uniform_stages)
from repro_torch.utils import tree as tree_lib
from repro_torch.utils.tree import tree_leaves, tree_map

N, B, S = 4, 2, 17
# a planted state: step sizes small enough that the b-blocks' pull keeps
# the tiny models finite, two inner rounds so that the rollout VJPs sum
# over the mesh in a middle round
HYPER = dict(n_workers=N, sketch_r=32, p_max=2, k_inner=2, remat=False,
             eta_x=1e-4, eta_z=1e-4)
PLANTED_LAM, PLANTED_STALE_LAM = 2e-3, 1e-3


def tiny_cfg(name: str, dtype: str = "float32") -> ModelConfig:
    """`test_torch_train._tiny_cfg` (2-layer xLSTM) or
    `test_torch_trilevel_llm.tiny_dense_cfgs` (1-layer Llama-family),
    in `dtype`."""
    if name == "xlstm-tiny":
        m = BlockSpec(mixer="mlstm", mlp="none")
        s = BlockSpec(mixer="slstm", mlp="none")
        return ModelConfig(name="xlstm-tiny", arch_type="ssm", n_layers=2,
                           d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
                           d_ff=0, vocab_size=128, dtype=dtype,
                           stages=(Stage((m, s), 1),)).validate()
    return ModelConfig(name="llama-tiny", arch_type="dense", n_layers=1,
                       d_model=32, n_heads=2, n_kv_heads=2, d_head=16,
                       d_ff=64, vocab_size=128, dtype=dtype,
                       stages=uniform_stages(1, BlockSpec())).validate()


def widen(st):
    """X2 / z2 and the x2 blocks of the exact cuts in f32 (Queue 3 item
    16: bf16 perturbations round differently along different sums)."""
    cuts = {k: dataclasses.replace(getattr(st, k),
                                   a2=tree_map(lambda x: x.float(),
                                               getattr(st, k).a2),
                                   b2=tree_map(lambda x: x.float(),
                                               getattr(st, k).b2))
            for k in ("cuts", "cuts_i")}
    return dataclasses.replace(st, X2=st.X2.float(), z2=st.z2.float(),
                               **cuts)


def batch_of(cfg, seed=0):
    toks = torch.as_tensor(make_token_stream(cfg.vocab_size, N * B, S,
                                             seed=seed)).reshape(N, B, S)
    return {"tokens": toks, "val_tokens": toks}


def planted(cfg, hyper):
    """One refresh's cuts active in both polytopes, lam and stale_lam
    positive on them: every block of the step carries."""
    st = fed.init_fed_state(cfg, hyper, torch.Generator().manual_seed(0),
                            B, S - 1, device="cpu")
    st = widen(st)
    batch = batch_of(cfg)
    st = fed.afto_llm_step(cfg, hyper, st, batch, torch.ones(N))
    st = fed.cut_refresh_llm(cfg, hyper, st, batch)
    act = st.cuts.active
    return dataclasses.replace(
        st, lam=act * PLANTED_LAM,
        stale_lam=(act * PLANTED_STALE_LAM)[None].expand(N, -1).clone())


def rows(shard, tree):
    return tree_map(lambda x: x.narrow(0, shard.start, shard.n_local), tree)


def host(tree):
    return tree_map(lambda x: x.detach().cpu(), tree)


def replicated_digest(local) -> str:
    """sha256 of the leaves `llm_worker_specs` replicates."""
    h = hashlib.sha256()
    for (path, x) in tree_lib.tree_leaves_with_path(local):
        if shd._llm_worker_dim(path) is None:
            h.update(x.detach().cpu().contiguous().view(-1).view(
                torch.uint8).numpy().tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

STAGE_CASES = (("xlstm-tiny", "sketch"), ("xlstm-tiny", "exact"),
               ("llama-tiny", "sketch"), ("llama-tiny", "exact"),
               ("llama-tiny", "first-order"))


def stage_hyper(mode: str) -> fed.FedHyper:
    """A stage case's hyper: its cut mode, or sketch cuts with
    `first_order_cuts` ("first-order")."""
    if mode == "first-order":
        return fed.FedHyper(cut_mode="sketch", first_order_cuts=True, **HYPER)
    return fed.FedHyper(cut_mode=mode, **HYPER)
ACTIVE = (1.0, 0.0, 1.0, 1.0)


def case_stages(mesh, inp):
    """A sharded step then refresh from the planted state, against the
    unsharded ones, per (config, cut mode): the gathered states, the
    traffic, the replicated leaves' digest before the gather, and the
    layout's round trip."""
    out = {}
    for arch, mode in STAGE_CASES:
        cfg = tiny_cfg(arch)
        hyper = stage_hyper(mode)
        st = planted(cfg, hyper)
        batch = batch_of(cfg, seed=1)
        active = torch.tensor(ACTIVE)
        want_step = fed.afto_llm_step(cfg, hyper, st, batch, active)
        want = fed.cut_refresh_llm(cfg, hyper, want_step, batch)
        shard = tls.Shard(mesh, N)
        loc = shd.shard_fed_state(st, mesh.rank, mesh.size)
        roundtrip = shd.gather_fed_state(loc, mesh)
        mesh.reset_traffic()
        got_step = tls.afto_llm_step_sharded(shard, cfg, hyper, loc,
                                             rows(shard, batch),
                                             rows(shard, active))
        step_traffic = dict(mesh.traffic)
        mesh.reset_traffic()
        got = tls.cut_refresh_llm_sharded(shard, cfg, hyper, got_step,
                                          rows(shard, batch))
        refresh_traffic = dict(mesh.traffic)
        out[(arch, mode)] = dict(
            roundtrip_equal=all(torch.equal(a, b) for a, b in zip(
                tree_leaves(roundtrip), tree_leaves(st))),
            step=(host(shd.gather_fed_state(got_step, mesh)),
                  host(want_step)),
            refresh=(host(shd.gather_fed_state(got, mesh)), host(want)),
            step_traffic=step_traffic, refresh_traffic=refresh_traffic,
            digest=replicated_digest(got),
            cuts=(float(want.cuts.active.sum()),
                  float(want.cuts_i.active.sum())),
            lam=float(st.lam.sum()))
    return out


def case_vjps(mesh, inp):
    """The hand-assembled rollout VJPs on the mesh against `torch.func`
    through the unsharded rollouts (two inner rounds), from the planted
    llama-tiny state in sketch mode: d rollout3 / d(z1, Z2) and
    d rollout2 / d(z1, z3, X3), each shard's rows of the worker-stacked
    ones gathered."""
    cfg = tiny_cfg("llama-tiny")
    hyper = fed.FedHyper(cut_mode="sketch", **HYPER)
    st = planted(cfg, hyper)
    batch = batch_of(cfg, seed=2)
    # the I-cut violated by 1 at the state, and b2 columns on it
    ci = st.cuts_i
    viol = fed.eval_llm_cuts(hyper, ci, st.z1, st.z2, st.z3, st.X2, st.X3,
                             hyper.seed_i)
    b2 = torch.randn(ci.b2.shape, generator=torch.Generator().manual_seed(3))
    st = dataclasses.replace(st, cuts_i=dataclasses.replace(
        ci, c=ci.c + (viol - 1.0) * ci.active,
        b2=1e-2 * b2 * ci.active[:, None, None]))
    shard = tls.Shard(mesh, N)
    loc = shd.shard_fed_state(st, mesh.rank, mesh.size)
    lb = rows(shard, batch)
    g = torch.Generator().manual_seed(7)

    def like(x):
        return torch.randn(x.shape, generator=g, dtype=torch.float32
                           ).to(x.dtype)

    ct_X3, ct_z3 = tree_map(like, st.X3), tree_map(like, st.z3)
    ct_X2, ct_Z2 = like(st.X2), like(st.z2)

    # unsharded: torch.func through the port's own rollouts
    _, vjp3 = torch.func.vjp(
        lambda z1, Z2: fed._rollout3(cfg, hyper, z1, Z2, st.X3, st.z3,
                                     batch), st.z1, st.z2)
    want3 = vjp3((ct_X3, ct_z3))
    _, vjp2 = torch.func.vjp(
        lambda z1, z3, X3: fed._rollout2(cfg, hyper, z1, z3, st.X2, st.z2,
                                         X3, batch, st.cuts_i)[:2],
        st.z1, st.z3, st.X3)
    want2 = vjp2((ct_X2, ct_Z2))

    X3k, z3k, rounds3 = tls._rollout3(shard, cfg, hyper, loc.z1, loc.z2,
                                      loc.X3, loc.z3, lb, True)
    gz1, gZ2 = tls._rollout3_vjp(shard, hyper, rounds3, rows(shard, ct_X3),
                                 ct_z3, loc.z1, loc.z2)
    got3 = (gz1, shard.gather(gZ2, "vjp"))
    X2k, Z2k, gamma, rounds2 = tls._rollout2(
        shard, cfg, hyper, loc.z1, loc.z3, loc.X2, loc.z2, loc.X3, lb,
        loc.cuts_i, True)
    gz1b, gz3b, gX3b = tls._rollout2_vjp(shard, rounds2, rows(shard, ct_X2),
                                         rows(shard, ct_Z2), loc.z1, loc.z3,
                                         loc.X3, loc.cuts_i.c)
    got2 = (gz1b, gz3b, tree_map(lambda x: shard.gather(x, "vjp"), gX3b))
    return dict(vjp3=(host(got3), host(want3)), vjp2=(host(got2),
                                                     host(want2)),
                gamma_live=float(gamma.max()))


def driver_args(**kw) -> argparse.Namespace:
    """`test_torch_train._train_args` with N 4 over a 2-shard mesh."""
    base = dict(arch="xlstm-125m", reduced=True, mode="afto",
                engine="scan", cut_mode="sketch", sketch_r=32, steps=4,
                workers=N, batch=1, seq=17, lr=3e-3, tau=4, t_pre=2,
                t1=10_000, log_every=2, scan_chunk=2, mesh_workers=2,
                ckpt_dir=None, ckpt_every=5, seed=0,
                stream=False, resume=False, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def case_driver(mesh, inp):
    """The driver's rank entry (`run_afto_on_mesh`, what `--mesh-workers`
    runs in each rank): from the reference's initial state (bf16
    `_tiny_cfg`), host-fed; streamed, with the unsharded streamed run
    beside it on rank 0; and host-fed with a checkpoint every 2 steps,
    whose last checkpoint loads into the unsharded template.
    `inp["ref_state"]` is the reference's state through `convert`."""
    out = {}
    bf16 = tiny_cfg("xlstm-tiny", "bfloat16")
    res = train.run_afto_on_mesh(mesh, bf16, driver_args(),
                                 state=inp["ref_state"])
    out["reference"] = dict(history=res["history"],
                            digest=replicated_digest(res["state"]))
    f32 = tiny_cfg("xlstm-tiny")
    res = train.run_afto_on_mesh(mesh, f32, driver_args(stream=True))
    out["stream"] = dict(history=res["history"], state=host(res["state"]))
    if mesh.rank == 0:
        plain = train.run_afto(f32, driver_args(stream=True,
                                                mesh_workers=None))
        out["stream"]["unsharded"] = (plain["history"], host(plain["state"]))
    res = train.run_afto_on_mesh(mesh, f32, driver_args(
        ckpt_dir=inp["ckpt_dir"], ckpt_every=2))
    if mesh.rank == 0:
        hyper, template, _, _ = train._afto_setup(f32, driver_args(
            mesh_workers=None))
        loaded = load_checkpoint(inp["ckpt_dir"], {"state": template},
                                 step=4)["state"]
        out["ckpt"] = dict(loaded_equal=all(torch.equal(a, b) for a, b in zip(
            tree_leaves(loaded), tree_leaves(res["state"]))))
    return out


CASES = {"stages": case_stages, "vjps": case_vjps, "driver": case_driver}


def run_cases(mesh, inputs, names=tuple(CASES)):
    return {name: CASES[name](mesh, inputs) for name in names}
