"""Multi-pod dry-run on the meta device: every (architecture x input
shape x mesh) step traced with shape-only tensors (nothing allocated),
its per-device memory counted and its roofline terms extracted.

Counterpart of `repro/launch/dryrun.py`, which lowers and compiles each
step for 512 fake XLA devices.  PyTorch has no single-program SPMD, so
the port counts what one device of the mesh runs, the local program:

  * the batch is split over the data axes: `pod x data` for the worker
    stack, each device holding N / (pod x data) workers and their
    per-worker batches, and a (B, ...) batch or cache split where the
    specs shard it;
  * every dimension that the specs (`fed.sharding.param_specs`,
    `cache_specs`, `fed_state_specs`) shard over "model" is divided
    (heads, d_ff, experts, vocab, d_inner); a dimension they replicate
    stays whole.  Three leaves keep a whole dimension in the local
    compute because the math needs it whole there: the MoE router (its
    logits are gathered over the model axis, and a device's experts
    take the capacity of all E experts, `moe.dispatch`'s `held`); the
    AFTO perturbation X2 / z2 and its exact cut blocks, which add to the
    (whole-width) embeddings; and GQA key / value heads that the specs
    replicate while they shard the query heads (Llama's 8 KV heads on a
    16-way axis): a device computes only the KV heads its own query
    heads group over, ceil(H_local / (H / Hkv)) of them;
  * argument bytes come from the specs alone: each leaf's bytes over the
    sizes of the axes that shard it (`fed.sharding.local_bytes`);
  * temp, FLOPs and bytes come from tracing the local program on meta
    tensors under `launch.roofline.Counter`; the collective term is
    `roofline.collective_schedule`.

On a 1 x 1 mesh the local program is the whole step, which
`chip_smoke.py` phase 18 holds against the card's measured peaks.

Branches on the device type: `fed/sketch.py _accumulate` sums a
sketch in 64-bit fixed point (int64 buckets, f64 products a slice at a
time) on the card and in f32 on the CPU; meta tensors take the card's
path.  `--route kernel` (the default) runs prefill's attention and mLSTM
chunks through the hand-written kernels' meta branch, as the card does:
the kernel's output is its only allocation and its FLOPs are its own
count; `--route ref` runs the plain math (`--attn-impl naive|chunked`).
Training always runs the plain math, as on the card, and decode is plain
torch.  One count differs from a shard's: `prefill` builds its blank
Mamba caches at the whole d_inner (the config cannot say a shard's; they
are dropped for the recurrent states at once).

The fed steps run with `remat=False`: checkpointing cannot nest under
`torch.func` (`models.transformer`), so the port's temp is larger than
the reference's `remat=True` compile; each row records `remat`.  The
reference's `--layer-mode` chose between XLA's unrolled and scanned
layer loops; the port's layer loop is a Python loop, so there is
nothing to choose.

Usage (any machine, no card):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod \\
      --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, DRYRUN_SKIPS, INPUT_SHAPES,
                                 get_config, get_shape)
from repro_torch.configs.shapes import InputShape
from repro_torch.fed import sharding as shd
from repro_torch.fed.trilevel_llm import (FedHyper, afto_llm_step,
                                          cut_refresh_llm, init_fed_state,
                                          plain_train_step)
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.config import (ModelConfig, active_param_count,
                                       step_flops)
from repro_torch.optim import adamw
from repro_torch.utils.tree import (DictKey, GetAttrKey, tree_flatten,
                                    tree_leaves_with_path, tree_unflatten)

META = torch.device("meta")
STEP_KINDS = ("afto_train", "afto_scan", "plain_train", "prefill", "decode",
              "cut_refresh")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _n_workers(mesh) -> int:
    shape = mesh.shape
    return shape.get("pod", 1) * shape["data"]


# ---------------------------------------------------------------------------
# shape stand-ins and specs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: InputShape, n: int,
                fed: bool) -> Dict[str, torch.Tensor]:
    """Meta stand-ins for every model input; `n` workers when `fed`."""
    out: Dict[str, torch.Tensor] = {}
    frames = (cfg.encoder_seq, cfg.d_model)
    if shape.kind == "train":
        if fed:
            b = max(1, shape.global_batch // n)
            out["tokens"] = _meta((n, b, shape.seq_len), torch.int32)
            out["val_tokens"] = _meta((n, b, shape.seq_len), torch.int32)
            if cfg.frontend == "frames":
                out["frames"] = _meta((n, b) + frames, torch.bfloat16)
                out["val_frames"] = _meta((n, b) + frames, torch.bfloat16)
        else:
            out["tokens"] = _meta((shape.global_batch, shape.seq_len),
                                  torch.int32)
            if cfg.frontend == "frames":
                out["frames"] = _meta((shape.global_batch,) + frames,
                                      torch.bfloat16)
    elif shape.kind == "prefill":
        out["tokens"] = _meta((shape.global_batch, shape.seq_len),
                              torch.int32)
        if cfg.frontend == "frames":
            out["frames"] = _meta((shape.global_batch,) + frames,
                                  torch.bfloat16)
    else:  # decode: ONE new token against a seq_len KV cache
        out["tokens"] = _meta((shape.global_batch, 1), torch.int32)
        out["cur_pos"] = _meta((shape.global_batch,), torch.int32)
    return out


def _safe(spec: Tuple, shape, mesh) -> Tuple:
    """Drop axis names from dims they don't divide."""
    ms = mesh.shape
    return tuple(None if ax is None or shape[i] % shd.axis_size(ax, ms)
                 else ax for i, ax in enumerate(spec))


def _lead_specs(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, Tuple]:
    ax = shd.data_axis(mesh)
    return {k: _safe((ax,) + (None,) * (v.dim() - 1), v.shape, mesh)
            for k, v in batch.items()}


def fed_state_specs(state, mesh, hyper: FedHyper,
                    head_dim_fallback: bool = False):
    """The spec tree of a `FedLLMState` (a `FedLLMState` of specs)."""
    ax = shd.data_axis(mesh)

    def pspecs(tree, **kw):
        return shd.param_specs(tree, mesh,
                               shard_head_dim_fallback=head_dim_fallback,
                               **kw)

    def cutset_specs(cs):
        if hyper.cut_mode == "sketch":
            a2 = _safe((None, None), cs.a2.shape, mesh)
            a3 = _safe((None, None), cs.a3.shape, mesh)
            b2 = _safe((None, ax, None), cs.b2.shape, mesh)
            b3 = _safe((None, ax, None), cs.b3.shape, mesh)
        else:
            a2 = _safe((None, ax, None, None, "model"), cs.a2.shape, mesh)
            a3 = pspecs(cs.a3, stack_axes=(None,))
            b2 = _safe((None, ax, None, None, "model"), cs.b2.shape, mesh)
            b3 = pspecs(cs.b3, stack_axes=(None, ax))
        return dataclasses.replace(
            cs, a1=(None, None), a2=a2, a3=a3, b2=b2, b3=b3,
            c=(None,), active=(None,), age=(None,))

    x2_spec = _safe((ax, None, None, "model"), state.X2.shape, mesh)
    return dataclasses.replace(
        state,
        X1=(ax, None),
        X2=x2_spec,
        X3=pspecs(state.X3, stack_axes=(ax,)),
        z1=(None,),
        z2=x2_spec,
        z3=pspecs(state.z3),
        theta=(ax, None), lam=(None,),
        cuts=cutset_specs(state.cuts),
        cuts_i=cutset_specs(state.cuts_i),
        gamma_k=(None,),
        stale_lam=_safe((ax, None), state.stale_lam.shape, mesh),
        stale_theta=(ax, None),
        t=())


# ---------------------------------------------------------------------------
# the local program
# ---------------------------------------------------------------------------

def local_config(cfg: ModelConfig, mesh, head_dim_fallback: bool = False
                 ) -> ModelConfig:
    """The config one device computes with: query heads, KV heads and
    head dim as the specs split them over "model" (KV heads replicated
    beside split query heads: the groups of the device's own query
    heads)."""
    m = mesh.shape.get("model", 1)
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h_loc = h // m if h % m == 0 else h
    if hkv % m == 0:
        kv_loc = hkv // m
    elif h % m == 0:
        kv_loc = -(-h_loc // (h // hkv))
    else:
        kv_loc = hkv
    hd_loc = hd // m if head_dim_fallback and h % m and hd % m == 0 else hd
    return dataclasses.replace(cfg, n_heads=h_loc, n_kv_heads=kv_loc,
                               d_head=hd_loc)


# leaves that keep "model" dims whole in the local compute (see the
# module docstring)
_WHOLE = {"router", "X2", "z2", "a2", "b2"}
# attention key / value leaves whose head dim (second to last) is the
# local config's KV heads
_KV_PARAMS = {"wk", "wv", "xwk", "xwv"}
_KV_CACHES = {"k", "v", "xk", "xv"}


def _path_names(path):
    return [str(e.key) if isinstance(e, DictKey) else str(e.name)
            for e in path if isinstance(e, (DictKey, GetAttrKey))]


def localize(tree, specs, mesh, local_cfg: ModelConfig, caches=False):
    """Meta tensors of one device's compute shapes for a global `tree`
    laid out by `specs`."""
    ms = mesh.shape
    out = []
    for (path, x), spec in zip(tree_leaves_with_path(tree),
                               shd.spec_leaves(specs, tree)):
        names = _path_names(path)
        name = names[-1] if names else ""
        if name in _WHOLE:
            spec = tuple(None if a == "model" else a for a in spec)
        shape = list(shd.local_shape(x.shape, spec, ms))
        if (name in _KV_PARAMS and "attn" in names) or \
                (caches and name in _KV_CACHES):
            shape[-2] = local_cfg.n_kv_heads
        out.append(_meta(shape, x.dtype))
    return tree_unflatten(tree_flatten(tree)[1], out)


@dataclasses.dataclass
class Built:
    """A step to trace: fn(*local_args); `args` are the global meta
    trees, `specs` their layout, `caches` the indices of the args that
    are decode caches."""
    fn: Any
    args: Tuple
    specs: Tuple
    caches: Tuple = ()


def _global_params(cfg: ModelConfig):
    return tfm.init_params(cfg, torch.Generator(), device=META)


def build_train(cfg: ModelConfig, shape: InputShape, mesh, hyper: FedHyper,
                step: str, local: Tuple[ModelConfig, FedHyper],
                head_dim_fallback: bool = False) -> Built:
    n = hyper.n_workers
    b_local = max(1, shape.global_batch // n)
    batch = input_specs(cfg, shape, n, fed=True)
    state = init_fed_state(cfg, hyper, torch.Generator(), b_local,
                           shape.seq_len - 1, device=META)
    state_specs = fed_state_specs(state, mesh, hyper, head_dim_fallback)
    batch_specs = _lead_specs(batch, mesh)
    lcfg, lhyper = local
    if step == "cut_refresh":
        return Built(lambda s, bt: cut_refresh_llm(lcfg, lhyper, s, bt),
                     (state, batch), (state_specs, batch_specs))
    active = _meta((n,), torch.float32)
    return Built(lambda s, bt, a: afto_llm_step(lcfg, lhyper, s, bt, a),
                 (state, batch, active),
                 (state_specs, batch_specs, _lead_specs({"a": active},
                                                        mesh)["a"]))


def build_train_scan(cfg: ModelConfig, shape: InputShape, mesh,
                     hyper: FedHyper, local, chunk: int, t_pre: int = 2,
                     head_dim_fallback: bool = False) -> Built:
    """A `chunk`-iteration slice of the trajectory: `afto_llm_step` each
    iteration and `cut_refresh_llm` after every `t_pre`-th, as a host
    loop (the reference's `lax.scan` with the refresh under `lax.cond`)."""
    one = build_train(cfg, shape, mesh, hyper, "train", local,
                      head_dim_fallback)
    state, batch, active = one.args
    state_specs, batch_specs, active_spec = one.specs
    batch_c = {k: _meta((chunk,) + tuple(v.shape), v.dtype)
               for k, v in batch.items()}
    batch_c_specs = {k: (None,) + sp for k, sp in batch_specs.items()}
    masks = _meta((chunk,) + tuple(active.shape), torch.float32)
    lcfg, lhyper = local

    def fn(st, bt, ms):
        for i in range(chunk):
            b = {k: v[i] for k, v in bt.items()}
            st = afto_llm_step(lcfg, lhyper, st, b, ms[i])
            if (i + 1) % t_pre == 0:
                st = cut_refresh_llm(lcfg, lhyper, st, b)
        return st

    return Built(fn, (state, batch_c, masks),
                 (state_specs, batch_c_specs, (None,) + active_spec))


def build_plain_train(cfg: ModelConfig, shape: InputShape, mesh, local,
                      head_dim_fallback: bool = False) -> Built:
    """One AdamW step by autograd, each block checkpointed (`remat`, as
    the reference's dry-run runs it)."""
    params = _global_params(cfg)
    opt = adamw(3e-4)
    opt_state = opt.init(params)
    batch = input_specs(cfg, shape, 1, fed=False)
    p_specs = shd.param_specs(params, mesh,
                              shard_head_dim_fallback=head_dim_fallback)
    o_specs = {"step": (), "m": p_specs, "v": p_specs}
    lcfg, _ = local

    def fn(p, o, bt):
        return plain_train_step(lcfg, p, o, bt["tokens"], bt.get("frames"),
                                optimizer=opt, remat=True)

    return Built(fn, (params, opt_state, batch),
                 (p_specs, o_specs, _lead_specs(batch, mesh)))


def build_prefill(cfg: ModelConfig, shape: InputShape, mesh, local,
                  route: str, head_dim_fallback: bool = False) -> Built:
    params = _global_params(cfg)
    batch = input_specs(cfg, shape, 1, fed=False)
    p_specs = shd.param_specs(params, mesh,
                              shard_head_dim_fallback=head_dim_fallback)
    lcfg, _ = local

    def fn(p, bt):
        return tfm.prefill(lcfg, p, bt["tokens"], bt.get("frames"),
                           impl=route)

    return Built(fn, (params, batch), (p_specs, _lead_specs(batch, mesh)))


def build_decode(cfg: ModelConfig, shape: InputShape, mesh, local,
                 kv_seq_sharded: bool = False,
                 head_dim_fallback: bool = False) -> Built:
    params = _global_params(cfg)
    caches = tfm.init_cache(cfg, shape.global_batch, shape.seq_len,
                            device=META)
    batch = input_specs(cfg, shape, 1, fed=False)
    p_specs = shd.param_specs(params, mesh,
                              shard_head_dim_fallback=head_dim_fallback)
    c_specs = shd.cache_specs(caches, mesh, kv_seq_sharded=kv_seq_sharded)
    b_specs = _lead_specs(batch, mesh)
    lcfg, _ = local

    def fn(p, c, tok, pos):
        return tfm.decode_step(lcfg, p, c, tok, pos)

    return Built(fn, (params, caches, batch["tokens"], batch["cur_pos"]),
                 (p_specs, c_specs, b_specs["tokens"], b_specs["cur_pos"]),
                 caches=(1,))


# ---------------------------------------------------------------------------
# run one combination
# ---------------------------------------------------------------------------

def default_step_kind(shape: InputShape) -> str:
    return {"train": "afto_train", "prefill": "prefill",
            "decode": "decode"}[shape.kind]


def analytic_flops(cfg: ModelConfig, shape: InputShape,
                   step_kind: str) -> Tuple[float, float]:
    """(analytic_total, model_flops_6nd)."""
    n_act = active_param_count(cfg)
    if shape.kind == "train":
        sf = step_flops(cfg, shape.global_batch, shape.seq_len - 1,
                        training=True)
        tokens = shape.global_batch * (shape.seq_len - 1)
        return sf["total"], 6.0 * n_act * tokens
    if shape.kind == "prefill":
        sf = step_flops(cfg, shape.global_batch, shape.seq_len,
                        training=False)
        tokens = shape.global_batch * shape.seq_len
        return sf["total"], 2.0 * n_act * tokens
    sf = step_flops(cfg, shape.global_batch, 1, training=False,
                    kv_len=shape.seq_len)
    return sf["total"], 2.0 * n_act * shape.global_batch


def resolve_mesh(mesh: Union[str, AbstractMesh]) -> Tuple[str, AbstractMesh]:
    """("pod" | "multipod" | the mesh's shape as a name, the mesh)."""
    if isinstance(mesh, AbstractMesh):
        return "x".join(map(str, mesh.sizes)), mesh
    return mesh, make_production_mesh(multi_pod=(mesh == "multipod"))


def _storages(tree) -> Dict[int, int]:
    return {x.untyped_storage()._cdata: x.untyped_storage().nbytes()
            for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)}


def trace(built: Built, mesh, local_cfg: ModelConfig, top: int = 15):
    """(local args, outputs, the `Counter`) of one traced local step."""
    args = tuple(localize(a, s, mesh, local_cfg, caches=i in built.caches)
                 for i, (a, s) in enumerate(zip(built.args, built.specs)))
    with rl.Counter(args, top=top) as counter:
        out = built.fn(*args)
    return args, out, counter


def build(cfg: ModelConfig, shape: InputShape, mesh, step_kind: str,
          hyper: FedHyper, route: str = "kernel", kv_seq_shard=False,
          head_dim_fallback=False, scan_chunk: int = 4):
    """(Built, local config, local hyper) of one combination."""
    lcfg = local_config(cfg, mesh, head_dim_fallback)
    n_data = _n_workers(mesh)
    if hyper.n_workers % n_data:
        raise ValueError(f"{hyper.n_workers} workers do not split over "
                         f"the {n_data}-way data axes")
    lhyper = dataclasses.replace(hyper,
                                 n_workers=hyper.n_workers // n_data)
    local = (lcfg, lhyper)
    kw = dict(head_dim_fallback=head_dim_fallback)
    if step_kind == "afto_scan":
        b = build_train_scan(cfg, shape, mesh, hyper, local, scan_chunk,
                             **kw)
    elif step_kind in ("afto_train", "cut_refresh"):
        b = build_train(cfg, shape, mesh, hyper,
                        "cut_refresh" if step_kind == "cut_refresh"
                        else "train", local, **kw)
    elif step_kind == "plain_train":
        b = build_plain_train(cfg, shape, mesh, local, **kw)
    elif step_kind == "prefill":
        b = build_prefill(cfg, shape, mesh, local, route, **kw)
    elif step_kind == "decode":
        b = build_decode(cfg, shape, mesh, local,
                         kv_seq_sharded=kv_seq_shard, **kw)
    else:
        raise ValueError(step_kind)
    return b, lcfg, lhyper


def schedule_of(cfg: ModelConfig, mesh, built: Built, step_kind: str,
                shape: InputShape, hyper: FedHyper, scan_chunk: int = 4):
    """`roofline.collective_schedule` of a built step: the sequences a
    device's model runs per forward (its share of the batch, all its
    workers' for a fed step) and their length."""
    fed = step_kind in ("afto_train", "afto_scan", "cut_refresh")
    state_or_params, specs0 = built.args[0], built.specs[0]
    params, p_specs = ((state_or_params.z3, specs0.z3) if fed
                       else (state_or_params, specs0))
    if fed:
        n_loc = hyper.n_workers // _n_workers(mesh)
        b = n_loc * max(1, shape.global_batch // hyper.n_workers)
    else:
        tok = built.args[-1]["tokens"] if step_kind != "decode" \
            else built.args[2]
        b = shd.local_shape(tok.shape, _lead_specs({"t": tok}, mesh)["t"],
                            mesh.shape)[0]
    s = {"decode": 1, "prefill": shape.seq_len}.get(step_kind,
                                                     shape.seq_len - 1)
    return rl.collective_schedule(cfg, mesh, params, p_specs, step_kind,
                                  b=b, s=s, k_inner=hyper.k_inner,
                                  p_max=hyper.p_max, chunk=scan_chunk)


def run_one(arch: Union[str, ModelConfig],
            shape_name: Union[str, InputShape],
            mesh_kind: Union[str, AbstractMesh],
            step: Optional[str] = None, cut_mode: str = "exact",
            p_max: int = 2, verbose: bool = True, route: str = "kernel",
            attn_impl: str = "naive", sketch_r: int = 4096,
            kv_seq_shard: bool = False, first_order: bool = False,
            scan_chunk: int = 4, head_dim_fallback: bool = False,
            hyper: Optional[FedHyper] = None, top: int = 15) -> dict:
    """The dry-run row of one combination (the reference's keys, with
    `flops_per_dev` / `bytes_per_dev` for its HLO-named counts, `trace_s`
    for its lower / compile times, `route` for its layer mode, and
    `remat`).  `arch`, `shape_name` and `mesh_kind` also take a config,
    a shape and a mesh; `hyper` (its `n_workers` split over the data
    axes) replaces the fed steps' default of one worker per data shard."""
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    shape = (shape_name if isinstance(shape_name, InputShape)
             else get_shape(shape_name))
    mesh_name, mesh = resolve_mesh(mesh_kind)
    if (cfg.name, shape.name) in DRYRUN_SKIPS:
        return {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
                "status": "skipped",
                "reason": DRYRUN_SKIPS[(cfg.name, shape.name)]}
    if attn_impl != "naive":
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    chips = mesh.size
    step_kind = step or default_step_kind(shape)
    if hyper is None:
        hyper = FedHyper(n_workers=_n_workers(mesh), cut_mode=cut_mode,
                         sketch_r=sketch_r, first_order_cuts=first_order,
                         p_max=p_max, k_inner=1, remat=False)
    t0 = time.time()
    built, lcfg, lhyper = build(cfg, shape, mesh, step_kind, hyper, route,
                                kv_seq_shard, head_dim_fallback, scan_chunk)
    args, out, counter = trace(built, mesh, lcfg, top)
    t_trace = time.time() - t0

    held = _storages(args)
    out_bytes = sum(n for r, n in _storages(out).items() if r not in held)
    schedule = schedule_of(cfg, mesh, built, step_kind, shape, hyper,
                           scan_chunk)
    an_total, model_flops = analytic_flops(cfg, shape, step_kind)
    report = rl.RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        step_kind=step_kind, flops_per_dev=float(counter.flops),
        bytes_per_dev=float(counter.bytes),
        arg_bytes=float(sum(shd.local_bytes(a, s, mesh)
                            for a, s in zip(built.args, built.specs))),
        temp_bytes=float(counter.peak), out_bytes=float(out_bytes),
        coll_bytes=rl.coll_bytes(schedule),
        analytic_flops_total=an_total, model_flops_total=model_flops)
    row = report.to_json()
    row.update({"status": "ok", "trace_s": round(t_trace, 1),
                "route": route, "cut_mode": hyper.cut_mode,
                "attn_impl": attn_impl, "kv_seq_shard": kv_seq_shard,
                "remat": step_kind == "plain_train",
                "tag": os.environ.get("HILLCLIMB_TAG", "")})
    if verbose:
        print(f"== {cfg.name} x {shape.name} x {mesh_name} [{step_kind}] ==")
        print(f"  memory: arg={report.arg_bytes / 1e9:.2f}GB"
              f" temp={report.temp_bytes / 1e9:.2f}GB"
              f" out={report.out_bytes / 1e9:.2f}GB per device")
        print(f"  cost: flops/dev={report.flops_per_dev:.3e}"
              f" bytes/dev={report.bytes_per_dev:.3e}")
        t = report.terms()
        print(f"  roofline: compute={t['compute_corrected_s'] * 1e3:.2f}ms"
              f" memory={t['memory_s'] * 1e3:.2f}ms"
              f" collective={t['collective_s'] * 1e3:.2f}ms"
              f" dominant={report.dominant()}"
              f" useful_ratio={t['useful_ratio']:.2f}")
        print(f"  collectives: {report.coll_bytes}")
        print(f"  trace {t_trace:.1f}s")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Dry-run of (arch x shape x mesh) on meta tensors")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--step", default=None, choices=list(STEP_KINDS))
    ap.add_argument("--scan-chunk", type=int, default=4,
                    help="iterations per trajectory slice for "
                         "--step afto_scan")
    ap.add_argument("--cut-mode", default="exact",
                    choices=["exact", "sketch"])
    ap.add_argument("--p-max", type=int, default=2)
    ap.add_argument("--first-order", action="store_true",
                    help="first-order cuts: stop-grad through the inner "
                         "rollout at cut generation (perf lever)")
    ap.add_argument("--shard-head-dim", action="store_true",
                    help="shard head_dim over the model axis when the "
                         "head count doesn't divide it (perf lever)")
    ap.add_argument("--kv-seq-shard", action="store_true",
                    help="context-parallel decode: shard the KV cache "
                         "sequence dim over the data axis")
    ap.add_argument("--route", default="kernel", choices=["kernel", "ref"],
                    help="prefill / decode through the hand-written "
                         "kernels' meta branch (the card's route) or the "
                         "plain math")
    ap.add_argument("--attn-impl", default="naive",
                    choices=["naive", "chunked"],
                    help="the plain attention of --route ref")
    ap.add_argument("--sketch-r", type=int, default=4096)
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) for --mesh")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)

    if args.all:
        combos = [(a, s) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    failures = 0
    for arch, shape in combos:
        try:
            res = run_one(arch, shape, args.mesh, step=args.step,
                          cut_mode=args.cut_mode, p_max=args.p_max,
                          route=args.route, attn_impl=args.attn_impl,
                          sketch_r=args.sketch_r,
                          kv_seq_shard=args.kv_seq_shard,
                          first_order=args.first_order,
                          scan_chunk=args.scan_chunk,
                          head_dim_fallback=args.shard_head_dim)
        except Exception as e:  # a dry-run failure is a bug in the system
            traceback.print_exc()
            res = {"arch": arch, "shape": shape, "mesh": args.mesh,
                   "status": "error", "error": repr(e)}
            failures += 1
        print(json.dumps(res), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(res) + "\n")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
