"""Roofline terms of one step traced on the meta device.

Counterpart of `repro/launch/roofline.py`.  Three terms per (arch x
shape x mesh), in seconds, for the local program of one device (see
`launch.dryrun` for what "local" means):

  compute    = flops_per_dev / PEAK_FLOPS_BF16
  memory     = bytes_per_dev / HBM_BW
  collective = per-device collective bytes / LINK_BW

with the NVIDIA H100's rates from `launch.mesh`.  The reference reads
its numbers from XLA's compiled module; here `Counter`, a
`TorchDispatchMode`, records them while the step runs on meta tensors,
which carry shapes and no data:

  * flops_per_dev: the formulas of `torch.utils.flop_counter`
    (matrix products, convolutions, attention) on every aten op, plus
    the work the hand-written kernels report from their meta branch
    (`kernels.cut_eval.meta_work`: the attention and mLSTM kernels' own
    FLOP counts, the ones `chip_smoke.py` bounds them with);
  * bytes_per_dev: each aten op's inputs read once and outputs written
    once (a view and an empty allocation move nothing, a stride-0
    broadcast dimension is read once), plus the kernels' reported bytes;
  * temp_bytes: the peak of the bytes held by storages the step
    allocated, its outputs included while they live (the arguments are
    `arg_bytes`, counted from the specs); a storage is freed when the
    last tensor on it dies, an autograd-saved one included (a finalizer
    on the storage's Python object, which PyTorch keeps exactly as long
    as the storage);
  * the op histogram and the top-k largest allocations (`launch.profile`).

The collective term cannot be read from a module either: it is the
analytic schedule `collective_schedule` of the layout the specs
describe, one `Collective` per layer and leaf that causes it:

  * model axis: one all-reduce of a block's (b, s, d) output wherever
    the specs shard its output projection over "model" (attention `wo`,
    cross-attention `xwo`, the dense MLP's `wo`, Mamba's `out_proj`, the
    MoE experts' `wo`), and of Mamba's (b, s, 2 d_state + 1) `xproj`
    product, whose contraction runs over the sharded d_inner;
  * the vocab-sharded embedding: one all-reduce of the (b, s, d)
    embeddings; the vocab-sharded LM head: in training, the loss's two
    all-reduces of (b, s) f32 (the row max and the sum of exponentials);
    logits returned by prefill and decode stay sharded;
  * the router of experts sharded over "model": one all-gather of its
    (b s, E) f32 logits;
  * in training, every collective above once more in the backward pass,
    and twice more again for each second-order pass of the refresh
    (`passes`);
  * data axis: the AFTO step's master sums over the workers (theta's
    (N_PHI,) and the cuts' (P,) values, f32), the refresh's level-3
    master sum of the (data-local) z3 tree in f32 per inner round, with
    its backward mirror, and `plain_train`'s gradient all-reduce.

Bytes are each collective's tensor size per device, as the reference
counts an HLO collective's output shape.  The reference's
`collective_s` then divides the per-device bytes by the chip count a
second time; the port does not (ROADMAP.md Queue 3).
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import math
import weakref
from typing import Dict, List, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten as _flat
from torch.utils.flop_counter import flop_registry

from repro_torch.fed import sharding as shd
from repro_torch.kernels import cut_eval
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from repro_torch.models.config import BlockSpec
from repro_torch.utils.tree import tree_flatten

# ops that allocate and neither read nor write
_ALLOCATE = {"empty_like", "empty", "empty_strided", "new_empty",
             "new_empty_strided"}


def _span_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor's elements occupy, a stride-0 (broadcast)
    dimension counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


class Counter(TorchDispatchMode):
    """Record FLOPs, bytes, peak live bytes, the op histogram and the
    largest allocations of everything run under it.

        with Counter(args) as c:
            out = step(*args)
        c.flops, c.bytes, c.peak, c.live, c.hist, c.largest()

    `args`: trees of tensors that are the step's arguments; their
    storages are never counted as allocations."""

    def __init__(self, args=(), top: int = 15):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.peak = 0
        self.live = 0
        self.hist: collections.Counter = collections.Counter()
        self._top = top
        self._largest: List[tuple] = []
        self._held = {x.untyped_storage()._cdata for x in _flat(args)[0]
                      if isinstance(x, torch.Tensor)}
        self._alive: Dict[int, int] = {}
        self._open = False
        self._n_alloc = 0

    # -- kernels' meta branches report here (`cut_eval.meta_work`)
    def kernel_work(self, name: str, flops: int, nbytes: int) -> None:
        self.flops += int(flops)
        self.bytes += int(nbytes)
        self.hist[name] += 1

    def __enter__(self):
        cut_eval.WORK_SINKS.append(self)
        self._open = True
        return super().__enter__()

    def __exit__(self, *exc):
        cut_eval.WORK_SINKS.remove(self)
        self._open = False
        return super().__exit__(*exc)

    def _freed(self, key: int) -> None:
        nbytes = self._alive.pop(key)
        if self._open:
            self.live -= nbytes

    def _allocated(self, t: torch.Tensor, op: str) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._held or key in self._alive:
            return
        nbytes = storage.nbytes()
        self._alive[key] = nbytes
        # a storage's Python object lives exactly as long as the storage
        # (PyTorch preserves it while any tensor, an autograd-saved one
        # included, holds the storage), so its finalizer is the free
        weakref.finalize(storage, self._freed, key).atexit = False
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        self._n_alloc += 1
        item = (nbytes, self._n_alloc, op, tuple(t.shape), str(t.dtype))
        if len(self._largest) < self._top:
            heapq.heappush(self._largest, item)
        elif item > self._largest[0]:
            heapq.heapreplace(self._largest, item)

    def largest(self) -> List[tuple]:
        """(bytes, op, shape, dtype) of the largest allocations, largest
        first."""
        return [(b, op, shape, dt) for b, _, op, shape, dt
                in sorted(self._largest, reverse=True)]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        self.hist[name] += 1
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        returns = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) else (out,)
        views = all(r.alias_info is not None and not r.alias_info.is_write
                    for r in returns) and len(returns) > 0
        if views:
            return out
        moved = 0
        for i, x in enumerate(outs):
            if not isinstance(x, torch.Tensor):
                continue
            moved += _span_bytes(x)
            if i < len(returns) and returns[i].alias_info is None:
                self._allocated(x, name)
        if name not in _ALLOCATE:
            self.bytes += moved + sum(
                _span_bytes(x) for x in _flat((args, kwargs))[0]
                if isinstance(x, torch.Tensor))
        return out


# ---------------------------------------------------------------------------
# the collective schedule
# ---------------------------------------------------------------------------

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass(frozen=True)
class Collective:
    """`count` collectives of `kind` over `axis`, each of `nbytes` per
    device, caused by `leaf` of `where`."""
    where: str
    leaf: str
    kind: str
    axis: str
    nbytes: int
    count: int


def _on_model(spec) -> bool:
    """True if a spec shards any but its last dimension over "model"
    (a contraction that must be summed over the model axis)."""
    return any(a == "model" or (isinstance(a, tuple) and "model" in a)
               for a in tuple(spec)[:-1])


_MIXERS = {"attn": "attn", "mamba": "mamba", "mlstm": "mlstm",
           "slstm": "slstm"}


def _block_collectives(cfg, where: str, spec: BlockSpec, sp, b: int, s: int,
                       count: int, decoder: bool) -> List[Collective]:
    es = 4 if cfg.dtype == "float32" else 2
    act = b * s * cfg.d_model * es
    out = []

    def ar(leaf, nbytes):
        out.append(Collective(where, leaf, "all-reduce", "model", nbytes,
                              count))

    mixer = sp[_MIXERS[spec.mixer]]
    if spec.mixer == "mamba":
        if _on_model(mixer["xproj"]):
            ar("mamba.xproj", b * s * (2 * cfg.ssm_d_state + 1) * es)
        if _on_model(mixer["out_proj"]):
            ar("mamba.out_proj", act)
    elif _on_model(mixer["wo"]):
        ar(f"{spec.mixer}.wo", act)
    if decoder and spec.cross_attn and _on_model(mixer["xwo"]):
        ar("attn.xwo", act)
    if spec.mlp == "dense" and _on_model(sp["mlp"]["wo"]):
        ar("mlp.wo", act)
    elif spec.mlp == "moe":
        if tuple(sp["moe"]["router"])[-1] is not None:
            out.append(Collective(where, "moe.router", "all-gather",
                                  "model", b * s * cfg.n_experts * 4,
                                  count))
        if _on_model(sp["moe"]["wo"]):
            ar("moe.wo", act)
    return out


def model_passes(step_kind: str, k_inner: int, chunk: int, t_pre: int
                 ) -> int:
    """How many times each forward collective of the model runs in one
    step: 1 a forward; 2 for a forward and its backward; plain_train's
    `remat` recomputes each forward once more; the refresh's two
    objectives each run `k_inner` worker gradients (2) and reverse them
    once more (2)."""
    refresh = 2 * 2 * 2 * k_inner
    return {"prefill": 1, "decode": 1, "plain_train": 3, "afto_train": 2,
            "cut_refresh": refresh,
            "afto_scan": 2 * chunk + (chunk // t_pre) * refresh}[step_kind]


def collective_schedule(cfg, mesh, params, p_specs, step_kind: str, *,
                        b: int, s: int, k_inner: int = 1, p_max: int = 2,
                        chunk: int = 4, t_pre: int = 2
                        ) -> List[Collective]:
    """The collectives of one step on `mesh` (the rules of the module
    docstring).  params / p_specs: the model's (global) param tree and
    its specs; b, s: the sequences a device's model runs per forward and
    their length."""
    out: List[Collective] = []
    passes = model_passes(step_kind, k_inner, chunk, t_pre)
    training = step_kind not in ("prefill", "decode")
    if mesh.shape.get("model", 1) > 1:
        es = 4 if cfg.dtype == "float32" else 2
        if tuple(p_specs["embed"])[0] == "model":
            out.append(Collective("embedding", "embed", "all-reduce",
                                  "model", b * s * cfg.d_model * es,
                                  passes))
        if cfg.is_encoder_decoder and step_kind != "decode":
            for si, (st, sps) in enumerate(zip(cfg.encoder_stages,
                                               p_specs["encoder"])):
                for i, spec in enumerate(st.pattern):
                    out += _block_collectives(
                        cfg, f"encoder[{si}].pos{i} x{st.repeats}", spec,
                        sps[f"pos{i}"], b, cfg.encoder_seq,
                        st.repeats * passes, decoder=False)
        for si, (st, sps) in enumerate(zip(cfg.stages, p_specs["stages"])):
            for i, spec in enumerate(st.pattern):
                out += _block_collectives(
                    cfg, f"stages[{si}].pos{i} x{st.repeats}", spec,
                    sps[f"pos{i}"], b, s, st.repeats * passes,
                    decoder=True)
        head = p_specs["embed"] if cfg.tie_embeddings else p_specs["lm_head"]
        vocab_dim = 0 if cfg.tie_embeddings else -1
        if training and tuple(head)[vocab_dim] == "model":
            out.append(Collective("loss", "lm_head (row max, sum of exp)",
                                  "all-reduce", "model", b * s * 4,
                                  2 * passes))
    n_data = mesh.size // mesh.shape.get("model", 1)
    if n_data > 1:
        ax = "+".join(a for a in mesh.axis_names if a != "model")
        ms = mesh.shape

        def local_numel(tree, specs):
            return sum(math.prod(shd.local_shape(x.shape, sp, ms))
                       for x, sp in zip(tree_flatten(tree)[0],
                                        shd.spec_leaves(specs, tree)))

        def data(where, leaf, nbytes, count):
            if count:
                out.append(Collective(where, leaf, "all-reduce", ax, nbytes,
                                      count))

        steps = {"afto_train": 1, "afto_scan": chunk}.get(step_kind, 0)
        refreshes = {"cut_refresh": 1,
                     "afto_scan": chunk // t_pre}.get(step_kind, 0)
        data("master (Eq. 17)", "theta", 4 * 4, steps)
        data("master (Eqs. 20, 23-24)", "cut values", p_max * 4,
             steps + 2 * 2 * k_inner * refreshes)
        data("level-3 master round (Eq. 6)", "z3 (f32)",
             4 * local_numel(params, p_specs), 2 * k_inner * refreshes)
        if step_kind == "plain_train":
            data("gradients", "params", shd.local_bytes(params, p_specs, mesh),
                 1)
    return out


def coll_bytes(schedule: Sequence[Collective]) -> Dict[str, int]:
    """Bytes per collective kind and the number of collectives, the
    reference's `collective_bytes` dict."""
    out = {k: 0 for k in COLLECTIVES}
    out["count"] = 0
    for c in schedule:
        out[c.kind] += c.nbytes * c.count
        out["count"] += c.count
    return out


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    step_kind: str
    # the local program's counts (one device)
    flops_per_dev: float
    bytes_per_dev: float
    # memory (per device): arguments from the specs, temp the traced peak
    # beyond them (outputs included while they live), out the outputs
    arg_bytes: float
    temp_bytes: float
    out_bytes: float
    # the analytic collective schedule's bytes per kind (per device)
    coll_bytes: Dict[str, int]
    # analytic
    analytic_flops_total: float
    model_flops_total: float      # 6 * N_active * tokens (2 * for serving)

    def terms(self) -> Dict[str, float]:
        flops_total = self.flops_per_dev * self.chips
        # the analytic model is the floor, as in the reference: a local
        # program that skips work (masked pairs) cannot count as "useful"
        # above the model's own count
        flops_corr = max(flops_total, self.analytic_flops_total)
        coll = sum(v for k, v in self.coll_bytes.items() if k != "count")
        return {
            "compute_s": self.flops_per_dev / PEAK_FLOPS_BF16,
            "compute_corrected_s":
                flops_corr / (self.chips * PEAK_FLOPS_BF16),
            "memory_s": self.bytes_per_dev / HBM_BW,
            "collective_s": coll / LINK_BW,
            "useful_ratio": (self.model_flops_total
                             / max(flops_corr, 1.0)),
            "hbm_gb_per_dev": (self.arg_bytes + self.temp_bytes) / 1e9,
        }

    def dominant(self) -> str:
        t = self.terms()
        kinds = {"compute": t["compute_corrected_s"],
                 "memory": t["memory_s"],
                 "collective": t["collective_s"]}
        return max(kinds, key=kinds.get)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(self.terms())
        d["dominant"] = self.dominant()
        return d
