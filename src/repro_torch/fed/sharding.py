"""Worker-mesh partitioning of the AFTO state and data.

Counterpart of the worker-mesh half of `repro/fed/sharding.py`
(`afto_state_specs`, `worker_data_specs`), plus the operations the
process-per-shard engine needs from them: cut a global state, problem
or data tree into shard w's block, and put the global state back
together from every shard's block.  The layout itself is
`fed.runtime.membership.make_views` / `assemble_state` over
`cuts.shard_cuts` / `unshard_cuts`: a shard holds its workers' stacked
rows (X1/X2/X3, theta, the stale views, the inner x and phi stacks) and
a local polytope of the replicated a-columns and its own workers'
b-columns; every master leaf (z1/z2/z3, lam, gamma_k, the inner z / s /
gamma, t, the cuts' c / active / age) is replicated.

A spec is a tuple of mesh-axis names per leading dimension, as a
`PartitionSpec`: `(*lead, "worker")` for a leaf whose leading worker
axis splits over the mesh, `(*lead,)` for a replicated one.  `lead`
holds the entries outside the worker axis, e.g. `(None,)` for a
sweep's run axis.

The LLM half (`param_specs`, `data_axis`, `batch_spec`, `cache_specs`)
is the reference's mesh partitioning of the model zoo, over the axes of
`launch.mesh.make_production_mesh`:

  data  : federated workers / data parallel (batch, worker-stacked vars)
  model : tensor parallel (heads, d_ff, experts, vocab, d_inner)
  pod   : optional outer axis; worker stacks shard over ('pod','data')

Its specs are tuples with one entry per dimension: an axis name, a
tuple of axis names, or None (replicated).  Rules are name-based on the
last path segment of each leaf.  Every parameter inside a stage carries
a leading repeat axis (R, ...), so its base rank is `leaf.dim() -
len(stack_axes) - 1`, while top-level parameters (embed, lm_head, norms,
enc_pos) have none; name plus rank tells the dense MLP's `wo` (R,f,d)
from attention's `wo` (R,H,hd,d) and the MoE's `wo` (R,E,f,d).  A
dimension its mesh axis does not divide falls back to replication
(xlstm-125m has 4 heads against a 16-way model axis).  The specs are
read by the dry-run (`launch.dryrun`), which counts each device's share
of every leaf from them.  Placing tensors by them on a device mesh (the
reference's `to_named`) has no counterpart: the port's worker mesh is a
group of processes over the workers alone, laid out as follows.

The launcher's layout of the federated LLM state (`llm_worker_specs`,
`shard_fed_state`, `gather_fed_state`) is the reference's
`launch/train.py _worker_mesh_put` on a one-axis "data" mesh of
processes: the worker-stacked leaves (X1, X2, X3, theta, stale_lam,
stale_theta, z2) split their leading N axis, the b2 / b3 blocks of both
polytopes their worker axis (axis 1), and every other leaf is
replicated.  One deliberate difference: where N does not divide over
the shards the reference replicates the stacked leaves and GSPMD
computes every worker on every device; a process per shard could only
do the same by computing those workers on every rank and dividing
their sums by the shard count, so here it raises `ValueError`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.core.types import (AFTOState, FlatCuts, InnerState2,
                                    InnerState3, TrilevelProblem)
from repro_torch.fed.runtime.membership import (ShardView, assemble_state,
                                                make_views)
from repro_torch.launch.mesh import WORKER_AXIS
from repro_torch.utils.tree import (DictKey, GetAttrKey, tree_flatten,
                                    tree_leaves_with_path, tree_map,
                                    tree_unflatten)

# AFTOState fields whose leaves lead with the worker axis (N, ...)
_WORKER_STACKED = {"X1", "X2", "X3", "theta"}
# nested containers: which of their fields are worker-stacked
_WORKER_STACKED_NESTED = {
    "stale": {"z1", "z2", "z3", "lam", "theta", "t_hat"},
    "inner3": {"x3", "phi"},
    "inner2": {"x2", "phi"},
}
# FlatCuts: only the coefficient matrix differs by shard (its b-columns)
_CUT_FIELDS = {"cuts_i", "cuts_ii"}


def _split_flags(state: AFTOState) -> AFTOState:
    """An `AFTOState` of bools: True where the leaf differs by shard."""
    def const(value, tree):
        return tree_map(lambda _: value, tree)

    out = {}
    for f in dataclasses.fields(AFTOState):
        v = getattr(state, f.name)
        if f.name in _WORKER_STACKED:
            out[f.name] = const(True, v)
        elif f.name in _CUT_FIELDS:
            out[f.name] = FlatCuts(a=True, c=False, active=False, age=False,
                                   spec=v.spec)
        elif f.name in _WORKER_STACKED_NESTED:
            stacked = _WORKER_STACKED_NESTED[f.name]
            out[f.name] = type(v)(**{
                g.name: const(g.name in stacked, getattr(v, g.name))
                for g in dataclasses.fields(v)})
        else:
            out[f.name] = const(False, v)
    return AFTOState(**out)


def afto_state_specs(state: AFTOState, axis: str = WORKER_AXIS,
                     lead: Tuple = ()) -> AFTOState:
    """The spec of every leaf of `state` (an `AFTOState` of specs):
    `(*lead, axis)` for the worker-stacked leaves and the cut matrices,
    `(*lead,)` for the replicated master leaves."""
    split, rep = (*lead, axis), tuple(lead)
    return tree_map(lambda f: split if f else rep, _split_flags(state))


def worker_data_specs(data, axis: str = WORKER_AXIS, lead: Tuple = ()):
    """Every `problem.data` leaf leads with the worker axis."""
    return tree_map(lambda _: (*lead, axis), data)


# ---------------------------------------------------------------------------
# one shard's block, and the global state back
# ---------------------------------------------------------------------------

def n_local(n_workers: int, n_shards: int) -> int:
    """N / n_shards, or `ValueError` naming both numbers."""
    if n_shards < 1 or n_workers % n_shards != 0:
        raise ValueError(f"{n_workers} workers do not partition over "
                         f"{n_shards} shards")
    return n_workers // n_shards


def shard_data(data, w: int, n_shards: int, dim: int = 0):
    """Shard w's rows of a worker-stacked data tree (views, no copy);
    `dim` is the worker axis (1 under a sweep's run axis)."""
    leaves = tree_flatten(data)[0]
    if not leaves:
        return data
    n_loc = n_local(int(leaves[0].shape[dim]), n_shards)
    return tree_map(lambda x: x.narrow(dim, w * n_loc, n_loc), data)


def shard_problem(problem: TrilevelProblem, w: int, n_shards: int
                  ) -> TrilevelProblem:
    """The problem shard w runs: its workers' data rows, `n_workers` its
    block's width (the objectives keep whatever they close over)."""
    n_loc = n_local(problem.n_workers, n_shards)
    return dataclasses.replace(problem, n_workers=n_loc,
                               data=shard_data(problem.data, w, n_shards))


def state_of_view(master: AFTOState, view: ShardView) -> AFTOState:
    """The shard-local `AFTOState` of a `make_views` view: the view's
    stacked rows and local polytopes, every master leaf from `master`."""
    s = view.stacks
    return dataclasses.replace(
        master, X1=s["X1"], X2=s["X2"], X3=s["X3"], theta=s["theta"],
        stale=s["stale"], cuts_i=view.cuts_i, cuts_ii=view.cuts_ii,
        inner3=InnerState3(x3=s["inner3_x3"], z3=master.inner3.z3,
                           phi=s["inner3_phi"]),
        inner2=InnerState2(x2=s["inner2_x2"], z2=master.inner2.z2,
                           phi=s["inner2_phi"], s=master.inner2.s,
                           gamma=master.inner2.gamma))


def view_of_state(local: AFTOState, w: int, n_shards: int) -> ShardView:
    """Inverse of `state_of_view`: shard w's `ShardView`."""
    return ShardView(
        index=w, n_shards=n_shards,
        stacks={"X1": local.X1, "X2": local.X2, "X3": local.X3,
                "theta": local.theta, "stale": local.stale,
                "inner3_x3": local.inner3.x3,
                "inner3_phi": local.inner3.phi,
                "inner2_x2": local.inner2.x2,
                "inner2_phi": local.inner2.phi},
        cuts_i=local.cuts_i, cuts_ii=local.cuts_ii)


def shard_state(state: AFTOState, w: int, n_shards: int) -> AFTOState:
    """Shard w's block of the global state (`make_views`), as an
    `AFTOState` over its n_loc = N / n_shards workers whose polytopes are
    in the `cuts.shard_spec` layout.  Maps over a sweep's run axis under
    `torch.func.vmap`."""
    return state_of_view(state, make_views(state, n_shards)[w])


def unshard_state(locals_: List[AFTOState], spec_i, spec_ii) -> AFTOState:
    """The global state from every shard's block, in shard order
    (`assemble_state`; bit for bit the inverse of `shard_state`).
    `spec_i` / `spec_ii` are the global polytope layouts."""
    n = len(locals_)
    first = locals_[0]
    master = dataclasses.replace(
        first, cuts_i=dataclasses.replace(first.cuts_i, spec=spec_i),
        cuts_ii=dataclasses.replace(first.cuts_ii, spec=spec_ii))
    return assemble_state(master, [view_of_state(s, w, n)
                                   for w, s in enumerate(locals_)])


def gather_state(local: AFTOState, mesh, spec_i, spec_ii,
                 lead: int = 0) -> AFTOState:
    """The global state on every shard from each shard's `local` block:
    every leaf gathered (one collective per dtype; every shard's block
    has the same shapes), then `unshard_state`.  Raises if a replicated
    leaf is not bitwise the same on every shard.  `lead` counts leading
    run axes (1 for a sweep, whose blocks are assembled run by run)."""
    leaves, tdef = tree_flatten(local)
    split = tree_flatten(_split_flags(local))[0]
    per_shard = [list(leaves) for _ in range(mesh.size)]
    for dtype in dict.fromkeys(x.dtype for x in leaves):
        idx = [i for i, x in enumerate(leaves) if x.dtype == dtype]
        buf = torch.cat([leaves[i].reshape(-1) for i in idx])
        for w, part in enumerate(mesh.all_gather(buf)):
            pieces = torch.split(part, [leaves[i].numel() for i in idx])
            for i, p in zip(idx, pieces):
                per_shard[w][i] = p.reshape(leaves[i].shape)
    for i, differs in enumerate(split):
        if not differs and not all(
                torch.equal(per_shard[0][i], per_shard[w][i])
                for w in range(1, mesh.size)):
            raise RuntimeError(
                f"replicated leaf {i} of the state differs between shards")
    locals_ = [tree_unflatten(tdef, ls) for ls in per_shard]
    if lead == 0:
        return unshard_state(locals_, spec_i, spec_ii)
    return torch.func.vmap(
        lambda ls: unshard_state(ls, spec_i, spec_ii))(locals_)


# ---------------------------------------------------------------------------
# the LLM zoo on the production meshes
# ---------------------------------------------------------------------------

# parameters that live OUTSIDE stages (no repeat axis), with full specs
_TOP_LEVEL = {
    "embed": ("model", None),
    "lm_head": (None, "model"),
    "enc_pos": (None, None),
    "enc_norm": (None,),
    "final_norm": (None,),
}

# stage parameters: spec per (name, base_rank)
_STAGE_RULES = {
    # norms
    ("norm1", 1): (None,), ("norm2", 1): (None,), ("norm_x", 1): (None,),
    ("q_norm", 1): (None,), ("k_norm", 1): (None,),
    # attention (+ cross)
    ("wq", 3): (None, "model", None), ("wk", 3): (None, "model", None),
    ("wv", 3): (None, "model", None), ("wo", 3): ("model", None, None),
    ("xwq", 3): (None, "model", None), ("xwk", 3): (None, "model", None),
    ("xwv", 3): (None, "model", None), ("xwo", 3): ("model", None, None),
    # dense GLU mlp
    ("wi", 2): (None, "model"), ("wg", 2): (None, "model"),
    ("wo", 2): ("model", None),
    # MoE (expert-parallel over the leading E dim; MoE `wo` (E,f,d) is
    # rank-3 like attention's and shares its ("model",None,None) spec)
    ("router", 2): (None, "model"),
    ("wi", 3): ("model", None, None), ("wg", 3): ("model", None, None),
    # mamba
    ("in_proj", 2): (None, "model"), ("conv_w", 2): (None, "model"),
    ("conv_b", 1): ("model",), ("xproj", 2): ("model", None),
    ("dt_bias", 1): ("model",), ("a_log", 2): ("model", None),
    ("d_skip", 1): ("model",), ("out_proj", 2): ("model", None),
    # xlstm (mlstm's input gate `wi` (d,H) hits the rank-2 rule above)
    ("wf", 2): (None, "model"), ("fb", 1): (None,),
    ("wz", 3): (None, "model", None), ("wo_gate", 3): (None, "model", None),
    ("rz", 3): ("model", None, None),
}

_HEAD_TENSORS = {"wq", "wk", "wv", "xwq", "xwk", "xwv", "wz", "wo_gate"}
_HEAD_OUT_TENSORS = {"wo", "xwo"}


def leaf_name(path) -> str:
    """The last dict key or field name of a `tree_leaves_with_path`
    path."""
    for entry in reversed(path):
        if isinstance(entry, DictKey):
            return str(entry.key)
        if isinstance(entry, GetAttrKey):
            return str(entry.name)
    return ""


def axis_size(axis, mesh_shape: dict) -> int:
    """The number of shards of a spec entry (1 for None)."""
    if axis is None:
        return 1
    axes = axis if isinstance(axis, tuple) else (axis,)
    return math.prod(mesh_shape[a] for a in axes)


def _divisible(dim: int, axis, mesh_shape: dict) -> bool:
    return dim % axis_size(axis, mesh_shape) == 0


def map_with_path(fn, tree):
    """fn(path, leaf) over every leaf, in a tree of `tree`'s structure."""
    tdef = tree_flatten(tree)[1]
    return tree_unflatten(tdef, [fn(p, x)
                                 for p, x in tree_leaves_with_path(tree)])


def param_specs(params, mesh, *, stack_axes: Tuple = (),
                shard_head_dim_fallback: bool = False) -> Any:
    """The spec tree of a model param tree.

    stack_axes: shardings for extra leading axes prepended OUTSIDE the
    per-stage repeat axis, e.g. ('data',) or (('pod','data'),) for the
    federated worker axis.

    shard_head_dim_fallback: when the head count doesn't divide the model
    axis (whisper: 20 heads on a 16-way axis) shard head_dim instead of
    replicating; the attention contraction then sums over the model axis
    (a perf lever; off by default = the faithful baseline)."""
    mesh_shape = mesh.shape
    n_stack = len(stack_axes)

    def spec_for(path, leaf):
        name = leaf_name(path)
        if name in _TOP_LEVEL:
            base = list(_TOP_LEVEL[name])
            n_lead = leaf.dim() - len(base) - n_stack
            lead = list(stack_axes) + [None] * n_lead
        else:
            base_rank = leaf.dim() - n_stack - 1     # strip worker + repeat
            base = list(_STAGE_RULES.get((name, base_rank),
                                         (None,) * max(base_rank, 0)))
            lead = list(stack_axes) + [None]         # repeat axis unsharded
        full = lead + base
        for i, ax in enumerate(full):
            if ax is not None and not _divisible(leaf.shape[i], ax,
                                                 mesh_shape):
                full[i] = None
        if shard_head_dim_fallback and (
                name in _HEAD_TENSORS or name in _HEAD_OUT_TENSORS) \
                and leaf.dim() - n_stack - 1 == 3:
            # (..., d, H, hd) or (..., H, hd, d): if H failed
            # divisibility, try hd instead
            if name in _HEAD_TENSORS:
                h_i, hd_i = leaf.dim() - 2, leaf.dim() - 1
            else:
                h_i, hd_i = leaf.dim() - 3, leaf.dim() - 2
            if full[h_i] is None and _divisible(leaf.shape[hd_i], "model",
                                                mesh_shape):
                full[hd_i] = "model"
        return tuple(full)

    return map_with_path(spec_for, params)


def data_axis(mesh):
    """The axis (or axes) that batch/worker dims shard over."""
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def batch_spec(mesh, stacked: bool = False) -> Tuple:
    """Tokens (B, S) or worker-stacked (N, b, S)."""
    ax = data_axis(mesh)
    return (ax, None, None) if stacked else (ax, None)


def cache_specs(cache, mesh, batch_sharded: bool = True,
                kv_seq_sharded: bool = False) -> Any:
    """Decode caches: (R, B, ...) leaves; shard batch over data (when it
    divides) and heads/d_inner dims over model by name.

    kv_seq_sharded: context-parallel decode, the KV *sequence* dim
    sharded over the data axis instead of batch (the one-token attention
    then sums over the sharded sequence); the lever for long_500k's
    batch of 1, which otherwise leaves the data axis idle."""
    ax = data_axis(mesh)
    mesh_shape = mesh.shape

    def spec_for(path, leaf):
        name = leaf_name(path)
        spec = [None] * leaf.dim()
        if batch_sharded and leaf.dim() >= 2:
            spec[1] = ax                          # (R, B, ...)
        if name in ("k", "v", "pos"):             # (R,B,W,Hkv,hd)/(R,B,W)
            if kv_seq_sharded:
                spec[1] = None
                spec[2] = ax
            if name in ("k", "v"):
                spec[3] = "model"
        elif name in ("xk", "xv"):                # (R,B,T,Hkv,hd)
            spec[3] = "model"
        elif name == "conv":                      # (R,B,K-1,di)
            spec[3] = "model"
        elif name == "ssm":                       # (R,B,di,dS)
            spec[2] = "model"
        elif name in ("c", "n", "h", "m"):        # xlstm states (R,B,H,..)
            if leaf.dim() >= 3:
                spec[2] = "model"
        for i, a in enumerate(spec):
            if a is not None and not _divisible(leaf.shape[i], a,
                                                mesh_shape):
                spec[i] = None
        return tuple(spec)

    return map_with_path(spec_for, cache)


def _specs_up_to(d, specs, out: List[Tuple]) -> None:
    if d == ("*",):
        out.append(specs)
    elif d[0] == "dict":
        for k, c in zip(d[1], d[2]):
            _specs_up_to(c, specs[k], out)
    elif d[0] == "node":
        children = pytree.SUPPORTED_NODES[d[1]].flatten_fn(specs)[0]
        for c, sp in zip(d[3], children):
            _specs_up_to(c, sp, out)
    elif d[0] in ("list", "tuple"):
        for c, sp in zip(d[1], specs):
            _specs_up_to(c, sp, out)


def spec_leaves(specs, tree) -> List[Tuple]:
    """The specs of a spec tree for `tree`, in `tree`'s leaf order (a
    spec is a tuple, which flattening the spec tree would take apart)."""
    out: List[Tuple] = []
    _specs_up_to(tree_flatten(tree)[1], specs, out)
    return out


def local_shape(shape, spec, mesh_shape: dict) -> Tuple[int, ...]:
    """One device's block of a leaf of `shape` laid out by `spec`."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // axis_size(a, mesh_shape) for n, a in zip(shape, spec))


def local_bytes(tree, specs, mesh) -> int:
    """The bytes one device holds of `tree` laid out by `specs`."""
    return sum(math.prod(local_shape(x.shape, sp, mesh.shape))
               * x.element_size()
               for x, sp in zip(tree_flatten(tree)[0],
                                spec_leaves(specs, tree)))


# ---------------------------------------------------------------------------
# the federated LLM state on a worker mesh (the launcher's layout)
# ---------------------------------------------------------------------------

LLM_AXIS = "data"
# FedLLMState fields whose leaves lead with the worker axis (N, ...)
_LLM_STACKED = {"X1", "X2", "X3", "theta", "stale_lam", "stale_theta", "z2"}
# the polytopes, whose b2 / b3 blocks carry the worker axis second
_LLM_CUTS = {"cuts", "cuts_i"}


def _llm_worker_dim(path):
    """The worker axis of a `FedLLMState` leaf: 0, 1, or None for a
    replicated leaf."""
    names = [e.name for e in path if isinstance(e, GetAttrKey)]
    head = names[0] if names else ""
    if head in _LLM_STACKED:
        return 0
    if head in _LLM_CUTS and len(names) > 1 and names[1] in ("b2", "b3"):
        return 1
    return None


def llm_worker_specs(state, n_shards: int, axis: str = LLM_AXIS):
    """The spec of every leaf of a global `FedLLMState` (a `FedLLMState`
    of tuples): `(axis,)` for the worker-stacked leaves, `(None, axis)`
    for the polytopes' b2 / b3 blocks, `()` for the replicated rest;
    the rule of the reference's `_worker_mesh_put`, leaf for leaf."""
    n_local(int(state.X1.shape[0]), n_shards)
    specs = {0: (axis,), 1: (None, axis), None: ()}
    return map_with_path(lambda p, _: specs[_llm_worker_dim(p)], state)


def shard_fed_state(state, w: int, n_shards: int):
    """Shard w's `FedLLMState`: its workers' rows of the worker-stacked
    leaves and of the b-blocks (views), every other leaf as it is."""
    n_loc = n_local(int(state.X1.shape[0]), n_shards)

    def block(path, x):
        d = _llm_worker_dim(path)
        return x if d is None else x.narrow(d, w * n_loc, n_loc)

    return map_with_path(block, state)


def _as_bits(x: torch.Tensor) -> torch.Tensor:
    """x flattened, with a dtype every backend gathers (bf16 as its bytes;
    gloo gathers no 16-bit type but f16)."""
    x = x.contiguous().reshape(-1)
    return x.view(torch.uint8) if x.dtype == torch.bfloat16 else x


def _from_bits(bits: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of `_as_bits`: a tensor shaped and typed as `like`."""
    return bits.view(like.dtype).reshape(like.shape)


def gather_fed_state(local, mesh, label: str = "gather"):
    """The global `FedLLMState` on every shard from each shard's `local`
    block: one all-gather per dtype (bf16 as its bits), the worker axes
    concatenated in shard order; the round trip with `shard_fed_state`
    is exact.  Raises `RuntimeError` naming the replicated leaves that
    are not bitwise the same on every shard."""
    pairs = tree_leaves_with_path(local)
    leaves, tdef = tree_flatten(local)
    bits = [_as_bits(x) for x in leaves]
    per_shard = [list(bits) for _ in range(mesh.size)]
    for dtype in dict.fromkeys(x.dtype for x in bits):
        idx = [i for i, x in enumerate(bits) if x.dtype == dtype]
        buf = torch.cat([bits[i].reshape(-1) for i in idx])
        for w, part in enumerate(mesh.all_gather(buf, label=label)):
            pieces = torch.split(part, [bits[i].numel() for i in idx])
            for i, piece in zip(idx, pieces):
                per_shard[w][i] = piece
    out, differ = [], []
    for i, (path, x) in enumerate(pairs):
        parts = [_from_bits(per_shard[w][i], x) for w in range(mesh.size)]
        d = _llm_worker_dim(path)
        if d is not None:
            out.append(torch.cat(parts, dim=d))
            continue
        if not all(torch.equal(parts[0], q) for q in parts[1:]):
            differ.append(".".join(str(e[0]) for e in path))
        # a copy: the piece is a view of the whole gathered buffer
        out.append(parts[0].clone())
    if differ:
        raise RuntimeError("replicated leaves of the federated state "
                           f"differ between shards: {differ}")
    return tree_unflatten(tdef, out)
