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
sweep's run axis.  The LLM rules of the reference module (`param_specs`,
`batch_spec`, `cache_specs`) wait for the LLM training path (ROADMAP.md
Queue 1, item 9).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.core.types import (AFTOState, FlatCuts, InnerState2,
                                    InnerState3, TrilevelProblem)
from repro_torch.fed.runtime.membership import (ShardView, assemble_state,
                                                make_views)
from repro_torch.launch.mesh import WORKER_AXIS
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

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

def _n_local(n_workers: int, n_shards: int) -> int:
    if n_workers % n_shards != 0:
        raise ValueError(f"{n_workers} workers do not partition over "
                         f"{n_shards} shards")
    return n_workers // n_shards


def shard_data(data, w: int, n_shards: int, dim: int = 0):
    """Shard w's rows of a worker-stacked data tree (views, no copy);
    `dim` is the worker axis (1 under a sweep's run axis)."""
    leaves = tree_flatten(data)[0]
    if not leaves:
        return data
    n_loc = _n_local(int(leaves[0].shape[dim]), n_shards)
    return tree_map(lambda x: x.narrow(dim, w * n_loc, n_loc), data)


def shard_problem(problem: TrilevelProblem, w: int, n_shards: int
                  ) -> TrilevelProblem:
    """The problem shard w runs: its workers' data rows, `n_workers` its
    block's width (the objectives keep whatever they close over)."""
    n_loc = _n_local(problem.n_workers, n_shards)
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
