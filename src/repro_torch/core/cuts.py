"""mu-cut construction and hyper-polyhedral polytope maintenance.

Counterpart of `repro/core/cuts.py`, canonical `FlatCuts` path.  A mu-cut
(paper Eq. 23/24) linearizes a mu-weakly-convex constraint h(v) <= eps at
the current point v0 into the linear inequality

    <g, v>  <=  eps + mu (B_alpha + ||v0||^2) - h(v0) + <g, v0>  =: c

(see the reference module's docstring for the derivation and the note on
Eq. 23's printed constant).  The polytope is one dense f32 `(P, D)`
matrix: `add_cut` writes one row (evicting the oldest when full),
`drop_inactive` masks rows, and every consumer contracts the stored
matrix directly; only the point vector is assembled per call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.types import FlatCuts, FlatSpec
from repro_torch.kernels import ops
from repro_torch.utils.tree import (tree_dot, tree_flatten, tree_norm_sq,
                                    tree_unflatten)

_BLOCK_NAMES = ("a1", "a2", "a3", "b2", "b3")


def spec_from_templates(n_workers: int, z1_tpl, z2_tpl, z3_tpl) -> FlatSpec:
    """The FlatSpec for a polytope over these variable templates.

    Column order is the sorted-key leaf order of (a1, a2, a3, b2, b3);
    b-block point shapes carry the leading worker axis (N, ...)."""
    tpls = (z1_tpl, z2_tpl, z3_tpl, z2_tpl, z3_tpl)
    flat = [tree_flatten(t) for t in tpls]
    shapes, dtypes = [], []
    for b_idx, (leaves, _) in enumerate(flat):
        lead = (int(n_workers),) if b_idx >= 3 else ()
        shapes.extend(lead + tuple(l.shape) for l in leaves)
        dtypes.extend(l.dtype for l in leaves)
    sizes = tuple(int(np.prod(s)) if s else 1 for s in shapes)
    offsets = tuple(int(o) for o in np.cumsum((0,) + sizes[:-1])) \
        if sizes else ()
    return FlatSpec(tdefs=tuple(tdef for _, tdef in flat),
                    nleaves=tuple(len(ls) for ls, _ in flat),
                    shapes=tuple(shapes), dtypes=tuple(dtypes),
                    sizes=sizes, offsets=offsets, d_total=sum(sizes))


def empty_cuts(p_max: int, n_workers: int, z1_tpl, z2_tpl, z3_tpl
               ) -> FlatCuts:
    """All-zero, all-inactive polytope on the templates' device."""
    spec = spec_from_templates(n_workers, z1_tpl, z2_tpl, z3_tpl)
    dev = tree_flatten(z1_tpl)[0][0].device
    return FlatCuts(
        a=torch.zeros((p_max, spec.d_total), dtype=torch.float32,
                      device=dev),
        c=torch.zeros((p_max,), dtype=torch.float32, device=dev),
        active=torch.zeros((p_max,), dtype=torch.float32, device=dev),
        age=torch.full((p_max,), -1, dtype=torch.int32, device=dev),
        spec=spec)


def make_cut(h0, grads, point, eps, mu, bound_alpha):
    """Assemble the linear cut <g, v> <= c from h's value/grads at `point`.

    grads/point are dicts with keys from {"a1","a2","a3","b2","b3"}; missing
    blocks are zero.  Returns (coeff_dict, c)."""
    gv0 = 0.0
    v0_sq = 0.0
    for k, g in grads.items():
        gv0 = gv0 + tree_dot(g, point[k])
        v0_sq = v0_sq + tree_norm_sq(point[k])
    c = eps + mu * (bound_alpha + v0_sq) - h0 + gv0
    return grads, c


def flatten_coeffs(spec: FlatSpec, coeffs: Dict[str, Any]):
    """One cut's coefficient dict as a (D,) f32 row in spec column order
    (missing blocks zero)."""
    return flatten_point(spec, coeffs.get("a1"), coeffs.get("a2"),
                         coeffs.get("a3"), coeffs.get("b2"),
                         coeffs.get("b3"))


def _next_slot(active, age):
    """First inactive slot, else the oldest active one (eviction).
    Integer scores, as in the reference: an f32 offset loses age bits.
    `torch.argmin` returns the first minimum, as `jnp.argmin` does."""
    score = torch.where(active > 0, age,
                        torch.full_like(age, -(2 ** 30)))
    return torch.argmin(score)


def add_cut(cuts: FlatCuts, coeffs, c, t) -> FlatCuts:
    """Write the cut into the first inactive slot (or evict the oldest):
    one row write of the flattened coefficient dict, selected by a slot
    mask, so the slot stays on the device (no host sync) and the write
    maps over a sweep's runs under `torch.func.vmap`."""
    slot = _next_slot(cuts.active, cuts.age)
    hit = torch.arange(cuts.active.shape[0],
                       device=cuts.active.device) == slot
    row = flatten_coeffs(cuts.spec, coeffs)

    def like(x, ref):
        return x.to(ref.dtype) if torch.is_tensor(x) \
            else torch.tensor(x, dtype=ref.dtype, device=ref.device)
    return FlatCuts(
        a=torch.where(hit[:, None], row[None, :], cuts.a),
        c=torch.where(hit, like(c, cuts.c), cuts.c),
        active=torch.where(hit, torch.ones_like(cuts.active), cuts.active),
        age=torch.where(hit, like(t, cuts.age), cuts.age),
        spec=cuts.spec)


def drop_inactive(cuts: FlatCuts, multipliers, tol: float = 1e-8
                  ) -> FlatCuts:
    """Eq. 25: drop cut l when its multiplier is (numerically) zero.
    A row mask on `active`; coefficients stay (a later add overwrites)."""
    keep = (torch.abs(multipliers) > tol).to(cuts.active.dtype)
    return dataclasses.replace(cuts, active=cuts.active * keep)


def n_active(cuts: FlatCuts):
    return torch.sum(cuts.active)


def flatten_point(spec: FlatSpec, z1, z2, z3, X2=None, X3=None):
    """The variable point (z1, z2, z3, {x2_j}, {x3_j}) as a (D,) f32
    vector in the spec's column order.  A None block is zero."""
    parts = []
    dev = None
    i = 0
    for b_idx, block in enumerate((z1, z2, z3, X2, X3)):
        n = spec.nleaves[b_idx]
        if block is None:
            parts.extend(spec.sizes[i + k] for k in range(n))
        else:
            for leaf in tree_flatten(block)[0]:
                parts.append(leaf.reshape(-1).float())
                dev = leaf.device
        i += n
    # zero blocks are made on the device of the blocks that were given
    return torch.cat([
        torch.zeros((p,), dtype=torch.float32, device=dev)
        if isinstance(p, int) else p for p in parts])


def unflatten_coeff(spec: FlatSpec, vec) -> Tuple:
    """Inverse of the column layout for a single (D,) vector: the
    (a1, a2, a3, b2, b3) block trees (point shapes, original dtypes)."""
    out = []
    i = 0
    for b_idx in range(len(_BLOCK_NAMES)):
        n = spec.nleaves[b_idx]
        leaves = [
            vec[spec.offsets[i + k]:spec.offsets[i + k] + spec.sizes[i + k]]
            .reshape(spec.shapes[i + k]).to(spec.dtypes[i + k])
            for k in range(n)]
        out.append(tree_unflatten(spec.tdefs[b_idx], leaves))
        i += n
    return tuple(out)


def _leaf_range(spec: FlatSpec, b_idx: int) -> Tuple[int, int]:
    start = sum(spec.nleaves[:b_idx])
    return start, start + spec.nleaves[b_idx]


# ---------------------------------------------------------------------------
# evaluation / contraction (all read the stored matrix)
# ---------------------------------------------------------------------------

def eval_cuts_flat(a_flat, v_flat, c, active, impl: str = None):
    """Per-slot cut values (A @ v - c) * active through `ops.cut_eval`:
    the CUDA kernels on CUDA tensors (differentiable to any order through
    the `cut_ad` Functions), the plain version on the CPU or when
    impl="ref"."""
    return ops.cut_eval(a_flat, v_flat, c, active, impl=impl)


def eval_cuts(cuts: FlatCuts, z1, z2, z3, X2=None, X3=None,
              impl: str = None):
    """Per-slot cut values  <a,z> + sum_j <b,x_j> - c  (0 for inactive):
    the stored matrix against the flattened point."""
    v = flatten_point(cuts.spec, z1, z2, z3, X2, X3)
    return eval_cuts_flat(cuts.a, v, cuts.c, cuts.active, impl=impl)


def cut_weighted_coeff_flat(spec: FlatSpec, a_flat, weights):
    """sum_l w_l * coeff_l for every block at once: one (P,)x(P,D)
    product, unflattened to the (a1, a2, a3, b2, b3) block trees (b-blocks
    keep the worker axis).  A plain product, as in the reference, where
    it is left to XLA outside any Pallas kernel."""
    return unflatten_coeff(spec, weights.float() @ a_flat)


def cut_coeff_per_worker(fc: FlatCuts, weights, block: str):
    """sum_l w[j,l] * b_{l,j}  ->  tree with leading worker axis (N, ...):
    the per-worker (stale-weight) contraction of Eq. 16, each b-block leaf
    a (P, N, ...) column slice of `fc.a` against the (N, P) weights."""
    spec = fc.spec
    w = (weights * fc.active[None, :]).float()                 # (N, P)
    b_idx = _BLOCK_NAMES.index(block)
    lo, hi = _leaf_range(spec, b_idx)
    p = fc.a.shape[0]
    leaves = []
    for i in range(lo, hi):
        col = fc.a[:, spec.offsets[i]:spec.offsets[i] + spec.sizes[i]]
        n = spec.shapes[i][0]
        col = col.reshape(p, n, -1)                            # (P, N, rest)
        out = torch.einsum("np,pnr->nr", w, col)
        leaves.append(out.reshape(spec.shapes[i]).to(spec.dtypes[i]))
    return tree_unflatten(spec.tdefs[b_idx], leaves)


# ---------------------------------------------------------------------------
# column partitions over the worker axis: shard views and growth
# ---------------------------------------------------------------------------

def n_a_leaves(spec: FlatSpec) -> int:
    """Number of leaves in the master (a1, a2, a3) blocks."""
    return sum(spec.nleaves[:3])


def _respec(spec: FlatSpec, worker_dim) -> FlatSpec:
    """`spec` with each b-leaf's leading worker dimension replaced by
    `worker_dim(n)`; a-leaves unchanged."""
    na = n_a_leaves(spec)
    shapes = tuple(shp if i < na else (worker_dim(int(shp[0])),) + shp[1:]
                   for i, shp in enumerate(spec.shapes))
    sizes = tuple(int(np.prod(s)) if s else 1 for s in shapes)
    offsets = tuple(int(o) for o in np.cumsum((0,) + sizes[:-1])) \
        if sizes else ()
    return FlatSpec(tdefs=spec.tdefs, nleaves=spec.nleaves, shapes=shapes,
                    dtypes=spec.dtypes, sizes=sizes, offsets=offsets,
                    d_total=sum(sizes))


def shard_spec(spec: FlatSpec, n_shards: int) -> FlatSpec:
    """The per-shard column layout: b-leaves carry N / n_shards workers."""
    def per_shard(n):
        if n % n_shards != 0:
            raise ValueError(
                f"worker axis {n} not divisible by {n_shards} shards")
        return n // n_shards
    return _respec(spec, per_shard)


def _cols(a, spec: FlatSpec, i: int):
    return a[..., spec.offsets[i]:spec.offsets[i] + spec.sizes[i]]


def shard_cuts(fc: FlatCuts, n_shards: int) -> FlatCuts:
    """The matrix partitioned by worker columns: `a` becomes
    (n_shards, P, D_loc), shard w holding the a-columns (replicated) and
    worker group w's b-columns, in the `shard_spec` layout; c / active /
    age stay replicated.  `unshard_cuts` inverts it bit for bit."""
    spec = fc.spec
    lspec = shard_spec(spec, n_shards)
    p = fc.a.shape[0]
    na = n_a_leaves(spec)
    parts = []
    for i in range(len(spec.sizes)):
        col = _cols(fc.a, spec, i)
        if i < na:
            parts.append(col[None].expand(n_shards, p, spec.sizes[i]))
        else:
            parts.append(col.reshape(p, n_shards, lspec.sizes[i])
                         .permute(1, 0, 2))
    return FlatCuts(a=torch.cat(parts, dim=-1), c=fc.c, active=fc.active,
                    age=fc.age, spec=lspec)


def unshard_cuts(fc: FlatCuts, spec: FlatSpec) -> FlatCuts:
    """Inverse of `shard_cuts`: the canonical (P, D) matrix from the
    (n_shards, P, D_loc) column groups (`spec` is the global layout)."""
    lspec = fc.spec
    p = fc.a.shape[1]
    na = n_a_leaves(spec)
    cols = []
    for i in range(len(spec.sizes)):
        col = _cols(fc.a, lspec, i)
        cols.append(col[0] if i < na else
                    col.permute(1, 0, 2).reshape(p, spec.sizes[i]))
    return FlatCuts(a=torch.cat(cols, dim=-1), c=fc.c, active=fc.active,
                    age=fc.age, spec=spec)


def grow_spec(spec: FlatSpec, n_new: int) -> FlatSpec:
    """The column layout after growing the worker axis to `n_new`
    (growth only: shrinking would discard live b-columns)."""
    def grown(n):
        if n > int(n_new):
            raise ValueError(f"grow_spec: worker axis {n} > target "
                             f"{n_new} (membership only grows)")
        return int(n_new)
    return _respec(spec, grown)


def grow_cuts(fc: FlatCuts, n_new: int) -> FlatCuts:
    """The polytope over `n_new` workers: a-columns, c, active and age
    copied, existing workers' b-columns kept, the newcomers' b-columns
    zero.  Exact: a zero coefficient adds nothing to any contraction."""
    spec = fc.spec
    gspec = grow_spec(spec, n_new)
    p = fc.a.shape[0]
    na = n_a_leaves(spec)
    parts = []
    for i in range(len(spec.sizes)):
        col = _cols(fc.a, spec, i)
        if i < na:
            parts.append(col)
            continue
        n_old = spec.shapes[i][0]
        per = spec.sizes[i] // max(1, n_old)
        wide = fc.a.new_zeros((p, int(n_new), per))
        wide[:, :n_old] = col.reshape(p, n_old, per)
        parts.append(wide.reshape(p, gspec.sizes[i]))
    return FlatCuts(a=torch.cat(parts, dim=-1), c=fc.c, active=fc.active,
                    age=fc.age, spec=gspec)
