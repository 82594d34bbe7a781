"""Count-sketch compression of mu-cut coefficients (beyond-paper).

Counterpart of `repro/fed/sketch.py`.  The x2/z2 and x3/z3 blocks of the
cut space are restricted to a fixed r-dimensional count-sketch subspace:

    S(v)[k] = sum_{i : h(i)=k} sigma_i * v_i,

with h / sigma from a seeded integer hash of each element's flat index
(no projection matrix is ever built).  Buckets and signs are bitwise the
reference's: the reference hashes in uint32, which torch can hardly do
arithmetic on, so the hash runs in int64 and is masked to 32 bits after
every multiply and xor-shift.  Each leaf is hashed in slices of its flat
index (`SLICE` elements), so the transient index and sign tensors stay
bounded (Llama-3 8B's embedding alone has 525M elements); the hash
depends only on the flat index, so slicing moves no bucket.

Accumulation.  On the CPU each leaf's buckets are summed in f32 in
flat-index order (`index_add_`) and the leaves' sums added in leaf
order, the reference's order, so the sketch is bitwise the
reference's.  On the card a float scatter-add is not deterministic
(its atomics land in any order) and the port's resume and chunk
contracts are bitwise, so each value is rounded (in f64) to a 64-bit
fixed-point integer whose scale leaves every bucket sum below 2^62 (set
on the device from the largest magnitude of the tree), the integers are
scatter-added (integer addition is associative: any order gives the same
bits), and the exact integer sums are converted back to f32.  The fixed
point's step is at most 2^-60 of the sum of |v| over the tree, far
below an f32 ulp of a bucket, so the card's sketch is the correctly
rounded sum up to that step, where the CPU's carries f32 rounding.  On
the card a row holding a non-finite value sketches to NaN in every
bucket (decided on the device: the host never waits on it).  Meta
tensors (`launch.dryrun`) take the card's path.

Blocks of rows.  A worker mesh (`fed.trilevel_llm_sharded`) holds
rows [j0, j1) of a worker-stacked tree such as z2, whose sketch is one
flat vector over every row.  `sketch_rows(..., start=j0)` hashes such
a block at its global flat indices and `unsketch_rows(..., start=j0)`
lifts into its rows, so the shards' partial sketches sum to the
whole's and the lift of a block is the block of the whole's lift.  On
the card a sum of f32 partials would round where the whole does not,
so a mesh sums the fixed-point integers instead, at one scale that
every shard takes from the largest magnitude over the mesh
(`block_amax`, `shared_scale`, `fixed_point_sums`, `from_fixed_point`):
integer addition is exact, and the sum is bit for bit the whole's.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch.utils.tree import tree_flatten, tree_unflatten

_MIX1 = 2654435761
_MIX2 = 2246822519
_MIX3 = 3266489917
_M32 = 0xFFFFFFFF
# flat-index slice hashed at a time: 2^24 elements, 128 MB a transient
# int64 tensor
SLICE = 1 << 24


def _mix(x: torch.Tensor, seed: int) -> torch.Tensor:
    """The reference's uint32 avalanche hash on int64 values < 2^32
    (int64 products wrap mod 2^64, whose low 32 bits are the uint32
    product's)."""
    h = (x * _MIX1 + seed) & _M32
    h = h ^ (h >> 15)
    h = (h * _MIX2) & _M32
    h = h ^ (h >> 13)
    h = (h * _MIX3) & _M32
    return h ^ (h >> 16)


def hashes(lo: int, hi: int, leaf_seed: int, r: int, device
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bucket int64, sign f32) of flat indices [lo, hi) of a leaf."""
    h = _mix(torch.arange(lo, hi, dtype=torch.int64, device=device),
             leaf_seed)
    sign = torch.where((h >> 31) > 0, 1.0, -1.0).to(torch.float32)
    return h % r, sign


def leaf_hashes(shape, leaf_seed: int, r: int, device=None):
    """(idx int32, sign f32) of a whole leaf, shaped like it: the
    reference's `_leaf_hashes`."""
    n = 1
    for s in shape:
        n *= int(s)
    idx, sign = hashes(0, n, leaf_seed, r, device)
    return idx.to(torch.int32).reshape(shape), sign.reshape(shape)


def leaf_seeds(n_leaves: int, seed: int) -> List[int]:
    return [(seed * 1_000_003 + 7919 * i + 1) % (2 ** 32)
            for i in range(n_leaves)]


def _slices(n: int):
    for lo in range(0, n, SLICE):
        yield lo, min(lo + SLICE, n)


def fixed_point(device) -> bool:
    """Whether sketches on `device` sum in 64-bit fixed point (every
    device but the CPU; see the module docstring)."""
    return torch.device(device).type != "cpu"


def _row_amax(rows: List[torch.Tensor]) -> torch.Tensor:
    """(B,) f64: each row's largest magnitude over the leaves (NaN or inf
    where the row holds one)."""
    return torch.stack([x.abs().amax(dim=1).double() for x in rows]
                       ).amax(dim=0)


def shared_scale(amax: torch.Tensor, n: int):
    """(2^s as an f64 tensor, (B,) bool: the row is finite) from rows'
    largest magnitudes `amax` (B,) and the elements `n` of a row: the
    largest power of two with n * max|v| * 2^s <= 2^61 over the finite
    rows, so each bucket sum of rounded values stays below 2^62.
    Products run in f64, whose range holds 2^s for every f32 magnitude
    (an all-zero tree sums to 0 at any scale)."""
    finite = torch.isfinite(amax)
    amax = torch.where(finite, amax, torch.zeros_like(amax)).amax()
    # frexp: total = m * 2^e, m in [0.5, 1) -> total < 2^e
    _, e = torch.frexp(torch.clamp(amax * n, min=2.0 ** -200))
    scale = torch.ldexp(torch.ones((), dtype=torch.float64,
                                   device=amax.device), 61 - e)
    return scale, finite


def _fixed_point_scale(rows: List[torch.Tensor]):
    """`shared_scale` of flat rows (B, n_i)."""
    return shared_scale(_row_amax(rows), sum(x.shape[1] for x in rows))


def _fixed_sums(rows, seeds, starts, r: int, scale, finite) -> torch.Tensor:
    """(B, r) int64: the bucket sums of the rows' values rounded to the
    fixed point `scale` (a non-finite row's integers are zeroed: their
    cast is undefined)."""
    dev = rows[0].device
    acc = torch.zeros((rows[0].shape[0], r), dtype=torch.int64, device=dev)
    for x, s, st in zip(rows, seeds, starts):
        for lo, hi in _slices(x.shape[1]):
            idx, sign = hashes(st + lo, st + hi, s, r, dev)
            q = torch.round(x[:, lo:hi].double() * sign * scale)
            q = torch.where(finite[:, None], q, torch.zeros_like(q))
            acc.index_add_(1, idx, q.to(torch.int64))
    return acc


def from_fixed_point(acc: torch.Tensor, scale, finite) -> torch.Tensor:
    """f32 sketches of fixed-point bucket sums `acc` (B, r) or (r,); a
    non-finite row's buckets are NaN."""
    out = (acc.double() / scale).float()
    return torch.where(finite.reshape(finite.shape + (1,) * (
        out.dim() - finite.dim())), out, torch.full_like(out, float("nan")))


def _accumulate(rows, seeds, r: int, starts) -> torch.Tensor:
    """(B, r) f32 sketches of flat rows (B, n_i), leaf i hashed with
    seeds[i] from flat index starts[i] (see the module docstring for the
    two accumulations)."""
    dev = rows[0].device
    b = rows[0].shape[0]
    # the card's path; meta tensors (the dry-run's) take it too, so that
    # the dry-run counts what the card runs
    if fixed_point(dev):
        scale, finite = _fixed_point_scale(rows)
        acc = _fixed_sums(rows, seeds, starts, r, scale, finite)
        return from_fixed_point(acc, scale, finite)
    out = torch.zeros((b, r), dtype=torch.float32, device=dev)
    for x, s, st in zip(rows, seeds, starts):
        part = torch.zeros_like(out)
        for lo, hi in _slices(x.shape[1]):
            idx, sign = hashes(st + lo, st + hi, s, r, dev)
            part.index_add_(1, idx, x[:, lo:hi].float() * sign)
        out = out + part
    return out


def _lift(s_rows, seeds, meta):
    """The adjoint of `_accumulate`: (B, r) -> flat rows (B, n_i) of
    dtype_i, meta[i] = (n_i, dtype_i, start_i)."""
    r = s_rows.shape[1]
    out = []
    for (n, dtype, st), sd in zip(meta, seeds):
        flat = torch.empty((s_rows.shape[0], n), dtype=dtype,
                           device=s_rows.device)
        for lo, hi in _slices(n):
            idx, sign = hashes(st + lo, st + hi, sd, r, s_rows.device)
            flat[:, lo:hi] = (s_rows[:, idx] * sign).to(dtype)
        out.append(flat)
    return out


class _Sketch(torch.autograd.Function):
    """rows -> (B, r); its derivative is `_Lift` (a gather), whose own
    derivative is this again, so every order of AD stays in these two
    deterministic maps."""

    @staticmethod
    def forward(r, seeds, starts, *rows):
        return _accumulate(rows, seeds, r, starts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, seeds, starts, *rows = inputs
        ctx.seeds = seeds
        ctx.meta = [(x.shape[1], x.dtype, st) for x, st in zip(rows, starts)]

    @staticmethod
    def backward(ctx, g):
        return (None, None, None) + tuple(
            _Lift.apply(g, ctx.seeds, ctx.meta))


class _Lift(torch.autograd.Function):
    @staticmethod
    def forward(s_rows, seeds, meta):
        return tuple(_lift(s_rows, seeds, meta))

    @staticmethod
    def setup_context(ctx, inputs, output):
        s_rows, seeds, meta = inputs
        ctx.seeds, ctx.meta = seeds, meta
        ctx.shape = (s_rows.shape[0], s_rows.shape[1])
        ctx.device = s_rows.device

    @staticmethod
    def backward(ctx, *grads):
        b, r = ctx.shape
        rows = [g if g is not None else
                torch.zeros((b, n), dtype=dt, device=ctx.device)
                for g, (n, dt, _) in zip(grads, ctx.meta)]
        return _Sketch.apply(r, ctx.seeds, [st for *_, st in ctx.meta],
                             *rows), None, None


def _starts(leaves, start: int, batch_dims: int) -> List[int]:
    """Each leaf's first flat index in its whole leaf, for a block that
    holds rows [start, ...) of a tree whose leaves lead with the worker
    axis."""
    if start and batch_dims:
        raise ValueError("a block start needs batch_dims = 0: per-row "
                         "sketches hash every row alike")
    return [start * (x.numel() // x.shape[0]) if start else 0
            for x in leaves]


def sketch_rows(tree: Any, seed: int, r: int, batch_dims: int = 0,
                start: int = 0) -> torch.Tensor:
    """Count-sketch every row of a tree: with batch_dims = 1 the leaves
    lead with a shared (B,) axis and the result is (B, r), row b the
    sketch of the tree's b-th slice (the reference's `vmap(sketch)`);
    with batch_dims = 0 it is (r,).  With `start` the tree is rows
    [start, ...) of a worker-stacked tree, hashed at their flat indices
    there: the blocks' sketches sum to the whole's.  Differentiable to
    any order."""
    leaves, _ = tree_flatten(tree)
    b = int(leaves[0].shape[0]) if batch_dims else 1
    out = _Sketch.apply(r, leaf_seeds(len(leaves), seed),
                        _starts(leaves, start, batch_dims),
                        *(x.reshape(b, -1) for x in leaves))
    return out if batch_dims else out[0]


def sketch(tree: Any, seed: int, r: int) -> torch.Tensor:
    """Count-sketch a tree into an (r,) f32 vector."""
    return sketch_rows(tree, seed, r)


def unsketch_rows(template: Any, s_rows: torch.Tensor, seed: int,
                  batch_dims: int = 0, start: int = 0) -> Any:
    """Adjoint of `sketch_rows`: (r,) -> a tree like `template`, or with
    batch_dims = 1 (B, r) -> a tree whose leaves lead with (B,) (the
    reference's `vmap(lambda c: unsketch(template, c, seed))`).  With
    `start`, `template` is rows [start, ...) of a worker-stacked tree and
    the result is those rows of the whole's lift."""
    rows = s_rows if batch_dims else s_rows[None]
    leaves, tdef = tree_flatten(template)
    meta = [(leaf.numel(), leaf.dtype, st) for leaf, st in
            zip(leaves, _starts(leaves, start, batch_dims))]
    flat = _Lift.apply(rows, leaf_seeds(len(leaves), seed), meta)
    lead = (rows.shape[0],) if batch_dims else ()
    return tree_unflatten(tdef, [f.reshape(lead + tuple(leaf.shape))
                                 for f, leaf in zip(flat, leaves)])


def unsketch(template: Any, s_vec: torch.Tensor, seed: int) -> Any:
    """Adjoint of `sketch`: lift an (r,) vector back to the tree space.

    unsketch(t, sketch(v)) has <unsketch, w> == <sketch(v), sketch(w)>,
    so using it as a gradient is exactly 'the cut acts in sketch space'.
    """
    return unsketch_rows(template, s_vec, seed)


def block_amax(tree: Any) -> torch.Tensor:
    """(1,) f64: the largest magnitude of a block (NaN or inf if it holds
    one), what each shard contributes to `shared_scale`."""
    leaves, _ = tree_flatten(tree)
    return _row_amax([x.reshape(1, -1) for x in leaves])


def fixed_point_sums(tree: Any, seed: int, r: int, start: int, scale,
                     finite) -> torch.Tensor:
    """(r,) int64: a block's bucket sums at the fixed point `scale` (from
    `shared_scale` over the mesh), hashed at the block's global flat
    indices as `sketch_rows(..., start=)`; summed over the blocks and
    passed to `from_fixed_point` they give the whole's sketch bit for
    bit."""
    leaves, _ = tree_flatten(tree)
    return _fixed_sums([x.reshape(1, -1) for x in leaves],
                       leaf_seeds(len(leaves), seed),
                       _starts(leaves, start, 0), r, scale,
                       finite.reshape(1))[0]


def sketch_dot(s_a: torch.Tensor, s_b: torch.Tensor) -> torch.Tensor:
    return torch.sum(s_a * s_b)
