"""Pytree helpers over dicts, lists, tuples and tensor leaves.

Leaves are ordered as `jax.tree.leaves` orders them: dict entries by
SORTED key, sequences in order, `None` as an empty subtree.  The order
matters: it fixes the column layout of every flattened cut (`FlatSpec`),
and `torch.utils._pytree` keeps dict insertion order instead (an MLP
built as w0, b0, w1, b1 would flatten permuted against the reference).
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

# A treedef is a hashable nested tuple: ("*",) for a leaf, ("none",),
# ("dict", keys, children) or ("list"|"tuple", children).
_LEAF = ("*",)
_NONE = ("none",)


def tree_flatten(tree) -> Tuple[List[Any], tuple]:
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return _NONE
        if isinstance(t, dict):
            keys = tuple(sorted(t))
            return ("dict", keys, tuple(walk(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            kind = "list" if isinstance(t, list) else "tuple"
            return (kind, tuple(walk(x) for x in t))
        leaves.append(t)
        return _LEAF

    tdef = walk(tree)
    return leaves, tdef


def tree_unflatten(tdef: tuple, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        if d == _LEAF:
            return next(it)
        if d == _NONE:
            return None
        if d[0] == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        seq = [build(c) for c in d[1]]
        return seq if d[0] == "list" else tuple(seq)

    return build(tdef)


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """Apply `fn` leafwise over trees of `tree`'s structure."""
    leaves, tdef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(tdef, [fn(*xs) for xs in zip(leaves, *others)])


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_axpy(s, a, b):
    """b + s * a, elementwise over matching trees."""
    return tree_map(lambda x, y: y + s * x, a, b)


def tree_dot(a, b):
    """Full inner product <a, b> across every leaf (f32 accumulate)."""
    parts = [torch.sum(x.float() * y.float())
             for x, y in zip(tree_leaves(a), tree_leaves(b))]
    if not parts:
        return torch.zeros((), dtype=torch.float32)
    return torch.sum(torch.stack(parts))


def tree_norm_sq(a):
    return tree_dot(a, a)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_index(tree, j):
    """Row j of every leaf (one worker's slice of a stacked tree)."""
    return tree_map(lambda x: x[j], tree)


# ---------------------------------------------------------------------------
# autograd over trees
# ---------------------------------------------------------------------------

def grad_point(tree, keep_graph: bool = False):
    """The point to differentiate at, as fresh graph nodes: a gradient
    w.r.t. them is the partial derivative at this point, even where
    other inputs of the function (a dual computed from the same
    variables) were derived from the same tensors.  With `keep_graph`, a
    leaf that already carries a graph stays attached to it (through a
    view), so the gradient can itself be differentiated w.r.t. what the
    leaf depends on; every other leaf is detached."""
    def prep(x):
        if keep_graph and x.requires_grad:
            return x.view_as(x)
        return x.detach().requires_grad_(True)
    return tree_map(prep, tree)


def tree_grad(out, trees, create_graph: bool = False):
    """d out / d (each tree): one gradient tree per input tree, zeros
    where `out` does not depend on a leaf."""
    flat = [tree_flatten(t) for t in trees]
    leaves = [l for ls, _ in flat for l in ls]
    gs = torch.autograd.grad(out, leaves, create_graph=create_graph,
                             allow_unused=True)
    gs = [torch.zeros_like(l) if g is None else g
          for l, g in zip(leaves, gs)]
    res, i = [], 0
    for ls, tdef in flat:
        res.append(tree_unflatten(tdef, gs[i:i + len(ls)]))
        i += len(ls)
    return res
