"""Pytree helpers over dicts, lists, tuples and tensor leaves.

Leaves are ordered as `jax.tree.leaves` orders them: dict entries by
SORTED key, sequences in order, `None` as an empty subtree, and a node
registered with `torch.utils._pytree` (the state dataclasses of
`core.types`) by its children, in field order as the reference registers
them.  The order matters: it fixes the column layout of every flattened
cut (`FlatSpec`) and the leaf numbering of a checkpoint, and
`torch.utils._pytree` keeps dict insertion order instead (an MLP built
as w0, b0, w1, b1 would flatten permuted against the reference).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Tuple

import torch
import torch.utils._pytree as pytree

# A treedef is a nested tuple: ("*",) for a leaf, ("none",),
# ("dict", keys, children), ("list"|"tuple", children) or ("node", type,
# context, children) for a registered pytree node.
_LEAF = ("*",)
_NONE = ("none",)


def _walk(t, leaves: List[Any]) -> tuple:
    if t is None:
        return _NONE
    if isinstance(t, dict):
        keys = tuple(sorted(t))
        return ("dict", keys, tuple(_walk(t[k], leaves) for k in keys))
    if isinstance(t, (list, tuple)):
        kind = "list" if isinstance(t, list) else "tuple"
        return (kind, tuple(_walk(x, leaves) for x in t))
    node = pytree.SUPPORTED_NODES.get(type(t))
    if node is not None:
        children, ctx = node.flatten_fn(t)
        return ("node", type(t), ctx,
                tuple(_walk(c, leaves) for c in children))
    leaves.append(t)
    return _LEAF


def tree_flatten(tree) -> Tuple[List[Any], tuple]:
    # module-level recursion: a nested recursive closure would form a
    # reference cycle holding the leaves until the cyclic collector runs,
    # which keeps multi-GB tensors alive on the device
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def _build(d, it) -> Any:
    if d == _LEAF:
        return next(it)
    if d == _NONE:
        return None
    if d[0] == "dict":
        return {k: _build(c, it) for k, c in zip(d[1], d[2])}
    if d[0] == "node":
        return pytree.SUPPORTED_NODES[d[1]].unflatten_fn(
            [_build(c, it) for c in d[3]], d[2])
    seq = [_build(c, it) for c in d[1]]
    return seq if d[0] == "list" else tuple(seq)


def tree_unflatten(tdef: tuple, leaves) -> Any:
    return _build(tdef, iter(leaves))


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """Apply `fn` leafwise over trees of `tree`'s structure."""
    leaves, tdef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(tdef, [fn(*xs) for xs in zip(leaves, *others)])


class DictKey(NamedTuple):
    key: Any


class SequenceKey(NamedTuple):
    idx: int


class GetAttrKey(NamedTuple):
    name: str


def _paths(t, prefix: tuple, out: List[Tuple[tuple, Any]]) -> None:
    if t is None:
        return
    if isinstance(t, dict):
        for k in sorted(t):
            _paths(t[k], prefix + (DictKey(k),), out)
    elif isinstance(t, (list, tuple)):
        for i, x in enumerate(t):
            _paths(x, prefix + (SequenceKey(i),), out)
    elif type(t) in pytree.SUPPORTED_NODES:
        for f, c in zip(dataclasses.fields(t),
                        pytree.SUPPORTED_NODES[type(t)].flatten_fn(t)[0]):
            _paths(c, prefix + (GetAttrKey(f.name),), out)
    else:
        out.append((prefix, t))


def tree_leaves_with_path(tree) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs in `tree_leaves` order, as
    `jax.tree_util.tree_leaves_with_path` gives them: a path is a tuple
    of `DictKey` / `SequenceKey` / `GetAttrKey` (a registered state
    dataclass's field) entries."""
    out: List[Tuple[tuple, Any]] = []
    _paths(tree, (), out)
    return out


def weak(s, x):
    """The Python number s as a 0-d CPU tensor of x's dtype, for `s * x`:
    JAX rounds a Python scalar to a bf16 operand's type before the
    product (a weak type), where torch would multiply by the scalar in
    f32 and round once after."""
    return torch.tensor(s, dtype=x.dtype)


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
# derivatives over trees
# ---------------------------------------------------------------------------

def grad(fn, *args):
    """The gradient of the scalar fn(*args) w.r.t. every argument tree, a
    tuple of trees shaped as `args` (zeros where fn does not depend on a
    leaf), by `torch.func.grad`, as the reference takes `jax.grad`: a
    partial derivative at the arguments whatever else fn closes over,
    itself differentiable by any outer transform or autograd, and
    composable with `torch.func.vmap`."""
    return torch.func.grad(fn, argnums=tuple(range(len(args))))(*args)


def value_and_grad(fn, *args, has_aux: bool = False):
    """(fn(*args), `grad(fn, *args)`) in one evaluation.  With has_aux,
    fn returns (value, aux) and so does the first element."""
    grads, val = torch.func.grad_and_value(
        fn, argnums=tuple(range(len(args))), has_aux=has_aux)(*args)
    return val, grads
