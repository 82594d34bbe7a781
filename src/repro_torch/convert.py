"""Carry weights and state between the JAX package and the port.

The two packages meet only through numpy: the reference's trees (MLP
parameters, problem data, a whole `AFTOState`, an LLM's parameter tree)
are handed over as numpy arrays, or anything `np.asarray` accepts, and
come back as numpy for comparison.  No jax import is needed; a reference
state is read by its field names, which the port's dataclasses share.

Streams: the port cannot draw the reference's `jax.random` batches, so
`stream_from_reference` hands them over as a table, each worker row
keyed by (iteration, worker), behind a port `Stream`.

bf16: `np.array` of a JAX bf16 array has the `ml_dtypes` bfloat16 dtype,
which torch refuses; such a leaf crosses as its 16-bit patterns viewed
as `torch.bfloat16`, so the numbers do not change.  Coming back, a bf16
tensor becomes f32 numpy, which holds every bf16 value exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cuts import spec_from_templates
from repro_torch.data import stream as stream_lib
from repro_torch.utils.tree import tree_flatten, tree_unflatten
from repro_torch.core.types import (AFTOState, FlatCuts, InnerState2,
                                    InnerState3, StaleView)

# the nested containers of an AFTOState, by field name
_NESTED = {"cuts_i": FlatCuts, "cuts_ii": FlatCuts, "inner3": InnerState3,
           "inner2": InnerState2, "stale": StaleView}


def to_torch(tree, device):
    """A tree of arrays (dicts, lists, tuples, None) as tensors on
    `device`, dtypes kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    arr = np.array(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.as_tensor(arr, device=device)


def to_numpy(tree):
    """Tensors, trees of them and the port's state dataclasses as numpy
    arrays; a dataclass becomes a dict by field name (a `FlatSpec` is
    dropped)."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree):
        return {f.name: to_numpy(getattr(tree, f.name))
                for f in dataclasses.fields(tree) if f.name != "spec"}
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if tree.dtype == torch.bfloat16:
        tree = tree.float()
    return tree.detach().cpu().numpy()


def params_from_reference(tree, device):
    """An LLM parameter tree of the reference (`repro.models.
    init_params`; dicts and lists of arrays, bf16 included) as the port's
    tree of tensors on `device`: the same keys, layouts and values."""
    return to_torch(tree, device)


def params_to_numpy(params):
    """The port's parameter tree as numpy (bf16 widened to f32)."""
    return to_numpy(params)


def state_from_reference(ref, device) -> AFTOState:
    """The port's `AFTOState` from a reference state whose leaves are
    numpy-convertible (e.g. `jax.tree.map(np.asarray, state)`).  The cut
    layout is rebuilt from the converted z's, in the same column order
    as the reference's."""
    z1, z2, z3 = (to_torch(getattr(ref, k), device)
                  for k in ("z1", "z2", "z3"))
    n = int(np.asarray(ref.stale.t_hat).shape[0])
    spec = spec_from_templates(n, z1, z2, z3)

    def build(cls, obj):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name == "spec":
                kw["spec"] = spec
            elif f.name in _NESTED:
                kw[f.name] = build(_NESTED[f.name], getattr(obj, f.name))
            else:
                kw[f.name] = to_torch(getattr(obj, f.name), device)
        return cls(**kw)

    return build(AFTOState, ref)


def stream_from_reference(batches, device="cpu"):
    """A port `Stream` (seed 0) that gives the reference's batches.

    `batches[it]` is the reference's (N, ...) batch of iteration `it`
    (`repro.data.stream.next_batch(stream, it)`, as numpy).  Worker j's
    row of it is stored under the port's key `worker_key(0, it, j)`,
    and the stream's sampler looks rows up by key, so the port's engines
    draw exactly the reference's row wherever the reference folds on
    (it, j).  A key outside the table raises `KeyError`."""
    table = {}
    n_workers = None
    for it, batch in enumerate(batches):
        rows = to_torch(batch, device)
        leaves, tdef = tree_flatten(rows)
        n_workers = int(leaves[0].shape[0])
        for j in range(n_workers):
            table[stream_lib.worker_key(0, it, j)] = tree_unflatten(
                tdef, [x[j] for x in leaves])

    def sample(key, device):
        return table[key]

    return stream_lib.make_stream(sample, n_workers, 0)
