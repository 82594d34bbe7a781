"""Epoch-shuffled batches of a host-resident array dict on a device, or
split over a worker mesh.

Counterpart of `repro/data/loader.py`.  Without a mesh a batch is placed
whole on one `device`.  With a `launch.mesh.WorkerMesh` each shard
(process) receives its contiguous block of the rows of the global batch
on the mesh's device, the counterpart of `shard_batch` placing the
batch axis over the mesh's devices.
"""
from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


def _splits(mesh, spec) -> bool:
    """Whether `spec` splits the leading dimension over `mesh`."""
    spec = (mesh.axis_name,) if spec is None else tuple(spec)
    if any(a is not None for a in spec[1:]) or \
            (spec and spec[0] not in (None, mesh.axis_name)):
        raise ValueError(f"spec {spec}: only the leading dimension splits, "
                         f"over the mesh axis {mesh.axis_name!r}")
    return bool(spec) and spec[0] is not None


def _rows_per_shard(n: int, mesh) -> int:
    if n % mesh.size != 0:
        raise ValueError(f"a batch of {n} rows does not split over a "
                         f"{mesh.size}-shard mesh")
    return n // mesh.size


def shard_batch(batch: dict, mesh, spec: Optional[Sequence] = None) -> dict:
    """This shard's part of a host batch, on the mesh's device.  `spec`
    names a mesh axis (or None) per leading dimension, as a
    `PartitionSpec`: the batch dimension splits over the mesh when its
    entry is the mesh's axis and is whole on every shard when None; the
    default splits it.  Only the leading dimension may split."""
    split = _splits(mesh, spec)
    out = {}
    for k, v in batch.items():
        if split:
            per = _rows_per_shard(len(v), mesh)
            v = v[mesh.rank * per:(mesh.rank + 1) * per]
        out[k] = torch.as_tensor(v, device=mesh.device)
    return out


class ShardedLoader:
    """Deterministic epoch-shuffled loader over a dict of equal-length
    arrays: yields dicts of (batch_size, ...) tensors on `device` (CUDA
    unless the caller names another); with a worker `mesh`, this shard's
    rows of each batch on the mesh's device (`shard_batch`, `spec` as
    there).

    Epoch k's order is `np.random.default_rng((seed, k)).permutation`,
    as in the reference: a pure function of (seed, epoch), so restarting
    at epoch k reproduces its order, and an epoch's index is claimed when
    its iterator is made, so interleaved iterators do not disturb each
    other."""

    def __init__(self, arrays: dict, batch_size: int, seed: int = 0,
                 mesh=None, spec=None, drop_last: bool = True, device=None):
        if mesh is None and spec is not None:
            raise ValueError("ShardedLoader(spec=) needs a mesh")
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"device {mesh.device}")
            if _splits(mesh, spec):
                _rows_per_shard(batch_size, mesh)
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged arrays: {sizes}")
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self.n = next(iter(sizes.values()))
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self.mesh, self.spec = mesh, spec
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self._epoch = 0

    def __iter__(self) -> Iterator[dict]:
        epoch, self._epoch = self._epoch, self._epoch + 1
        idx = np.random.default_rng((self.seed, epoch)).permutation(self.n)
        return self._iter_epoch(idx)

    def _iter_epoch(self, idx) -> Iterator[dict]:
        stop = (self.n - self.batch_size + 1) if self.drop_last else self.n
        for s in range(0, max(stop, 0), self.batch_size):
            take = idx[s: s + self.batch_size]
            batch = {k: v[take] for k, v in self.arrays.items()}
            if self.mesh is not None:
                yield shard_batch(batch, self.mesh, self.spec)
            else:
                yield {k: torch.as_tensor(v, device=self.device)
                       for k, v in batch.items()}
