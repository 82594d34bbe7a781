"""Epoch-shuffled batches of a host-resident array dict on a device.

Counterpart of `repro/data/loader.py` without a device mesh: a batch is
placed whole on one `device`.  Placing it across a worker mesh is part
of the sharded engine, not ported yet (ROADMAP.md Queue 1, item 6).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


class ShardedLoader:
    """Deterministic epoch-shuffled loader over a dict of equal-length
    arrays: yields dicts of (batch_size, ...) tensors on `device` (CUDA
    unless the caller names another).

    Epoch k's order is `np.random.default_rng((seed, k)).permutation`,
    as in the reference: a pure function of (seed, epoch), so restarting
    at epoch k reproduces its order, and an epoch's index is claimed when
    its iterator is made, so interleaved iterators do not disturb each
    other."""

    def __init__(self, arrays: dict, batch_size: int, seed: int = 0,
                 mesh=None, spec=None, drop_last: bool = True, device=None):
        if mesh is not None or spec is not None:
            raise NotImplementedError(
                "ShardedLoader(mesh=, spec=): placing batches across a "
                "worker mesh is not ported yet (ROADMAP.md Queue 1, item 6)")
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"ragged arrays: {sizes}")
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self.n = next(iter(sizes.values()))
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self.device = resolve_device(device)
        self._epoch = 0

    def __iter__(self) -> Iterator[dict]:
        epoch, self._epoch = self._epoch, self._epoch + 1
        idx = np.random.default_rng((self.seed, epoch)).permutation(self.n)
        return self._iter_epoch(idx)

    def _iter_epoch(self, idx) -> Iterator[dict]:
        stop = (self.n - self.batch_size + 1) if self.drop_last else self.n
        for s in range(0, max(stop, 0), self.batch_size):
            take = idx[s: s + self.batch_size]
            yield {k: torch.as_tensor(v[take], device=self.device)
                   for k, v in self.arrays.items()}
