"""Data streams: each iteration's worker batches drawn on the device from
a fixed integer key.

Counterpart of `repro/data/stream.py`.  A `Stream` stands in for the
resident `problem.data` arrays: the engines (`core.engine.run_scanned` /
`run_chunked` / `run_swept(data=...)`, the eager runner) draw every
iteration's worker batches on the problem's device, so every worker sees
fresh samples each round and a chunk boundary moves nothing.

The key rules (what `tests/test_torch_stream.py` checks follows from
them):

  * `Stream.key` is the BASE key, an integer that is never advanced.
    Batches come from a pure mix of integers (`worker_key`), never from a
    generator carried forward, nor from Python's `hash()` or any other
    state of the process.
  * worker j's row at an iteration is keyed on j's ABSOLUTE consumption
    time, `state.stale.t_hat[j]`: the master iteration at which j's
    current local point was handed out.  So any chunk partition of a
    trajectory draws the same rows (t_hat rides the state), a fixed seed
    draws the same rows in every process, and an asynchronous worker can
    rebuild its batch from the `t` of the point it was sent.
  * the key then folds in the GLOBAL worker index, so a block of workers
    (`worker_offset`, `n_local`) draws exactly its rows of the full batch.

`StreamSpec.sample(key, device) -> data_j` draws ONE worker's slice from
its 64-bit key; the stock samplers seed one `torch.Generator` on that
device with it.  CUDA's and the CPU's generators differ, so a batch is
fixed per device type, not across device types.  The port cannot draw
the reference's `jax.random` batches; a sampler that looks rows up in a
table keyed by (iteration, worker) feeds it the reference's instead
(`repro_torch.convert.stream_from_reference`).

Batches are drawn on the host's schedule, outside `torch.func` transforms
(`vmap` refuses random ops): the engines keep a host mirror of
`state.stale.t_hat`, so drawing a batch needs no device sync.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_flatten, tree_unflatten

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """How to draw ONE worker's per-iteration slice.

    sample    : (key: int, device) -> data_j tree of tensors; the key
                already encodes (base key, iteration, worker).
    n_workers : global worker count N; batches lead with (N, ...) like
                `problem.data`.
    """
    sample: Callable
    n_workers: int


@dataclasses.dataclass(frozen=True)
class Stream:
    """A data stream: an integer base key and its spec.  Re-seed with
    `dataclasses.replace(stream, key=...)`; the spec stays the same."""
    key: int
    spec: Optional[StreamSpec] = None


def make_stream(sample: Callable, n_workers: int, seed: int = 0) -> Stream:
    """A Stream from a per-worker sampler and an integer seed."""
    return Stream(key=int(seed) & _MASK64,
                  spec=StreamSpec(sample=sample, n_workers=int(n_workers)))


def _splitmix64(x: int) -> int:
    """One splitmix64 output for the 64-bit state x (Steele et al.)."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _fold_in(key: int, data: int) -> int:
    """A new 64-bit key from `key` and the integer `data`."""
    return _splitmix64((int(key) & _MASK64) ^ _splitmix64(int(data) & _MASK64))


def worker_key(key: int, it: int, j: int) -> int:
    """The key of worker j's row at iteration `it`: folded, never
    iterated."""
    return _fold_in(_fold_in(key, it), j)


def batch_at(spec: StreamSpec, key: int, it, worker_offset: int = 0,
             n_local: Optional[int] = None, device=None):
    """The (..., n_local, ...)-stacked batch for iteration(s) `it`.

    `it` is a scalar (one iteration for the whole block), a vector of
    length n_local (each row at its own consumption time: the engines
    pass the `t_hat` mirror), or an (R, n_local) array (one row of times
    per run of a sweep; the batch then leads with (R, n_local)).  A
    scalar gives the same rows as a vector of that value.

    worker_offset / n_local select the contiguous block of global workers
    [worker_offset, worker_offset + n_local); the defaults give the full
    (N, ...) batch.  A row depends only on (key, its time, its global
    worker index), never on the layout.  Rows with equal keys are drawn
    once, and each row is copied into the batch as it is drawn, so no
    more than one row lives beside the batch."""
    device = resolve_device(device)
    n = spec.n_workers if n_local is None else int(n_local)
    its = np.asarray(it, dtype=np.int64)
    lead = its.shape[:-1] if its.ndim >= 1 else ()
    its = np.broadcast_to(its if its.ndim >= 1 else its[None], lead + (n,))
    first: Dict[int, int] = {}
    out, tdef = None, None
    for i, idx in enumerate(np.ndindex(*its.shape)):
        k = worker_key(key, int(its[idx]), worker_offset + idx[-1])
        if k in first:
            for o in out:
                o[i].copy_(o[first[k]])
            continue
        first[k] = i
        leaves, tdef = tree_flatten(spec.sample(k, device))
        if out is None:
            out = [torch.empty((its.size,) + tuple(x.shape), dtype=x.dtype,
                               device=x.device) for x in leaves]
        for o, x in zip(out, leaves):
            o[i].copy_(x)
    return tree_unflatten(tdef, [o.reshape(its.shape + o.shape[1:])
                                 for o in out])


def next_batch(stream: Stream, it, worker_offset: int = 0,
               n_local: Optional[int] = None, device=None):
    """`batch_at` on a Stream."""
    return batch_at(stream.spec, stream.key, it, worker_offset, n_local,
                    device)


# ---------------------------------------------------------------------------
# stock samplers
# ---------------------------------------------------------------------------

def generator(key: int, device) -> torch.Generator:
    """A `torch.Generator` on `device` seeded with the 64-bit `key`."""
    return torch.Generator(device=device).manual_seed(int(key) & _MASK64)


def normal_like(template_j, scale: float = 1.0) -> Callable:
    """Sampler of iid normal leaves shaped like ONE worker's data slice
    (`template_j`: tensors or arrays without the leading worker axis),
    drawn in leaf order from one generator.  A leaf that is not a
    floating type raises, as the reference's `jax.random.normal` does:
    there is no normal draw of an integer."""
    leaves, tdef = tree_flatten(template_j)
    specs = []
    for leaf in leaves:
        dtype = leaf.dtype if torch.is_tensor(leaf) else \
            torch.from_numpy(np.zeros(0, np.asarray(leaf).dtype)).dtype
        if not dtype.is_floating_point:
            raise ValueError(
                f"normal_like: a leaf of dtype {dtype} cannot be drawn "
                "from a normal distribution (only floating leaves stream)")
        specs.append((tuple(leaf.shape), dtype))

    def sample(key: int, device):
        g = generator(key, device)
        return tree_unflatten(tdef, [
            torch.randn(shape, generator=g, dtype=dtype,
                        device=device).mul_(scale) for shape, dtype in specs])

    return sample


def problem_stream(data, n_workers: int, seed: int = 0,
                   scale: float = 1.0) -> Stream:
    """Stream of normal draws shaped like `data` without its leading (N,)
    worker axis (e.g. a `TrilevelProblem.data` tree)."""
    leaves, tdef = tree_flatten(data)
    return make_stream(normal_like(tree_unflatten(tdef, [x[0] for x in
                                                         leaves]), scale),
                       n_workers, seed)


def zipf_tokens(key: int, shape, vocab_size: int, zipf_a: float = 1.2,
                device=None) -> torch.Tensor:
    """Zipfian token ids drawn on the device (inverse-CDF sampling of the
    rank-CCDF power tail): distribution-matched to
    `data.synthetic.make_token_stream`, not bit-matched.  Ranks are
    clipped to 2^24 so the f32 arithmetic stays exact-integer, and ranks
    past the vocabulary wrap (mod) as the host sampler's do."""
    if zipf_a <= 1.0:
        raise ValueError(
            f"zipf_a must be > 1 (rank-CCDF exponent a-1 must be "
            f"positive); got {zipf_a}")
    device = resolve_device(device)
    g = generator(key, device)
    u = torch.rand(tuple(shape), generator=g, dtype=torch.float32,
                   device=device).clamp_(min=1e-7)
    ranks = torch.floor(torch.clamp(u ** (-1.0 / (zipf_a - 1.0)),
                                    1.0, 2.0 ** 24))
    return torch.remainder(ranks - 1.0, vocab_size).to(torch.int32)
