"""Problem registry for multi-process workers.

Counterpart of `repro/fed/runtime/problems.py`.  A `TrilevelProblem`
carries objective closures, which do not cross process boundaries, so
subprocess workers and the serve front end agree on a registry NAME
(plus a few integer knobs) and each rebuild the identical problem: a
worker's gradients land in exactly the rows the master expects.

Register a problem with `@register("name")`; its builder returns
`(problem, hyper)` for (n_workers, dim, seed, device).  `STREAMS`
registers a sampler builder under the same name, so the master and every
subprocess worker rebuild the identical `Stream` (`build_stream`).

The data is drawn as the reference's contract says, PER WORKER ROW: row
j comes from its own CPU `torch.Generator` keyed on (seed, j) and is then
moved to the device.  So row j is the same at every build width that
holds j (what elastic admission needs), and on every device: a master on
the card and a worker process on the CPU, or on the card, hold the same
rows.  The port cannot draw the reference's `jax.random` data; the
parity tests hand it over through `repro_torch.convert.problem_data`.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.types import Hyper, TrilevelProblem
from repro_torch.data import stream as stream_lib
from repro_torch.data.stream import Stream
from repro_torch.utils.device import resolve_device

REGISTRY: Dict[str, Callable] = {}
STREAMS: Dict[str, Callable] = {}
# the stream's base key is apart from the data's keys (the reference
# folds 1000 into its data key for the stream)
_STREAM_FOLD = 1000


def register(name: str):
    def deco(fn):
        REGISTRY[name] = fn
        return fn
    return deco


def register_stream(name: str):
    """Register a per-worker sampler builder `(dim, seed) ->
    sample(key, device)` under problem name `name`."""
    def deco(fn):
        STREAMS[name] = fn
        return fn
    return deco


def build(name: str, n_workers: int = 4, dim: int = 3, seed: int = 0,
          device=None) -> Tuple[TrilevelProblem, Hyper]:
    """Rebuild registry problem `name` from its knobs on `device` (the
    CUDA card unless named)."""
    if name not in REGISTRY:
        raise KeyError(
            f"unknown problem {name!r}; registered: {sorted(REGISTRY)}")
    return REGISTRY[name](n_workers=n_workers, dim=dim, seed=seed,
                          device=resolve_device(device))


def build_stream(name: str, n_workers: int = 4, dim: int = 3,
                 seed: int = 0) -> Stream:
    """Rebuild problem `name`'s `Stream` from the same knobs as `build`:
    the agreement point of the master and its subprocess workers.  Its
    batches are drawn on the device the engine asks for."""
    if name not in STREAMS:
        raise KeyError(
            f"problem {name!r} has no registered stream; "
            f"streamed: {sorted(STREAMS)}")
    sample = STREAMS[name](dim=dim, seed=seed)
    return stream_lib.make_stream(
        sample, n_workers, stream_lib._fold_in(seed, _STREAM_FOLD))


def elastic_config(name: str, max_workers: int, dim: int = 3,
                   seed: int = 0, stream: bool = False, device=None):
    """An `ElasticConfig` whose builders rebuild registry problem `name`
    at any width from the same knobs (`Master(elastic=...)`, `serve fed
    --max-workers`)."""
    from repro_torch.fed.runtime.membership import ElasticConfig

    device = resolve_device(device)
    return ElasticConfig(
        build=lambda n: build(name, n_workers=n, dim=dim, seed=seed,
                              device=device),
        max_workers=int(max_workers),
        build_stream=((lambda n: build_stream(
            name, n_workers=n, dim=dim, seed=seed)) if stream else None))


@register("quadratic")
def quadratic(n_workers: int = 4, dim: int = 3, seed: int = 0,
              device=None) -> Tuple[TrilevelProblem, Hyper]:
    """The small seeded quadratic trilevel problem of the test suite and
    the quickstart: A at 0.3 and b at 1 per entry, row by row."""
    device = resolve_device(device)
    rows = []
    for j in range(n_workers):
        # row j from its own CPU generator keyed on (seed, j)
        g = stream_lib.generator(stream_lib._fold_in(seed, j), "cpu")
        rows.append((torch.randn((dim, dim), generator=g) * 0.3,
                     torch.randn((dim,), generator=g)))
    data = {"A": torch.stack([a for a, _ in rows]).to(device),
            "b": torch.stack([b for _, b in rows]).to(device)}

    def f1(d, x1, x2, x3):
        return torch.sum((x1 - d["A"] @ x3 - d["b"]) ** 2)

    def f2(d, x1, x2, x3):
        return torch.sum((x2 + x3) ** 2) + 0.1 * torch.sum(x2 ** 2)

    def f3(d, x1, x2, x3):
        return torch.sum((x3 - x1) ** 2) + 0.1 * torch.sum((x3 - x2) ** 2)

    zeros = torch.zeros(dim, device=device)
    problem = TrilevelProblem(
        f1=f1, f2=f2, f3=f3, data=data, n_workers=n_workers,
        x1_init=zeros, x2_init=zeros.clone(), x3_init=zeros.clone())
    hyper = Hyper(n_workers=n_workers, s_active=max(1, n_workers - 1),
                  tau=5, k_inner=3, p_max=6, t_pre=5, t1=100,
                  eta_x=0.05, eta_z=0.05, d1=dim)
    return problem, hyper


@register_stream("quadratic")
def quadratic_stream(dim: int = 3, seed: int = 0) -> Callable:
    """Fresh per-iteration (A, b) rows at the static problem's scale,
    drawn on the requested device."""
    del seed  # the base key is build_stream's; samplers are pure

    def sample(key: int, device):
        g = stream_lib.generator(key, device)
        return {"A": torch.randn((dim, dim), generator=g,
                                 device=device).mul_(0.3),
                "b": torch.randn((dim,), generator=g, device=device)}

    return sample
