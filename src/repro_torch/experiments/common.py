"""Shared pieces of the paper's evaluation: the per-method runs of the
figure experiments and the tiny quadratic trilevel problem of the rate
and communication checks.

Counterpart of `benchmarks/conftest_shim.py`.  As in the reference, the
methods of a figure run as one sweep (`engine="sweep"`, the default);
`engine="scan"` runs them one after another on the scan engine, with the
same schedules and per-method hypers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import runner
from repro_torch.core.engine import problem_device
from repro_torch.core.scheduler import StragglerConfig, StragglerScheduler
from repro_torch.core.types import Hyper, TrilevelProblem
from repro_torch.utils.device import resolve_device

ENGINES = ("sweep", "scan")


def check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"engine={engine!r}; the experiments run on one "
                         f"of {ENGINES}")


def method_histories(problem: TrilevelProblem, hyper: Hyper,
                     s_actives: Sequence[int], n_iterations: int,
                     metrics_fn: Optional[Callable], metrics_every: int, *,
                     n_workers: int, tau: int, n_stragglers: int, seed: int,
                     straggler_slowdown: float = 5.0,
                     engine: str = "sweep") -> List[Dict]:
    """One run per `s_actives` entry (e.g. AFTO's S-of-N vs SFTO's all-N),
    each on its own precomputed arrival schedule and with
    `hyper.s_active` set to its S; returns the per-method histories.
    engine="sweep" runs them as one sweep (each S riding it as a per-run
    `hyper.s_active`, as `swept_method_histories` in the reference),
    engine="scan" one after another."""
    check_engine(engine)
    schedules = [
        StragglerScheduler(StragglerConfig(
            n_workers=n_workers, s_active=s_active, tau=tau,
            n_stragglers=n_stragglers,
            straggler_slowdown=straggler_slowdown,
            seed=seed)).precompute(n_iterations)
        for s_active in s_actives]
    spec = runner.RunSpec(
        problem=problem, hyper=hyper, n_iterations=n_iterations,
        metrics_fn=metrics_fn, metrics_every=metrics_every, engine=engine,
        device=problem_device(problem))
    if engine == "sweep":
        res = runner.run(dataclasses.replace(
            spec, schedules=schedules,
            sweep_hypers={"s_active": list(s_actives)}))
        return [res.run(r).history for r in range(len(s_actives))]
    return [runner.run(dataclasses.replace(
        spec, hyper=dataclasses.replace(hyper, s_active=s_active),
        schedule=schedule)).history
        for s_active, schedule in zip(s_actives, schedules)]


def make_quadratic_problem(n_workers: int = 4, dim: int = 3, seed: int = 0,
                           device=None, data: Optional[Dict] = None
                           ) -> TrilevelProblem:
    """The quadratic trilevel problem on `device` (CUDA unless the caller
    names another).  `A` (N, dim, dim) and `b` (N, dim) are drawn from a
    `torch.Generator` seeded with `seed`, unless `data` hands them over
    as arrays (e.g. the reference's `jax.random` draws)."""
    device = resolve_device(device)
    if data is None:
        gen = torch.Generator().manual_seed(seed)
        data = {"A": torch.randn((n_workers, dim, dim), generator=gen) * 0.3,
                "b": torch.randn((n_workers, dim), generator=gen)}
    data = {k: torch.as_tensor(np.array(v, np.float32), device=device)
            for k, v in data.items()}

    def f1(d, x1, x2, x3):
        return torch.sum((x1 - d["A"] @ x3 - d["b"]) ** 2)

    def f2(d, x1, x2, x3):
        return torch.sum((x2 + x3) ** 2) + 0.1 * torch.sum(x2 ** 2)

    def f3(d, x1, x2, x3):
        return torch.sum((x3 - x1) ** 2) + 0.1 * torch.sum((x3 - x2) ** 2)

    def zeros():
        return torch.zeros(dim, device=device)

    return TrilevelProblem(
        f1=f1, f2=f2, f3=f3, data=data, n_workers=n_workers,
        x1_init=zeros(), x2_init=zeros(), x3_init=zeros())
