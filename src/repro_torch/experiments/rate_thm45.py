"""Thm. 4.5 non-asymptotic rate check: T(eps) = O(1/eps^2).

Counterpart of `benchmarks/rate_thm45.py`; run it with
`python -m repro_torch.experiments.run --only rate`.  AFTO runs on the
quadratic trilevel problem, records the running minimum of the
stationarity gap ||grad G^t||^2, and fits log T(eps) vs log(1/eps).
Theorem 4.5 predicts slope <= 2 asymptotically (iteration complexity
upper-bounded by (1/eps^2) * const for small eps); a measured slope well
below ~2.3 is consistent with (does not falsify) the bound.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.core import runner
from repro_torch.core.scheduler import StragglerConfig
from repro_torch.core.types import Hyper
from repro_torch.experiments.common import (check_engine,
                                            make_quadratic_problem)


def _fit_slope(t, g, t1):
    """log T(eps) vs log(1/eps) slope from one gap trajectory."""
    # running min: first iteration achieving each eps level.  Fit ONLY
    # the post-cut-building tail (t > t1): the transient while the
    # polytope is still growing is not the regime Thm 4.5 bounds.
    gmin = np.minimum.accumulate(g)
    tail = t > t1
    if tail.sum() < 4:
        tail = t > t[len(t) // 2]
    g_ref = gmin[tail][0]
    eps_levels = np.geomspace(g_ref * 0.9, gmin[-1] * 1.1, 12)
    t_eps, inv_eps = [], []
    for eps in eps_levels:
        hit = np.nonzero(gmin <= eps)[0]
        if len(hit):
            t_eps.append(t[hit[0]])
            inv_eps.append(1.0 / eps)
    t_eps, inv_eps = np.asarray(t_eps), np.asarray(inv_eps)
    mask = t_eps > t_eps.min()          # drop the trivial prefix
    slope = float("nan")
    if mask.sum() >= 3:
        slope = float(np.polyfit(np.log(inv_eps[mask]),
                                 np.log(t_eps[mask]), 1)[0])
    return slope, gmin


def main(n_iterations: int = 400, seed: int = 0, n_seeds: int = 2,
         device=None, data: Optional[Dict] = None, engine: str = "sweep"):
    """Seed repetitions of the rate check, each on the arrival process
    re-seeded with its seed: one sweep (engine="sweep", `seeds=`) or one
    run after the other (engine="scan").  The bound must hold per seed,
    so each run is fitted separately.  `data` hands over the quadratic
    problem's `A` and `b`."""
    check_engine(engine)
    t0 = time.perf_counter()
    prob = make_quadratic_problem(n_workers=4, dim=3, seed=seed,
                                  device=device, data=data)
    hyper = Hyper(n_workers=4, s_active=3, tau=5, k_inner=3, p_max=6,
                  t_pre=10, t1=200, eta_x=0.05, eta_z=0.05, d1=3)
    cfg = StragglerConfig(n_workers=4, s_active=3, tau=5, n_stragglers=1,
                          seed=seed)
    spec = runner.RunSpec(problem=prob, hyper=hyper, scheduler=cfg,
                          n_iterations=n_iterations, metrics_every=5,
                          engine=engine, device=device)
    seeds = [seed + r for r in range(n_seeds)]
    if engine == "sweep":
        res = runner.run(dataclasses.replace(spec, seeds=seeds))
        hists = [res.run(r).history for r in range(n_seeds)]
    else:
        hists = [runner.run(dataclasses.replace(
            spec, scheduler=dataclasses.replace(cfg, seed=s))).history
            for s in seeds]
    slopes, gap0, gapT = [], None, []
    for r, h in enumerate(hists):
        t = np.asarray(h["t"], dtype=np.float64)
        g = np.asarray(h["gap_sq"], dtype=np.float64)
        slope, gmin = _fit_slope(t, g, hyper.t1)
        slopes.append(slope)
        gapT.append(gmin[-1])
        if r == 0:
            gap0 = g[0]
    consistent = all(np.isnan(s) or s < 2.3 for s in slopes)
    slope_mean = float(np.nanmean(slopes)) if slopes else float("nan")
    dt = time.perf_counter() - t0
    return [("rate_thm45", dt * 1e6 / (n_iterations * n_seeds),
             f"gap0={gap0:.3f};gapT={min(gapT):.5f};"
             f"fit_slope={slopes[0]:.2f};slope_mean={slope_mean:.2f};"
             f"seeds={n_seeds};bound_slope=2.0;"
             f"consistent={'yes' if consistent else 'no'}")]
