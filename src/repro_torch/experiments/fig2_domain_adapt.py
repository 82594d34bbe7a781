"""Fig. 2: distributed domain adaptation — test accuracy / loss vs
simulated running time, AFTO vs SFTO, SVHN-pretrain and MNIST-pretrain
directions (synthetic two-domain digits).

Counterpart of `benchmarks/fig2_domain_adapt.py`; run it with
`python -m repro_torch.experiments.run --only fig2`.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

from repro_torch.apps.domain_adaptation import (default_hyper,
                                                make_domain_adaptation_problem)
from repro_torch.experiments.common import method_histories

# Table 1: SVHN(finetune): N=4 S=3 1 straggler tau=5;
#          SVHN(pretrain): N=6 S=3 2 stragglers tau=15
SETTINGS = {
    "svhn_pretrain": (6, 3, 2, 15),
    "mnist_pretrain": (4, 3, 1, 5),
}


def run_direction(direction: str, n_iterations: int = 40, seed: int = 0,
                  engine: str = "sweep", device=None,
                  x_init: Optional[Sequence[dict]] = None):
    """AFTO vs SFTO as one sweep (engine="sweep") or one run after the
    other (engine="scan"); they differ only in arrival schedules.  `x_init` replaces the three seeded LeNets (e.g. the
    reference's `jax.random` draws as dicts of numpy arrays)."""
    n, s, stragglers, tau = SETTINGS[direction]
    domain = "svhn" if direction == "svhn_pretrain" else "mnist"
    task = make_domain_adaptation_problem(
        n, pretrain_domain=domain, n_pretrain_per=24, n_finetune_per=12,
        seed=seed, device=device, x_init=x_init)

    def metrics(state):
        return task.test_metrics({k: v.mean(0) for k, v in state.X2.items()})

    algos = (("AFTO", s), ("SFTO", n))
    per_algo = method_histories(
        task.problem, default_hyper(n, s, tau, t_pre=20, k_inner=1, p_max=2),
        [s_active for _, s_active in algos], n_iterations, metrics,
        max(2, n_iterations // 8), n_workers=n, tau=tau,
        n_stragglers=stragglers, seed=seed, engine=engine)
    rows = []
    for (algo, _), h in zip(algos, per_algo):
        for i in range(len(h["t"])):
            rows.append({"direction": direction, "algo": algo,
                         "iter": h["t"][i], "sim_time": h["sim_time"][i],
                         "test_acc": h["test_acc"][i],
                         "test_loss": h["test_loss"][i]})
    return rows


def accel(rows):
    """AFTO's saving in sim-time, against SFTO, to first reach the worse
    of the two methods' final test losses."""
    finals = {a: [r for r in rows if r["algo"] == a][-1]
              for a in ("AFTO", "SFTO")}
    target = max(finals["AFTO"]["test_loss"], finals["SFTO"]["test_loss"])
    t_hit = {}
    for a in ("AFTO", "SFTO"):
        hits = [r["sim_time"] for r in rows
                if r["algo"] == a and r["test_loss"] <= target]
        t_hit[a] = hits[0] if hits else float("inf")
    if t_hit["SFTO"] in (0.0, float("inf")):
        return float("nan")
    return 1.0 - t_hit["AFTO"] / t_hit["SFTO"]


def main(n_iterations: int = 40, directions=None, engine: str = "sweep",
         device=None):
    out = []
    for d in directions or list(SETTINGS):
        t0 = time.perf_counter()
        rows = run_direction(d, n_iterations, engine=engine, device=device)
        dt = time.perf_counter() - t0
        finals = {a: [r for r in rows if r["algo"] == a][-1]
                  for a in ("AFTO", "SFTO")}
        out.append((f"fig2_{d}", dt * 1e6 / max(n_iterations, 1),
                    f"accel={accel(rows):.2f};"
                    f"afto_acc={finals['AFTO']['test_acc']:.3f};"
                    f"sfto_acc={finals['SFTO']['test_acc']:.3f}"))
    return out
