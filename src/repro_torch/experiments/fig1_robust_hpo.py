"""Fig. 1: distributed robust HPO — MSE (clean + noisy test) vs simulated
running time, AFTO vs SFTO, on the four regression datasets (synthetic
stand-ins with the paper's exact shapes; Table 1 worker settings).

Counterpart of `benchmarks/fig1_robust_hpo.py`; run it with
`python -m repro_torch.experiments.run --only fig1`.
"""
from __future__ import annotations

import time
from typing import Optional

from repro_torch.apps.robust_hpo import default_hyper, make_robust_hpo_problem
from repro_torch.experiments.common import method_histories

# Table 1 settings: (N, S, stragglers, tau)
SETTINGS = {
    "diabetes": (4, 3, 1, 10),
    "boston": (4, 3, 1, 10),
    "red_wine": (4, 3, 1, 10),
    "white_wine": (6, 4, 1, 10),
}

def run_dataset(dataset: str, n_iterations: int = 120, seed: int = 0,
                engine: str = "sweep", device=None,
                w0: Optional[dict] = None):
    """AFTO vs SFTO as one sweep (engine="sweep") or one run after the
    other (engine="scan"): the two methods differ only in their arrival
    schedules (S-of-N vs all-N).  `w0` replaces the seeded initial MLP
    (e.g. the reference's `jax.random` draw)."""
    n, s, stragglers, tau = SETTINGS[dataset]
    task = make_robust_hpo_problem(dataset, n_workers=n, seed=seed,
                                   device=device, w0=w0)

    def metrics(state):
        w = {k: v.mean(0) for k, v in state.X3.items()}
        return {"mse_clean": task.test_mse(w, 0.0),
                "mse_noisy": task.test_mse(w, 0.3, seed=seed)}

    algos = (("AFTO", s), ("SFTO", n))
    per_algo = method_histories(
        task.problem, default_hyper(task, n, s, tau),
        [s_active for _, s_active in algos], n_iterations, metrics, 10,
        n_workers=n, tau=tau, n_stragglers=stragglers, seed=seed,
        engine=engine)
    rows = []
    for (algo, _), h in zip(algos, per_algo):
        for i in range(len(h["t"])):
            rows.append({"dataset": dataset, "algo": algo,
                         "iter": h["t"][i], "sim_time": h["sim_time"][i],
                         "mse_clean": h["mse_clean"][i],
                         "mse_noisy": h["mse_noisy"][i],
                         "gap_sq": h["gap_sq"][i]})
    return rows


def speedup(rows, dataset: str, target_frac: float = 0.7):
    """Sim-time for each algo to first reach target_frac of its own
    initial noisy MSE; returns AFTO time saving vs SFTO (the paper's
    'maximum acceleration ~80%' metric)."""
    out = {}
    for algo in ("AFTO", "SFTO"):
        rs = [r for r in rows if r["dataset"] == dataset
              and r["algo"] == algo]
        target = rs[0]["mse_noisy"] * target_frac
        hit = [r["sim_time"] for r in rs if r["mse_noisy"] <= target]
        out[algo] = hit[0] if hit else float("inf")
    if out["SFTO"] in (0.0, float("inf")) or out["AFTO"] == float("inf"):
        return float("nan")
    return 1.0 - out["AFTO"] / out["SFTO"]


def main(n_iterations: int = 120, datasets=None, engine: str = "sweep",
         device=None):
    results = []
    for ds in datasets or list(SETTINGS):
        t0 = time.perf_counter()
        rows = run_dataset(ds, n_iterations=n_iterations, engine=engine,
                           device=device)
        dt = time.perf_counter() - t0
        acc = speedup(rows, ds)
        final = {a: [r for r in rows if r["algo"] == a][-1]["mse_noisy"]
                 for a in ("AFTO", "SFTO")}
        results.append((f"fig1_{ds}", dt * 1e6 / max(n_iterations, 1),
                        f"accel={acc:.2f};afto_noisy={final['AFTO']:.4f};"
                        f"sfto_noisy={final['SFTO']:.4f}"))
    return results

