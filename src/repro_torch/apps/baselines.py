"""Distributed *bilevel* baselines for Table 2: ADBO and FedNest.

Counterpart of `repro/apps/baselines.py`.  Both solve the robust-HPO
task as a BILEVEL problem — hyperparameter phi upper, weights w lower —
without the adversarial middle level, which is why the paper's trilevel
AFTO reaches a better *noisy-test* MSE (Table 2): the baselines never
train against perturbations.

* FedNest  (Tarzanagh et al., 2022): synchronous federated bilevel SGD;
  inner local SGD + averaging for w, one-step inverse-Hessian-free
  hypergradient for phi.
* ADBO     (Jiao et al., 2022b): asynchronous distributed bilevel with
  (convex, mu=0) cutting planes: the AFTO loop restricted to two levels,
  on the same straggler scheduler, so its cut contractions run on the
  cut kernels on a CUDA device.

Both run where the task's tensors live.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from repro_torch.apps.robust_hpo import RobustHPOTask, default_hyper
from repro_torch.core import runner
from repro_torch.core.scheduler import StragglerConfig, StragglerScheduler
from repro_torch.models.simple import mlp_apply, smoothed_l1
from repro_torch.utils import tree as tree_lib
from repro_torch.utils.tree import tree_axpy, tree_leaves, tree_map


def _val_mse(w, d_j):
    pred = mlp_apply(w, d_j["xval"])[:, 0]
    return torch.mean((pred - d_j["yval"]) ** 2)


# ---------------------------------------------------------------------------
# FedNest-style federated bilevel SGD
# ---------------------------------------------------------------------------

def run_fednest(task: RobustHPOTask, n_iterations: int = 200,
                inner_steps: int = 4, eta_w: float = 0.05,
                eta_phi: float = 0.02, seed: int = 0) -> Dict[str, List]:
    prob = task.problem
    n = prob.n_workers
    workers = [prob.worker_data(j) for j in range(n)]

    def loss(w, d_j, phi):
        pred = mlp_apply(w, d_j["xtr"])[:, 0]
        return torch.mean((pred - d_j["ytr"]) ** 2) \
            + torch.exp(phi[0]) * smoothed_l1(w) / n

    def local_inner(w, phi):
        """inner_steps of local SGD on the regularized train loss per
        worker, then FedAvg; differentiable w.r.t. phi through the
        updates."""
        ws = []
        for d_j in workers:
            w_j = w
            for _ in range(inner_steps):
                g, = tree_lib.grad(lambda w_j: loss(w_j, d_j, phi), w_j)
                w_j = tree_axpy(-eta_w, g, w_j)
            ws.append(w_j)
        return tree_map(lambda *xs: torch.stack(xs).mean(0), *ws)

    def val_loss(w):
        return torch.stack([_val_mse(w, d_j) for d_j in workers]).mean()

    def step(w, phi):
        # one unrolled inner pass gives both the new weights and the
        # hypergradient d val / d phi through it (IFT-free 1-step
        # approximation), with w itself held fixed
        def objective(phi):
            w_new = local_inner(w, phi)
            return val_loss(w_new), w_new
        g_phi, w_new = torch.func.grad(objective, has_aux=True)(phi)
        return w_new, phi - eta_phi * g_phi

    w = prob.x3_init
    phi = prob.x1_init["phi"]
    hist = {"t": [], "sim_time": [], "val_mse": []}
    # synchronous: every iteration costs the slowest worker's latency
    sched = StragglerScheduler(StragglerConfig(
        n_workers=n, s_active=n, tau=1000, n_stragglers=1, seed=seed))
    for it in range(n_iterations):
        _, sim_t = sched.next_active()
        w, phi = step(w, phi)
        if (it + 1) % 10 == 0:
            hist["t"].append(it + 1)
            hist["sim_time"].append(sim_t)
            with torch.no_grad():
                hist["val_mse"].append(float(val_loss(w)))
    return {"w": w, "phi": phi, "history": hist}


# ---------------------------------------------------------------------------
# ADBO-style asynchronous bilevel with convex cutting planes
# ---------------------------------------------------------------------------

def run_adbo(task: RobustHPOTask, n_iterations: int = 200,
             s_active: int = None, tau: int = 10, seed: int = 0,
             **hyper_overrides) -> Dict[str, List]:
    """ADBO == the paper's machinery with the middle level removed and
    mu = 0 (convex cuts): x2 is pinned at 0 (no adversarial level) and
    mu_i = mu_ii = 0 in the same AFTO loop."""
    prob = task.problem
    n = prob.n_workers
    s = s_active if s_active is not None else max(1, n - 1)

    frozen = dataclasses.replace(
        prob,
        f2=lambda d_j, x1, x2, x3: 0.5 * torch.sum(x2 ** 2),  # pins p at 0
        x2_init=torch.zeros_like(prob.x2_init))
    hyper = default_hyper(task, n, s, tau, mu_i=0.0, mu_ii=0.0,
                          **hyper_overrides)
    cfg = StragglerConfig(n_workers=n, s_active=s, tau=tau,
                          n_stragglers=1, seed=seed)

    def metrics(state):
        return {"val_mse": torch.stack([
            _val_mse({k: v[j] for k, v in state.X3.items()},
                     prob.worker_data(j)) for j in range(n)]).mean()}

    res = runner.run(runner.RunSpec(
        problem=frozen, hyper=hyper, scheduler=cfg,
        n_iterations=n_iterations, metrics_fn=metrics,
        device=tree_leaves(prob.x3_init)[0].device))
    # consensus weights = average of worker copies
    w = {k: v.mean(0) for k, v in res.state.X3.items()}
    return {"w": w, "phi": res.state.z1["phi"], "history": res.history}
