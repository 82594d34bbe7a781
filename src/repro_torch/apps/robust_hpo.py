"""Distributed robust hyperparameter optimization (paper §5.1, Eq. 31).

Counterpart of `repro/apps/robust_hpo.py`.  Trilevel structure:
  level 1 (min over phi): validation MSE of the trained model,
  level 2 (max over p):   adversarial input perturbation p = [p_1..p_N]
                          (worker j owns block j), penalized by c||p_j||^2,
  level 3 (min over w):   perturbed training MSE + e^phi * ||w||_{1*}.

Everything minimizes, so the level-2 objective is negated.  x1 = phi
(log-regularization scalar), x2 = p (stacked blocks, (N, n_tr, d) — each
worker's local copy carries all blocks, per the consensus reformulation
Eq. 3), x3 = MLP weights.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.types import Hyper, TrilevelProblem
from repro_torch.data.synthetic import RegressionData, make_regression
from repro_torch.models.simple import mlp_apply, mlp_init, smoothed_l1
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class RobustHPOTask:
    problem: TrilevelProblem
    data: RegressionData
    hidden: int

    def test_mse(self, w, noise_std: float = 0.0, seed: int = 0):
        """Test MSE of the MLP `w`, on inputs with Gaussian noise of
        `noise_std` drawn by numpy from `seed` (the reference's draws)."""
        dev = w["w0"].device
        x = torch.as_tensor(self.data.x_test, device=dev)
        if noise_std > 0:
            rng = np.random.default_rng(seed)
            x = x + noise_std * torch.as_tensor(
                rng.normal(size=x.shape).astype(np.float32), device=dev)
        pred = mlp_apply(w, x)[:, 0]
        y = torch.as_tensor(self.data.y_test, device=dev)
        return torch.mean((pred - y) ** 2)


def make_robust_hpo_problem(dataset: str, n_workers: int, hidden: int = 16,
                            adv_penalty: float = 1.0, seed: int = 0,
                            device=None, w0: Optional[dict] = None
                            ) -> RobustHPOTask:
    """The robust-HPO problem on `device` (CUDA unless the caller names
    another).  `w0` replaces the seeded initial MLP weights, e.g. with
    the reference's `jax.random` draw carried over by
    `repro_torch.convert`."""
    device = resolve_device(device)
    data = make_regression(dataset, n_workers, seed=seed)
    n_tr, d = data.x_train.shape[1], data.x_train.shape[2]

    def put(a):
        return torch.as_tensor(a, device=device)

    pdata = {
        "xtr": put(data.x_train), "ytr": put(data.y_train),
        "xval": put(data.x_val), "yval": put(data.y_val),
        "wid": put(np.arange(n_workers, dtype=np.int64)),
    }

    def train_mse(d_j, p_block, w):
        pred = mlp_apply(w, d_j["xtr"] + p_block)[:, 0]
        return torch.mean((pred - d_j["ytr"]) ** 2)

    def f1(d_j, x1, x2, x3):
        pred = mlp_apply(x3, d_j["xval"])[:, 0]
        return torch.mean((pred - d_j["yval"]) ** 2)

    def own_block(x2, d_j):
        # worker j's block of the stacked perturbation, indexed on the
        # device (no host sync)
        return x2.index_select(0, d_j["wid"].reshape(1))[0]

    def f2(d_j, x1, x2, x3):
        # argmax -> negate.  Worker j perturbs only its own block.
        p_j = own_block(x2, d_j)
        return -(train_mse(d_j, p_j, x3)
                 - adv_penalty * torch.mean(p_j ** 2))

    def f3(d_j, x1, x2, x3):
        p_j = own_block(x2, d_j)
        reg = torch.exp(x1["phi"][0]) * smoothed_l1(x3)
        return train_mse(d_j, p_j, x3) + reg / max(n_workers, 1)

    if w0 is None:
        w0 = mlp_init(torch.Generator().manual_seed(seed),
                      (d, hidden, 1), device=device)
    problem = TrilevelProblem(
        f1=f1, f2=f2, f3=f3, data=pdata, n_workers=n_workers,
        x1_init={"phi": torch.tensor([-3.0], device=device)},
        x2_init=torch.zeros((n_workers, n_tr, d), device=device),
        x3_init=w0)
    return RobustHPOTask(problem=problem, data=data, hidden=hidden)


def default_hyper(task: RobustHPOTask, n_workers: int, s_active: int,
                  tau: int, **overrides) -> Hyper:
    base = dict(
        n_workers=n_workers, s_active=s_active, tau=tau,
        k_inner=4, p_max=8, t_pre=10, t1=400,
        eta_x=0.05, eta_z=0.05, eta_lambda=0.01, eta_theta=0.01,
        eta_dual_inner=0.01, kappa2=0.5, kappa3=0.5, rho2=0.5,
        eps_i=1e-3, eps_ii=1e-3, mu_i=0.5, mu_ii=0.5,
        alpha1=25.0, alpha2=25.0, alpha3=25.0, alpha4=25.0, alpha5=25.0,
        d1=1)
    base.update(overrides)
    return Hyper(**base)
