"""Distributed domain adaptation for pretrain & finetune (paper §5.2, Eq. 32).

Counterpart of `repro/apps/domain_adaptation.py`.  Trilevel structure:
  level 1 (min over phi): finetune loss (phi = reweighting net params),
  level 2 (min over v):   finetune loss + lambda ||v - w||^2 (proximal),
  level 3 (min over w):   reweighted pretraining loss, weights
                          R(x_i; phi) in (0, 1) from the reweighting net.

All three networks are LeNet-5 (as in the paper); the pretrain domain is
"SVHN-like" and the finetune domain "MNIST-like" synthetic digits (see
`repro_torch.data.synthetic`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.types import Hyper, TrilevelProblem
from repro_torch.data.synthetic import DigitsData, make_digits
from repro_torch.models.simple import (accuracy, cross_entropy, lenet_apply,
                                       lenet_init)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves


@dataclasses.dataclass
class DomainAdaptTask:
    problem: TrilevelProblem
    data: DigitsData
    prox_lambda: float

    def test_metrics(self, v):
        """Finetune-domain test accuracy and loss of the LeNet `v`."""
        dev = v["f3b"].device
        logits = lenet_apply(v, torch.as_tensor(self.data.x_test,
                                                device=dev))
        labels = torch.as_tensor(self.data.y_test, device=dev).long()
        return {"test_acc": accuracy(logits, labels),
                "test_loss": cross_entropy(logits, labels)}


def _tree_sq_dist(a, b):
    return sum(torch.sum((x - y) ** 2)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def make_domain_adaptation_problem(n_workers: int,
                                   pretrain_domain: str = "svhn",
                                   n_pretrain_per: int = 48,
                                   n_finetune_per: int = 24,
                                   prox_lambda: float = 0.1,
                                   seed: int = 0, device=None,
                                   x_init: Optional[Sequence[dict]] = None
                                   ) -> DomainAdaptTask:
    """The domain-adaptation problem on `device` (CUDA unless the caller
    names another).  `x_init` replaces the three seeded LeNets (the
    reweighting, finetune and pretrain nets), e.g. with the reference's
    `jax.random` draws handed over as dicts of numpy arrays."""
    device = resolve_device(device)
    data = make_digits(n_workers, n_pretrain_per=n_pretrain_per,
                       n_finetune_per=n_finetune_per,
                       pretrain_domain=pretrain_domain, seed=seed)

    def put(a):
        return torch.as_tensor(np.asarray(a), device=device)

    pdata = {
        "xpt": put(data.x_pretrain), "ypt": put(data.y_pretrain).long(),
        "xft": put(data.x_finetune), "yft": put(data.y_finetune).long(),
    }

    def reweight(phi, x):
        """R(x; phi) in (0,1): sigmoid of the reweighting net's score."""
        score = lenet_apply(phi, x)  # (B, 10)
        return torch.sigmoid(torch.mean(score, dim=-1))

    def finetune_loss(d_j, v):
        return cross_entropy(lenet_apply(v, d_j["xft"]), d_j["yft"])

    def f1(d_j, x1, x2, x3):
        return finetune_loss(d_j, x2)

    def f2(d_j, x1, x2, x3):
        return finetune_loss(d_j, x2) \
            + prox_lambda * _tree_sq_dist(x2, x3)

    def f3(d_j, x1, x2, x3):
        logits = lenet_apply(x3, d_j["xpt"])
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, d_j["ypt"][:, None])[:, 0]
        w = reweight(x1, d_j["xpt"])
        return torch.mean(w * (logz - gold))

    if x_init is None:
        gen = torch.Generator().manual_seed(seed)
        x_init = [lenet_init(gen, device=device) for _ in range(3)]
    else:
        x_init = [{k: put(v) for k, v in x.items()} for x in x_init]
    problem = TrilevelProblem(
        f1=f1, f2=f2, f3=f3, data=pdata, n_workers=n_workers,
        x1_init=x_init[0], x2_init=x_init[1], x3_init=x_init[2])
    return DomainAdaptTask(problem=problem, data=data,
                           prox_lambda=prox_lambda)


def default_hyper(n_workers: int, s_active: int, tau: int,
                  **overrides) -> Hyper:
    base = dict(
        n_workers=n_workers, s_active=s_active, tau=tau,
        k_inner=2, p_max=6, t_pre=20, t1=400,
        eta_x=0.1, eta_z=0.1, eta_lambda=0.005, eta_theta=0.005,
        eta_dual_inner=0.005, kappa2=0.1, kappa3=0.1, rho2=0.1,
        eps_i=1e-2, eps_ii=1e-2, mu_i=0.5, mu_ii=0.5,
        alpha1=400.0, alpha2=400.0, alpha3=400.0, alpha4=25.0,
        alpha5=400.0, d1=61706)
    base.update(overrides)
    return Hyper(**base)
