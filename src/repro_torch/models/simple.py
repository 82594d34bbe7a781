"""The MLP of the paper's robust-HPO experiments (§5.1).

Counterpart of the MLP part of `repro/models/simple.py`.  Parameters are
a dict {w0, b0, w1, b1, ...}; trees flatten in sorted-key order, as in
the reference.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.utils.tree import tree_leaves


def mlp_init(generator: torch.Generator, sizes: Sequence[int],
             device=None, dtype=torch.float32):
    """Weights normal / sqrt(fan_in), zero biases (the reference's
    distribution; `torch.Generator` draws differ from `jax.random`)."""
    params = {}
    for i, (din, dout) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.randn((din, dout), generator=generator, dtype=dtype)
        params[f"w{i}"] = (w / din ** 0.5).to(device)
        params[f"b{i}"] = torch.zeros((dout,), dtype=dtype, device=device)
    return params


def mlp_apply(params, x):
    n_layers = len(params) // 2
    h = x
    for i in range(n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = torch.tanh(h)
    return h


def smoothed_l1(params, delta: float = 1e-3):
    """||w||_{1*}: smooth |w| via sqrt(w^2 + delta^2) - delta (paper §5.1)."""
    total = 0.0
    for p in tree_leaves(params):
        total = total + torch.sum(torch.sqrt(p.float() ** 2 + delta ** 2)
                                  - delta)
    return total
