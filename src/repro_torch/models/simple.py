"""The paper's models: the robust-HPO MLP (§5.1) and LeNet-5 (§5.2).

Counterpart of `repro/models/simple.py`.  Parameters are dicts ({w0, b0,
w1, b1, ...}; LeNet's {c1, c1b, ..., f3b}) that flatten in sorted-key
order, and keep the reference's layouts: dense weights (din, dout),
convolution weights HWIO (kh, kw, cin, cout), images NHWC.  So the
flattened cut space lines up with the reference's column for column.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# LeNet-5 (32x32x1 inputs, 10 classes)
# ---------------------------------------------------------------------------

def lenet_init(generator: torch.Generator, n_classes: int = 10,
               device=None, dtype=torch.float32):
    """Weights normal / sqrt(fan_in), zero biases (the reference's
    distribution; `torch.Generator` draws differ from `jax.random`)."""
    def normal(shape, fan):
        w = torch.randn(shape, generator=generator, dtype=dtype)
        return (w / fan ** 0.5).to(device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    return {
        "c1": normal((5, 5, 1, 6), 25), "c1b": zeros(6),
        "c2": normal((5, 5, 6, 16), 150), "c2b": zeros(16),
        "f1": normal((400, 120), 400), "f1b": zeros(120),
        "f2": normal((120, 84), 120), "f2b": zeros(84),
        "f3": normal((84, n_classes), 84), "f3b": zeros(n_classes),
    }


def _conv2d(x, w):
    """VALID cross-correlation, stride 1: NHWC input, HWIO weight, NHWC
    output (PyTorch's NCHW/OIHW inside)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def _avgpool2(x):
    """2x2 mean pooling, stride 2, NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def lenet_apply(params, x):
    """x: (B, 32, 32, 1) -> logits (B, n_classes)."""
    h = torch.tanh(_conv2d(x, params["c1"]) + params["c1b"])  # (B,28,28,6)
    h = _avgpool2(h)                                          # (B,14,14,6)
    h = torch.tanh(_conv2d(h, params["c2"]) + params["c2b"])  # (B,10,10,16)
    h = _avgpool2(h)                                          # (B,5,5,16)
    h = h.reshape(h.shape[0], -1)                             # NHWC order
    h = torch.tanh(h @ params["f1"] + params["f1b"])
    h = torch.tanh(h @ params["f2"] + params["f2b"])
    return h @ params["f3"] + params["f3b"]


def cross_entropy(logits, labels):
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.mean(logz - gold)


def accuracy(logits, labels):
    return torch.mean((torch.argmax(logits, -1) == labels).float())
