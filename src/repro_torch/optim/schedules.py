"""Learning-rate schedules (step -> f32 lr).

Counterpart of `repro/optim/schedules.py`; `step` is an int or an
integer tensor, and every schedule returns a 0-d f32 tensor."""
from __future__ import annotations

import math

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def constant(value: float):
    return lambda step: _f32(value)


def linear_warmup(peak: float, warmup_steps: int):
    def fn(step):
        frac = torch.clamp(_f32((torch.as_tensor(step) + 1)
                                / max(warmup_steps, 1)), max=1.0)
        return peak * frac
    return fn


def cosine_decay(init: float, decay_steps: int, alpha: float = 0.0):
    def fn(step):
        frac = torch.clamp(_f32(torch.as_tensor(step)
                                / max(decay_steps, 1)), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return init * ((1 - alpha) * cos + alpha)
    return fn


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        step = torch.as_tensor(step)
        warm = peak * torch.clamp(_f32((step + 1) / max(warmup_steps, 1)),
                                  max=1.0)
        frac = torch.clamp(_f32((step - warmup_steps)
                                / max(total_steps - warmup_steps, 1)),
                           0.0, 1.0)
        cos = peak * (final_frac + (1 - final_frac)
                      * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn
