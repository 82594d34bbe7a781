"""Shared neural-net building blocks (pure functions + param factories).

Counterpart of `repro/models/layers.py`.  Initializers draw from a
`torch.Generator` with the reference's distributions (the draws differ
from `jax.random`; weights that must match come from the reference
through `repro_torch.convert`).  `lead` is a tuple of leading dimensions,
the repeats of a stage: stacked weights are drawn one slice at a time,
so a stacked f32 draw of a whole stage never exists; on the meta device
(the dry-run's) they are shapes only, and nothing is drawn.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _stacked(draw, lead: Sequence[int], shape, dtype, device):
    """A (*lead, *shape) tensor of dtype filled one (*shape) slice at a
    time by `draw()` (an f32 tensor), cast slice by slice."""
    if not lead:
        return draw().to(dtype)
    out = torch.empty((*lead, *shape), dtype=dtype, device=device)
    if out.is_meta:       # shapes only: there is nothing to draw
        return out
    flat = out.view(-1, *shape)
    for i in range(flat.shape[0]):
        flat[i] = draw()
    return out


def dense_init(generator, shape, dtype, fan_in: Optional[int] = None,
               device=None, lead: Sequence[int] = ()):
    """Normal / sqrt(fan_in), drawn in f32 and cast (fan_in defaults to
    shape[0])."""
    fan = fan_in if fan_in is not None else shape[0]
    return _stacked(
        lambda: torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) / math.sqrt(fan),
        lead, shape, dtype, device)


def embed_init(generator, vocab, d, dtype, device=None):
    return (torch.randn((vocab, d), generator=generator, device=device,
                        dtype=torch.float32) * 0.02).to(dtype)


def zeros(shape, dtype, device=None, lead: Sequence[int] = ()):
    return torch.zeros((*lead, *shape), dtype=dtype, device=device)


def full(shape, value, dtype, device=None, lead: Sequence[int] = ()):
    return torch.full((*lead, *shape), value, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (hd/2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) absolute token positions.
    Split-halves form: (x1, x2) -> (x1 cos - x2 sin, x2 cos + x1 sin)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., None].float() * freqs        # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations / mlp
# ---------------------------------------------------------------------------

def activation(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu, "tanh": torch.tanh}[name]


def glu_mlp_init(generator, d, d_ff, dtype, device=None,
                 lead: Sequence[int] = ()):
    kw = dict(device=device, lead=lead)
    return {"wi": dense_init(generator, (d, d_ff), dtype, **kw),
            "wg": dense_init(generator, (d, d_ff), dtype, **kw),
            "wo": dense_init(generator, (d_ff, d), dtype, fan_in=d_ff, **kw)}


def glu_mlp_apply(params, x, act="silu"):
    a = activation(act)
    h = a(x @ params["wg"]) * (x @ params["wi"])
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits, labels, mask=None):
    """Token-level CE in f32; logits (..., V), labels (...) int; with a
    `mask` (...) the mean over its weight (at least 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
