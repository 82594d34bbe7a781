"""Minimal functional optimizers on tensor trees.

Counterpart of `repro/optim/optimizers.py`.  Each optimizer is an
(init, update) pair, not a `torch.optim` class, so a step compares one
for one with the reference's:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

The paper's own AFTO updates are plain projected gradient steps on the
regularized Lagrangian (Eqs. 16-21) and do not use these; they serve the
plain `plain_train_step` the trilevel path is compared with.

Types follow the reference's promotion: a learning rate from a schedule
is an f32 tensor, and scaling a bf16 leaf by it gives f32, as a strong
f32 array does in JAX; a Python float is rounded to the leaf's type
first, as a weak one is (`utils.tree.weak`).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map, weak


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _scale(lr):
    if callable(lr):
        return lr
    return lambda step: lr


def _times(s, x):
    """s * x with JAX's promotion: a tensor s is a strong type, a Python
    number a weak one (rounded to x's type first)."""
    if torch.is_tensor(s):
        return s * x.to(torch.promote_types(s.dtype, x.dtype))
    return weak(s, x) * x


def _step0(params):
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd(lr) -> Optimizer:
    lr_fn = _scale(lr)

    def init(params):
        return {"step": _step0(params)}

    def update(grads, state, params=None):
        step = state["step"]
        upd = tree_map(lambda g: -_times(lr_fn(step), g), grads)
        return upd, {"step": step + 1}

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    lr_fn = _scale(lr)

    def init(params):
        return {"step": _step0(params),
                "mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        step, mu = state["step"], state["mu"]
        mu = tree_map(lambda m, g: _times(beta, m) + g, mu, grads)
        if nesterov:
            upd = tree_map(lambda m, g: -_times(lr_fn(step),
                                                _times(beta, m) + g),
                           mu, grads)
        else:
            upd = tree_map(lambda m: -_times(lr_fn(step), m), mu)
        return upd, {"step": step + 1, "mu": mu}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    return adamw(lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0,
          state_dtype=torch.float32) -> Optimizer:
    lr_fn = _scale(lr)

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                  device=p.device)
        return {"step": _step0(params),
                "m": tree_map(z, params),
                "v": tree_map(z, params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        m = tree_map(lambda m0, g: b1 * m0 + (1 - b1) * g.to(state_dtype),
                     state["m"], grads)
        v = tree_map(lambda v0, g: b2 * v0 + (1 - b2)
                     * torch.square(g.to(state_dtype)), state["v"], grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        lr_t = lr_fn(step)

        def upd(mh, vh, p):
            u = -_times(lr_t, (mh / bc1) / (torch.sqrt(vh / bc2) + eps))
            if weight_decay:
                u = u - _times(lr_t, weight_decay * p.to(state_dtype))
            return u.to(p.dtype)

        updates = tree_map(upd, m, v,
                           params if params is not None
                           else tree_map(torch.zeros_like, m))
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    def init(params):
        return {}

    def update(grads, state, params=None):
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                            for g in tree_leaves(grads)))
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
        return tree_map(lambda g: _times(scale, g), grads), state

    return Optimizer(init, update)


def chain(*opts: Optimizer) -> Optimizer:
    def init(params):
        return tuple(o.init(params) for o in opts)

    def update(grads, state, params=None):
        new_states = []
        upd = grads
        for o, s in zip(opts, state):
            upd, ns = o.update(upd, s, params)
            new_states.append(ns)
        return upd, tuple(new_states)

    return Optimizer(init, update)
