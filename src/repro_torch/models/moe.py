"""Mixture-of-Experts channel mixer: top-k router and capacity-bounded
grouped expert products.

Counterpart of `repro/models/moe.py`.  Tokens go to (expert, slot)
buffers of shape (E, C, d) by an index write, never by a dense one-hot
dispatch product (at Kimi K2's 384 experts that product would cost more
than the experts); each expert runs a GLU MLP on its buffer as one
batched product; the results come back with their routing weights.
Assignments past an expert's capacity are dropped, as in the reference.

Every step is written for the card's determinism and for `torch.func`:
the dispatch writes each kept (expert, slot) pair once, and dropped
assignments write to a spare row that is cut away; the gather back adds
each token's K rows as a sum over a (T, K, d) view, in a fixed order;
the slots come from a cumulative count, with no in-place write into a
tensor a transform captured.  So the forward is bitwise repeatable on
the card, and it runs under `vmap` and grad-of-grad.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.models.layers import activation, dense_init


def moe_init(generator, d, d_ff, n_experts, dtype, device=None,
             lead: Sequence[int] = ()):
    """The reference's tree; each expert's matrices are drawn on their
    own (the f32 draw of all of Kimi K2's experts at once would take 22
    GB)."""
    kw = dict(device=device)
    experts = (*lead, n_experts)
    return {
        "router": dense_init(generator, (d, n_experts), torch.float32,
                             lead=lead, **kw),
        "wi": dense_init(generator, (d, d_ff), dtype, fan_in=d,
                         lead=experts, **kw),
        "wg": dense_init(generator, (d, d_ff), dtype, fan_in=d,
                         lead=experts, **kw),
        "wo": dense_init(generator, (d_ff, d), dtype, fan_in=d_ff,
                         lead=experts, **kw),
    }


def _route(router_w, x_flat, top_k: int):
    """Returns (expert_idx (T,K), weight (T,K), aux_loss scalar)."""
    logits = x_flat.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    weight, expert_idx = torch.topk(probs, top_k, dim=-1)
    weight = weight / torch.clamp(weight.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux loss (Switch-style): E * <f_e, p_e>
    e = router_w.shape[1]
    me = probs.mean(0)
    # one-hot by comparison: `F.one_hot` reads its input's largest value
    # on the host, which `vmap` refuses
    top1 = expert_idx[:, :1] == torch.arange(e, device=expert_idx.device)
    fe = top1.float().mean(0)
    aux = e * torch.sum(fe * me)
    return expert_idx, weight.to(x_flat.dtype), aux


class Dispatch(NamedTuple):
    """Where each of the T*K (token, k) assignments went: `dest` is its
    row of the flattened (E*C, d) buffer (dropped ones: row 0), `keep`
    whether it fit, `weight` its routing weight."""
    buf: torch.Tensor          # (E, C, d)
    dest: torch.Tensor         # (T*K,) int64
    keep: torch.Tensor         # (T*K,) bool
    weight: torch.Tensor       # (T*K,) x's dtype
    aux: torch.Tensor          # scalar f32


def capacity_of(t: int, top_k: int, n_experts: int,
                capacity_factor: float) -> int:
    return max(1, int(capacity_factor * t * top_k / n_experts))


def slots(flat_e, n_experts: int):
    """Each assignment's rank among the assignments to its expert, in
    order: a cumulative count along the inner axis of an (E, T*K)
    one-hot, exact in int32 (along the outer axis of a (T*K, E) one-hot
    the scan took 12 ms of Kimi K2's 49 ms prefill on an NVIDIA H100)."""
    hot = (torch.arange(n_experts, device=flat_e.device)[:, None]
           == flat_e[None]).to(torch.int32)
    rank = torch.cumsum(hot, dim=1, dtype=torch.int32) - hot
    return torch.gather(rank, 0, flat_e[None])[0].long()


def dispatch(router_w, xf, top_k: int, capacity: int,
             held: int = 0) -> Dispatch:
    """Route the (T, d) tokens and write each kept assignment's token
    into its (expert, slot) row of an (E, C, d) buffer.

    held: a shard of an expert-parallel layer holds only the first
    `held` of the router's E experts (the dry-run's local program, whose
    router logits span every expert); the buffer is (held, C, d) and the
    assignments to other experts are dropped here.  0: every expert."""
    t, d = xf.shape
    e = router_w.shape[1]
    held = held or e
    expert_idx, weight, aux = _route(router_w, xf, top_k)
    flat_e = expert_idx.reshape(-1)                       # (T*K,)
    slot = slots(flat_e, e)
    keep = slot < capacity
    if held < e:
        keep = keep & (flat_e < held)
    row = flat_e * capacity + slot
    # the kept rows are distinct; the dropped ones all go to a spare row
    spare = torch.full_like(row, held * capacity)
    contrib = xf[:, None].expand(t, top_k, d).reshape(t * top_k, d)
    buf = xf.new_zeros((held * capacity + 1, d)).index_put(
        (torch.where(keep, row, spare),), contrib)
    return Dispatch(buf[:-1].view(held, capacity, d),
                    torch.where(keep, row, torch.zeros_like(row)), keep,
                    weight.reshape(-1), aux)


def experts(params, buf, act: str = "silu"):
    """The experts' GLU MLPs on their (E, C, d) buffers -> (E, C, d), as
    batched products over the expert axis."""
    a = activation(act)
    h = a(torch.bmm(buf, params["wg"])) * torch.bmm(buf, params["wi"])
    return torch.bmm(h, params["wo"])


def combine(y, disp: Dispatch, t: int, top_k: int):
    """Each token's K expert outputs times their weights, summed in f32
    over a (T, K, d) view (the reference's scatter-add of K rows a
    token, in a fixed order) -> (T, d) f32."""
    d = y.shape[-1]
    picked = y.reshape(-1, d)[disp.dest].float() \
        * (disp.weight * disp.keep)[:, None]
    return picked.view(t, top_k, d).sum(1)


def moe_apply(params, x, top_k: int, capacity_factor: float = 1.25,
              act: str = "silu") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (out (B,S,d), aux_loss).  The capacity is that of
    the router's E experts, also where `params` holds fewer of them
    (`dispatch`'s `held`)."""
    b, s, d = x.shape
    t = b * s
    e = params["router"].shape[-1]
    disp = dispatch(params["router"], x.reshape(t, d), top_k,
                    capacity_of(t, top_k, e, capacity_factor),
                    held=params["wi"].shape[0])
    y = experts(params, disp.buf, act)
    return combine(y, disp, t, top_k).reshape(b, s, d).to(x.dtype), disp.aux

