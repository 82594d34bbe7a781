"""AFTO instantiated for LLM-scale architectures (the paper's robust-HPO
trilevel, Eq. 31, with the model zoo as level 3).

Counterpart of `repro/fed/trilevel_llm.py`.  Variables:
  x1 = phi   : per-category regularization log-strengths (d1 = 4: embed /
               mixer / mlp / other) — exact everywhere (tiny).
  x2 = p     : adversarial embedding perturbation; worker j owns block j
               (Eq. 31's p' = [p'_1..p'_N]), so local copies store only
               their own (b_local, seq, d_model) block.
  x3 = w     : model weights; worker copies are a leading-(N,) stacked
               param tree.

Cut storage: phi-blocks exact; x2/x3/z2/z3 blocks either EXACT (stacked
model-sized coefficient trees) or SKETCHED into an r-dim count-sketch
subspace (`fed/sketch.py`).

Casts follow the reference's one for one: the parameters keep their
dtype, duals, cut values and tree dots are f32, and a step size meets a
bf16 leaf as a bf16 scalar (`utils.tree.weak`), as JAX's weak types do.
The refresh's derivatives are `torch.func` transforms (`utils.tree.grad`
/ `value_and_grad`, the worker axis under `torch.func.vmap`), so its
value-and-grad of h_I / h_II through rollouts whose rounds take
gradients is second-order AD, as in the reference; the step's first-
order worker gradients take one autograd backward through a vmapped
forward (`_f1_grads`); `jax.lax.stop_gradient` is `.detach()`. The
model's forward runs the plain math (`train_loss`'s `impl="ref"`): the
attention and mLSTM kernels are forward-only. Checkpointing cannot nest
under `torch.func`, so `FedHyper(remat=True)` raises
`NotImplementedError` at the first objective (`models.transformer`); the
drivers pass remat=False. Every function returns a new state and leaves
its argument untouched.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.utils._pytree as pytree

from repro_torch.data import stream as stream_lib
from repro_torch.fed.sketch import sketch_rows, unsketch_rows
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.utils import tree as tree_lib
from repro_torch.utils.tree import (DictKey, tree_dot, tree_leaves,
                                    tree_leaves_with_path, tree_map,
                                    tree_norm_sq, tree_sub, weak)

# ---------------------------------------------------------------------------
# hyper / state
# ---------------------------------------------------------------------------

N_PHI = 4  # regularization categories: embed / mixer / mlp / other


@dataclasses.dataclass(frozen=True)
class FedHyper:
    n_workers: int = 16
    k_inner: int = 1
    p_max: int = 2
    cut_mode: str = "exact"        # exact | sketch
    sketch_r: int = 4096
    adv_penalty: float = 1.0       # c in Eq. 31
    eta_x: float = 1e-2
    eta_z: float = 1e-2
    eta_lambda: float = 1e-2
    eta_theta: float = 1e-2
    eta_dual_inner: float = 1e-2
    kappa3: float = 1.0
    eps_i: float = 1e-3
    eps_ii: float = 1e-3
    mu_i: float = 0.5
    mu_ii: float = 0.5
    alpha: float = 1e4             # shared variable-norm bound
    alpha4: float = 100.0
    alpha5: float = 100.0
    c1_floor: float = 1e-3
    c2_floor: float = 1e-3
    remat: bool = True
    unroll: bool = False            # the reference's flag; no effect here
    first_order_cuts: bool = False  # stop-grad through the inner rollout
    seed_i: int = 1                # sketch seeds per cut layer
    seed_ii: int = 2

    def c1(self, t):
        return torch.clamp(1.0 / (self.eta_lambda * (t + 1.0) ** 0.25),
                           min=self.c1_floor)

    def c2(self, t):
        return torch.clamp(1.0 / (self.eta_theta * (t + 1.0) ** 0.25),
                           min=self.c2_floor)


@dataclasses.dataclass
class LLMCutSet:
    """Cuts over (z1, z2, z3, {x2_j}, {x3_j}).

    exact mode: a2/a3 are (P,)-stacked trees, b2/b3 are (P,N,)-stacked.
    sketch mode: a2/a3 are (P, r) tensors, b2/b3 are (P, N, r)."""
    a1: torch.Tensor              # (P, N_PHI) — always exact
    a2: Any
    a3: Any
    b2: Any
    b3: Any
    c: torch.Tensor               # (P,)
    active: torch.Tensor          # (P,)
    age: torch.Tensor             # (P,) int32


@dataclasses.dataclass
class FedLLMState:
    X1: torch.Tensor              # (N, N_PHI)
    X2: torch.Tensor              # (N, b_local, seq, d_model) own blocks
    X3: Any                       # (N,)-stacked model params
    z1: torch.Tensor              # (N_PHI,)
    z2: torch.Tensor              # (N, b_local, seq, d_model)
    z3: Any                       # model params
    theta: torch.Tensor           # (N, N_PHI) consensus duals
    lam: torch.Tensor             # (P,)
    cuts: LLMCutSet               # II-layer polytope (enters L_p)
    cuts_i: LLMCutSet             # I-layer polytope (enters level-2 inner)
    gamma_k: torch.Tensor         # (P,) last inner multipliers (drop rule)
    stale_lam: torch.Tensor       # (N, P)
    stale_theta: torch.Tensor     # (N, N_PHI)
    t: torch.Tensor               # iteration, 0-d int32


def _register(cls):
    """A `torch.utils._pytree` node whose children are its fields in the
    reference's order, so `utils.tree`, `checkpoint.io` and `convert`
    take it as they take `AFTOState`."""
    names = tuple(f.name for f in dataclasses.fields(cls))
    pytree.register_pytree_node(
        cls,
        lambda x: ([getattr(x, n) for n in names], None),
        lambda children, _ctx: cls(**dict(zip(names, children))),
        serialized_type_name=f"repro_torch.fed.trilevel_llm.{cls.__name__}")


_register(LLMCutSet)
_register(FedLLMState)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _stack_n(tree, n):
    return tree_map(lambda x: x[None].expand((n,) + tuple(x.shape))
                    .contiguous(), tree)


def _empty_cuts(hyper: FedHyper, x2_block, params) -> LLMCutSet:
    p, n = hyper.p_max, hyper.n_workers
    dev = x2_block.device
    if hyper.cut_mode == "sketch":
        r = hyper.sketch_r
        a2 = torch.zeros((p, r), dtype=torch.float32, device=dev)
        a3 = torch.zeros((p, r), dtype=torch.float32, device=dev)
        b2 = torch.zeros((p, n, r), dtype=torch.float32, device=dev)
        b3 = torch.zeros((p, n, r), dtype=torch.float32, device=dev)
    else:
        def stack(lead, tree):
            return tree_map(lambda x: torch.zeros(
                lead + tuple(x.shape), dtype=x.dtype, device=x.device),
                tree)

        a2 = stack((p, n), x2_block)          # z2 is the (N,...) stack
        a3 = stack((p,), params)
        b2 = stack((p, n), x2_block)
        b3 = stack((p, n), params)
    return LLMCutSet(
        a1=torch.zeros((p, N_PHI), dtype=torch.float32, device=dev),
        a2=a2, a3=a3, b2=b2, b3=b3,
        c=torch.zeros((p,), dtype=torch.float32, device=dev),
        active=torch.zeros((p,), dtype=torch.float32, device=dev),
        age=torch.full((p,), -1, dtype=torch.int32, device=dev))


def init_fed_state(cfg: ModelConfig, hyper: FedHyper,
                   generator: torch.Generator, b_local: int, seq: int,
                   device=None) -> FedLLMState:
    """The t = 0 state, the weights drawn from `generator` (on `device`)
    by the port's `init_params`."""
    n = hyper.n_workers
    params = tfm.init_params(cfg, generator, device=device)
    dev = tree_leaves(params)[0].device

    def f32(*shape, value=0.0):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    x2_block = torch.zeros((b_local, seq, cfg.d_model), dtype=torch.bfloat16,
                           device=dev)
    p = hyper.p_max
    return FedLLMState(
        X1=f32(n, N_PHI, value=-3.0),
        X2=torch.zeros((n,) + tuple(x2_block.shape), dtype=x2_block.dtype,
                       device=dev),
        X3=_stack_n(params, n),
        z1=f32(N_PHI, value=-3.0),
        z2=torch.zeros((n,) + tuple(x2_block.shape), dtype=x2_block.dtype,
                       device=dev),
        z3=params,
        theta=f32(n, N_PHI),
        lam=f32(p),
        cuts=_empty_cuts(hyper, x2_block, params),
        cuts_i=_empty_cuts(hyper, x2_block, params),
        gamma_k=f32(p),
        stale_lam=f32(n, p),
        stale_theta=f32(n, N_PHI),
        t=torch.zeros((), dtype=torch.int32, device=dev))


def batch_stream(cfg: ModelConfig, n_workers: int, b_local: int,
                 seq: int, seed=0, zipf_a: float = 1.2) -> stream_lib.Stream:
    """Token stream for the LLM AFTO step: each worker's per-iteration
    {tokens, val_tokens} row is drawn on the device from its (key,
    iteration, worker) key (`data.stream.zipf_tokens`, distribution-
    matched to the reference's, not bit-matched).  Batches stack to the
    `afto_llm_step` layout ((N, b_local, seq) int32); tokens double as
    val_tokens exactly like the host driver's chunks."""
    def sample(key, device):
        toks = stream_lib.zipf_tokens(key, (b_local, seq), cfg.vocab_size,
                                      zipf_a, device=device)
        return {"tokens": toks, "val_tokens": toks}

    return stream_lib.make_stream(sample, n_workers, seed)


# ---------------------------------------------------------------------------
# objectives (per worker)
# ---------------------------------------------------------------------------

def _phi_category(path) -> int:
    name = ""
    for entry in reversed(path):
        if isinstance(entry, DictKey):
            name = str(entry.key)
            break
    if name in ("embed", "lm_head", "enc_pos"):
        return 0
    if name in ("wq", "wk", "wv", "wo", "xwq", "xwk", "xwv", "xwo",
                "in_proj", "out_proj", "conv_w", "xproj", "wz", "wo_gate",
                "rz", "a_log"):
        return 1
    if name in ("wi", "wg", "router"):
        return 2
    return 3


def reg_term(phi, params):
    """sum_cat exp(phi_cat) * ||params_cat||^2 / size_cat."""
    dev = phi.device
    sq = [torch.zeros((), dtype=torch.float32, device=dev)] * N_PHI
    cnt = [0] * N_PHI
    for path, leaf in tree_leaves_with_path(params):
        c = _phi_category(path)
        sq[c] = sq[c] + torch.sum(torch.square(leaf.float()))
        cnt[c] += int(leaf.numel())
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for c in range(N_PHI):
        if cnt[c]:
            total = total + torch.exp(phi[c]) * sq[c] / cnt[c]
    return total


def f1_loss(cfg, w_j, batch_j, hyper: FedHyper):
    """Clean validation CE for one worker."""
    return tfm.train_loss(cfg, w_j, batch_j["val_tokens"],
                          batch_j.get("val_frames"), remat=hyper.remat,
                          unroll=hyper.unroll)


def f3_loss(cfg, phi, p_j, w_j, batch_j, hyper: FedHyper):
    """Perturbed train CE + e^phi regularization (level 3, minimized)."""
    ce = tfm.train_loss(cfg, w_j, batch_j["tokens"],
                        batch_j.get("frames"), remat=hyper.remat,
                        unroll=hyper.unroll, embed_perturbation=p_j)
    return ce + reg_term(phi, w_j)


def f2_loss(cfg, phi, p_j, w_j, batch_j, hyper: FedHyper):
    """Negated adversarial objective (level 2 maximizes)."""
    ce = tfm.train_loss(cfg, w_j, batch_j["tokens"],
                        batch_j.get("frames"), remat=hyper.remat,
                        unroll=hyper.unroll, embed_perturbation=p_j)
    return -(ce - hyper.adv_penalty
             * torch.mean(torch.square(p_j.float())))


def _per_worker(fn, *stacked):
    """fn on each worker's slice of the (N,)-stacked trees, stacked back:
    the reference's `jax.vmap` over the worker axis."""
    return torch.func.vmap(fn)(*stacked)


def _f1_grads(cfg, hyper: FedHyper, X3, batch):
    """grad f1 at every worker's weights, stacked (the reference's
    `vmap(grad(f1))`): one forward vmapped over the workers and one
    autograd backward of their summed losses.  A worker's loss depends on
    its own row alone, so the sum's gradient is each row's own; this
    takes about half the host time of vmapping `torch.func.grad` (the
    step is host-bound).  The refresh differentiates through gradients
    and stays on `torch.func`."""
    leaves, tdef = tree_lib.tree_flatten(X3)
    live = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        losses = _per_worker(lambda w, bj: f1_loss(cfg, w, bj, hyper),
                             tree_lib.tree_unflatten(tdef, live), batch)
        grads = torch.autograd.grad(losses.sum(), live, allow_unused=True)
    return tree_lib.tree_unflatten(
        tdef, [torch.zeros_like(x) if g is None else g
               for g, x in zip(grads, live)])


def _stacked_grad(local, stacked, *others):
    """Each worker's gradient of local(x_j, *others_j) w.r.t. its row x_j
    of `stacked` (the reference's `vmap(grad(local))`), as the gradient
    of the workers' summed losses: rows do not interact, so the sum's
    gradient is each row's own.  A `torch.func.grad` around one vmapped
    forward costs less host time than a vmapped `torch.func.grad`, and
    gives the same bits; it nests under the refresh's outer
    value-and-grad."""
    return tree_lib.grad(
        lambda x: _per_worker(local, x, *others).sum(), stacked)[0]


# ---------------------------------------------------------------------------
# cut algebra (mode-dispatched)
# ---------------------------------------------------------------------------

def _dot_stacked_p(stacked, v):
    """<a_l, v> per cut slot; stacked leaves have leading (P,)."""
    return sum(torch.einsum("pd,d->p",
                            a.reshape(a.shape[0], -1).float(),
                            x.reshape(-1).float())
               for a, x in zip(tree_leaves(stacked), tree_leaves(v)))


def _dot_stacked_pn(stacked, V):
    return sum(torch.einsum("pnd,nd->p",
                            b.reshape(b.shape[0], b.shape[1], -1).float(),
                            x.reshape(x.shape[0], -1).float())
               for b, x in zip(tree_leaves(stacked), tree_leaves(V)))


def eval_llm_cuts(hyper: FedHyper, cuts: LLMCutSet, z1, z2, z3, X2, X3,
                  seed: int):
    val = torch.einsum("pd,d->p", cuts.a1, z1)
    if hyper.cut_mode == "sketch":
        r = hyper.sketch_r
        s_z2 = sketch_rows(z2, seed, r)
        s_x2 = sketch_rows(X2, seed, r, batch_dims=1)         # (N,r)
        # z3 and the X3 rows share their hashes: one pass over (N+1) rows
        s_3 = sketch_rows(tree_map(lambda z, x: torch.cat([z[None], x]),
                                   z3, X3), seed, r, batch_dims=1)
        s_z3, s_x3 = s_3[0], s_3[1:]
        val = val + cuts.a2 @ s_z2 + cuts.a3 @ s_z3 \
            + torch.einsum("pnr,nr->p", cuts.b2, s_x2) \
            + torch.einsum("pnr,nr->p", cuts.b3, s_x3)
    else:
        val = val + _dot_stacked_p(cuts.a2, z2) \
            + _dot_stacked_p(cuts.a3, z3) \
            + _dot_stacked_pn(cuts.b2, X2) \
            + _dot_stacked_pn(cuts.b3, X3)
    return (val - cuts.c) * cuts.active


def _contract_b(hyper: FedHyper, cuts: LLMCutSet, weights_np, block: str,
                template, seed: int):
    """sum_l w[j,l] * b_{l,j} as a per-worker tree (the worker-update cut
    gradient)."""
    w = weights_np * cuts.active[None, :]
    b = getattr(cuts, block)
    if hyper.cut_mode == "sketch":
        coeff = torch.einsum("np,pnr->nr", w, b)               # (N,r)
        return unsketch_rows(template, coeff, seed, batch_dims=1)
    return tree_map(
        lambda bb: torch.einsum("np,pn...->n...", w,
                                bb.float()).to(bb.dtype), b)


def _contract_a(hyper: FedHyper, cuts: LLMCutSet, weights_p, block: str,
                template, seed: int):
    w = weights_p * cuts.active
    a = getattr(cuts, block)
    if hyper.cut_mode == "sketch":
        coeff = torch.einsum("p,pr->r", w, a)
        return unsketch_rows(template, coeff, seed)
    return tree_map(
        lambda aa: torch.tensordot(w, aa.float(),
                                   dims=([0], [0])).to(aa.dtype), a)


def _set_row(buf, slot, row):
    """buf with row `slot` (a 0-d index tensor) replaced, out of place."""
    return buf.index_put((slot.reshape(1),), row.to(buf.dtype)[None])


def _store_block(hyper: FedHyper, cur, grad_tree, slot, seed: int,
                 per_worker: bool):
    """Write one cut's coefficient block into slot (sketch or exact)."""
    if hyper.cut_mode == "sketch":
        s = sketch_rows(grad_tree, seed, hyper.sketch_r,
                        batch_dims=int(per_worker))
        return _set_row(cur, slot, s)
    return tree_map(lambda buf, g: _set_row(buf, slot, g), cur, grad_tree)


# ---------------------------------------------------------------------------
# the per-iteration AFTO step (Eqs. 16-21, LLM instantiation)
# ---------------------------------------------------------------------------

def _bmask(active, x):
    return active.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)


def _step_workers(cfg: ModelConfig, hyper: FedHyper, state: FedLLMState,
                  batch: Dict[str, Any], active: torch.Tensor):
    """The workers' half of the step (Eq. 16): (X1, X2, X3) of the
    workers in `state`, whose rows, cut b-blocks, stale views, batch
    rows and `active` entries it holds (all N, or a shard's block)."""
    seed = hyper.seed_ii
    g3_f1 = _f1_grads(cfg, hyper, state.X3, batch)
    g3_cut = _contract_b(hyper, state.cuts, state.stale_lam, "b3",
                         state.z3, seed)
    g2_cut = _contract_b(hyper, state.cuts, state.stale_lam, "b2",
                         state.X2[0], seed)

    X3 = tree_map(
        lambda x, gf, gc: x - weak(hyper.eta_x, x) * _bmask(active, x)
        * (gf + gc).to(x.dtype),
        state.X3, g3_f1, g3_cut)
    X2 = tree_map(
        lambda x, gc: x - weak(hyper.eta_x, x) * _bmask(active, x)
        * gc.to(x.dtype),
        state.X2, g2_cut)
    # x1: f1 has no phi-gradient; theta (stale) + no cut block -> dual pull
    X1 = state.X1 - hyper.eta_x * active[:, None] * state.stale_theta
    return X1, X2, X3


def _z_step(hyper: FedHyper, z, g):
    """z - eta_z g, leafwise in z's dtype."""
    return tree_map(lambda zz, gg: zz - weak(hyper.eta_z, zz)
                    * gg.to(zz.dtype), z, g)


def _step_duals(hyper: FedHyper, state: FedLLMState, active, cutval,
                X1, X2, X3, z1, z2, z3) -> FedLLMState:
    """The dual updates (Eqs. 20/21) and the stale views of the newly
    active workers, from the step's new variables and cut values."""
    t = state.t
    lam = torch.clamp(
        state.lam + hyper.eta_lambda * (cutval - hyper.c1(t) * state.lam),
        0.0, math.sqrt(hyper.alpha4)) * state.cuts.active
    r_theta = math.sqrt(hyper.alpha5) / N_PHI
    theta = torch.clamp(
        state.theta + hyper.eta_theta
        * ((X1 - z1[None]) - hyper.c2(t) * state.theta),
        -r_theta, r_theta)

    # ---- stale views of newly-active workers
    stale_lam = torch.where(active[:, None] > 0, lam[None], state.stale_lam)
    stale_theta = torch.where(active[:, None] > 0, theta, state.stale_theta)

    return dataclasses.replace(
        state, X1=X1, X2=X2, X3=X3, z1=z1, z2=z2, z3=z3, theta=theta,
        lam=lam, stale_lam=stale_lam, stale_theta=stale_theta, t=t + 1)


def afto_llm_step(cfg: ModelConfig, hyper: FedHyper,
                  state: FedLLMState, batch: Dict[str, Any],
                  active: torch.Tensor) -> FedLLMState:
    """batch: worker-stacked {"val_tokens": (N,b,S), "tokens": (N,b,S)}.
    active: (N,) mask."""
    seed = hyper.seed_ii

    # ---- workers (Eq. 16)
    X1, X2, X3 = _step_workers(cfg, hyper, state, batch, active)

    # ---- master (Eqs. 17-19)
    gz1 = -torch.sum(state.theta, dim=0) \
        + torch.einsum("p,pd->d", state.lam * state.cuts.active,
                       state.cuts.a1)
    z1 = state.z1 - hyper.eta_z * gz1
    z2 = _z_step(hyper, state.z2, _contract_a(hyper, state.cuts, state.lam,
                                              "a2", state.z2, seed))
    z3 = _z_step(hyper, state.z3, _contract_a(hyper, state.cuts, state.lam,
                                              "a3", state.z3, seed))

    # ---- duals (Eqs. 20/21)
    cutval = eval_llm_cuts(hyper, state.cuts, z1, z2, z3, X2, X3, seed)
    return _step_duals(hyper, state, active, cutval, X1, X2, X3, z1, z2, z3)


# ---------------------------------------------------------------------------
# cut refresh (Eqs. 23-25, LLM instantiation)
# ---------------------------------------------------------------------------

def _rollout3(cfg, hyper: FedHyper, z1, Z2, X3_0, z3_0, batch):
    """K rounds of the level-3 federated ADMM (Eqs. 5-7); differentiable
    w.r.t. (z1, Z2).  Duals start at zero each refresh and are f32."""
    X3, z3 = X3_0, z3_0
    duals = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                           device=x.device), X3_0)
    for _ in range(hyper.k_inner):
        def local(w_, p_j, d_j, dual_j, z3=z3):
            cons = tree_dot(dual_j, tree_sub(w_, z3)) \
                + 0.5 * hyper.kappa3 * tree_norm_sq(tree_sub(w_, z3))
            return f3_loss(cfg, z1, p_j, w_, d_j, hyper) + cons

        g = _stacked_grad(local, X3, Z2, batch, duals)
        X3_new = tree_map(
            lambda x, gg: (x - weak(hyper.eta_x, x) * gg.to(x.dtype)),
            X3, g)
        # master step at old X3 (Eq. 6): grad_z3 = -sum_j(dual + k(x-z))
        gz = tree_map(
            lambda d, x, z: -torch.sum(
                d + hyper.kappa3 * (x.float() - z.float()[None]), dim=0),
            duals, X3, z3)
        z3_new = tree_map(
            lambda z, gg: z - weak(hyper.eta_z, z) * gg.to(z.dtype),
            z3, gz)
        duals = tree_map(
            lambda d, x, z: d + hyper.eta_dual_inner
            * (x.float() - z.float()[None]),
            duals, X3_new, z3_new)
        X3, z3 = X3_new, z3_new
    return X3, z3


def _rollout2(cfg, hyper: FedHyper, z1, z3, X2_0, Z2_0, X3, batch,
              cuts_i: LLMCutSet):
    """K rounds of the level-2 inner ADMM: workers ascend the adversarial
    objective; the I-layer polytope enters via multipliers gamma."""
    gamma = torch.zeros_like(cuts_i.c)
    s = torch.zeros_like(cuts_i.c)
    seed = hyper.seed_i
    X2, Z2 = X2_0, Z2_0
    for _ in range(hyper.k_inner):
        def local(p_, w_j, d_j, z2_j):
            cons = 0.5 * hyper.kappa3 * torch.sum(
                torch.square((p_ - z2_j).float()))
            return f2_loss(cfg, z1, p_, w_j, d_j, hyper) + cons

        g = _stacked_grad(local, X2, X3, batch, Z2)
        # cut-gradient contribution on x2 blocks (gamma-weighted)
        g_cut = _contract_b(hyper, cuts_i, gamma[None].expand(
            (hyper.n_workers,) + tuple(gamma.shape)), "b2", X2[0], seed)
        X2_new = X2 - weak(hyper.eta_x, X2) * (g + g_cut).to(X2.dtype)
        Z2_new = Z2 - weak(hyper.eta_z * hyper.kappa3, Z2) * (Z2 - X2)
        # I-layer cut value at (z1, z2'=Z2_new, z3, {x3_j}=X3); x2 blocks
        # do not participate in I-layer cuts (their b2 slots are zero)
        cutval = eval_llm_cuts(hyper, cuts_i, z1, Z2_new, z3, X2_new, X3,
                               seed)
        s = torch.clamp(s - hyper.eta_x * (gamma + cutval + s), min=0.0) \
            * cuts_i.active
        gamma = torch.clamp(
            gamma + hyper.eta_dual_inner * (cutval + s), min=0.0) \
            * cuts_i.active
        X2, Z2 = X2_new, Z2_new
    return X2, Z2, gamma


def _cut_slot(cuts: LLMCutSet):
    """The slot a new cut takes: the first free one, else the oldest
    (integer eviction scores; argmin takes the first index of a tie)."""
    score = torch.where(cuts.active > 0, cuts.age,
                        torch.full_like(cuts.age, -(2 ** 30)))
    return torch.argmin(score)


def _write_cut(hyper: FedHyper, cuts: LLMCutSet, grads: Dict[str, Any],
               slot, c, t, seed, sketched=()) -> LLMCutSet:
    """`cuts` with `slot` holding the cut of coefficient blocks `grads`
    and constant `c`, made at t; a block named in `sketched` is its
    sketch already (a worker mesh sums the shards' sketches)."""
    dev = cuts.c.device

    def block(name, per_worker):
        cur = getattr(cuts, name)
        if name not in grads:
            return cur
        if name in sketched:
            return _set_row(cur, slot, grads[name])
        return _store_block(hyper, cur, grads[name], slot, seed, per_worker)

    a1_row = grads.get("a1", torch.zeros((N_PHI,), dtype=torch.float32,
                                         device=dev))
    return LLMCutSet(
        a1=_set_row(cuts.a1, slot, a1_row),
        a2=block("a2", False), a3=block("a3", False),
        b2=block("b2", True), b3=block("b3", True),
        c=_set_row(cuts.c, slot, c),
        active=_set_row(cuts.active, slot, torch.ones((), device=dev)),
        age=_set_row(cuts.age, slot, torch.as_tensor(t)))


def _add_llm_cut(hyper: FedHyper, cuts: LLMCutSet, grads: Dict[str, Any],
                 point: Dict[str, Any], h0, eps, mu, bound, t, seed
                 ) -> LLMCutSet:
    slot = _cut_slot(cuts)
    gv0 = torch.zeros((), dtype=torch.float32, device=cuts.c.device)
    v0_sq = torch.zeros((), dtype=torch.float32, device=cuts.c.device)
    for k in grads:
        gv0 = gv0 + tree_dot(grads[k], point[k])
        v0_sq = v0_sq + tree_norm_sq(point[k])
    c = eps + mu * (bound + v0_sq) - h0 + gv0
    return _write_cut(hyper, cuts, grads, slot, c, t, seed)


def _drop_inactive(state: FedLLMState, cuts_i: LLMCutSet,
                   cuts_ii: LLMCutSet, gamma_k) -> FedLLMState:
    """The drop rule (Eq. 25), newly-added cuts exempt, and the
    refreshed state."""
    t = state.t
    fresh_i = (cuts_i.age == t).float()
    keep_i = ((torch.abs(gamma_k) > 1e-8).float() + fresh_i) > 0
    cuts_i = dataclasses.replace(cuts_i,
                                 active=cuts_i.active * keep_i.float())
    fresh_ii = (cuts_ii.age == t).float()
    keep_ii = ((torch.abs(state.lam) > 1e-8).float() + fresh_ii) > 0
    cuts_ii = dataclasses.replace(cuts_ii,
                                  active=cuts_ii.active * keep_ii.float())

    return dataclasses.replace(
        state, cuts_i=cuts_i, cuts=cuts_ii,
        lam=state.lam * cuts_ii.active, gamma_k=gamma_k)


def cut_refresh_llm(cfg: ModelConfig, hyper: FedHyper,
                    state: FedLLMState, batch) -> FedLLMState:
    t = state.t
    n = hyper.n_workers

    def detached(tree):
        return tree_map(lambda x: x.detach(), tree)

    # ---- I-layer cut (Eq. 23): h_I = ||[X3; z3] - rollout3(z1, Z2)||^2
    def h_i(X3, z3, z1, Z2):
        ro = _rollout3(cfg, hyper, z1, Z2, detached(X3), detached(z3),
                       batch)
        if hyper.first_order_cuts:
            ro = detached(ro)
        X3_k, z3_k = ro
        return tree_norm_sq(tree_sub(X3, X3_k)) \
            + tree_norm_sq(tree_sub(z3, z3_k))

    h0_i, g_i = tree_lib.value_and_grad(h_i, state.X3, state.z3, state.z1,
                                        state.z2)
    gX3, gz3, gz1, gz2 = g_i
    bound_i = (n + 3) * hyper.alpha
    cuts_i = _add_llm_cut(
        hyper, state.cuts_i,
        {"a1": gz1, "a2": gz2, "a3": gz3, "b3": gX3},
        {"a1": state.z1, "a2": state.z2, "a3": state.z3, "b3": state.X3},
        h0_i, hyper.eps_i, hyper.mu_i, bound_i, t, hyper.seed_i)

    # ---- II-layer cut (Eq. 24): h_II = ||[X2; Z2] - rollout2(...)||^2
    def h_ii(X2, Z2, z1, z3, X3):
        X2_k, Z2_k, gamma_k = _rollout2(cfg, hyper, z1, z3, X2.detach(),
                                        Z2.detach(), X3, batch, cuts_i)
        if hyper.first_order_cuts:
            X2_k, Z2_k = X2_k.detach(), Z2_k.detach()
        h = torch.sum(torch.square((X2 - X2_k).float())) \
            + torch.sum(torch.square((Z2 - Z2_k).float()))
        return h, gamma_k

    (h0_ii, gamma_k), g_ii = tree_lib.value_and_grad(
        h_ii, state.X2, state.z2, state.z1, state.z3, state.X3,
        has_aux=True)
    gX2, gZ2, gz1b, gz3b, gX3b = g_ii
    bound_ii = (2 * n + 2) * hyper.alpha
    cuts_ii = _add_llm_cut(
        hyper, state.cuts,
        {"a1": gz1b, "a2": gZ2, "a3": gz3b, "b2": gX2, "b3": gX3b},
        {"a1": state.z1, "a2": state.z2, "a3": state.z3,
         "b2": state.X2, "b3": state.X3},
        h0_ii, hyper.eps_ii, hyper.mu_ii, bound_ii, t, hyper.seed_ii)

    return _drop_inactive(state, cuts_i, cuts_ii, gamma_k)


# ---------------------------------------------------------------------------
# plain (non-trilevel) reference training step
# ---------------------------------------------------------------------------

def plain_train_step(cfg: ModelConfig, params, opt_state, tokens,
                     frames=None, optimizer=None, remat: bool = True,
                     unroll: bool = False):
    """One optimizer step on the next-token CE, by autograd (so `remat`
    checkpoints each block).  Returns (params, opt_state, loss)."""
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import apply_updates
    opt = optimizer or adamw(3e-4, weight_decay=0.1)
    leaves, tdef = tree_lib.tree_flatten(params)
    live = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        loss = tfm.train_loss(cfg, tree_lib.tree_unflatten(tdef, live),
                              tokens, frames, unroll=unroll, remat=remat)
        grads = torch.autograd.grad(loss, live)
    grads = tree_lib.tree_unflatten(tdef, list(grads))
    updates, opt_state = opt.update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state, loss.detach()
