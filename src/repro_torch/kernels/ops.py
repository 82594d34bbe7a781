"""Public routing points for every kernel of the port.

Counterpart of `repro/kernels/ops.py`: `cut_eval`, `fused_cut_round`,
`flash_attention`, `mlstm_chunk` and `mlstm_sequence`.  The kernel route
of `cut_eval` goes through the `cut_ad` Functions, so forward, reverse
and grad-of-grad all stay on the CUDA kernels; the epilogue
`(- c) * active` is plain torch, whose autograd supplies dc/dactive.  The
kernel route of `fused_cut_round` is `FusedRound`: the fused kernel on
the forward, the same round decomposed onto the `cut_ad` Functions on
every derivative.  The LLM kernels are forward-only, as the reference's
are.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cut_ad
from repro_torch.kernels import cut_eval as _kern
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import inner_round as _round
from repro_torch.kernels import mlstm_chunk as _mlstm
from repro_torch.kernels import ref

IMPLS = (None, "kernel", "ref")


def cut_eval(a, v, c, active, impl: str = None):
    """(A @ v - c) * active — the single routing point for cut mat-vecs.

    impl=None runs the kernel on CUDA tensors and the plain version on
    CPU tensors.  impl="kernel" insists on the kernel (raises on the
    CPU); impl="ref" forces the plain version on any device (the oracle
    the tests and the on-card smoke run compare against)."""
    if route(a, impl) == "ref":
        raw = _kern.matvec_ref(a, v)
    else:
        raw = cut_ad.MV.apply(a, v)
    return (raw - c) * active


def route(a, impl):
    """The route for `impl` on a's device, "kernel" or "ref"; raises on
    an unknown impl and on impl="kernel" off the card."""
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
    if impl is None:
        return "kernel" if a.is_cuda else "ref"
    if impl == "kernel" and not a.is_cuda:
        raise ValueError("impl='kernel' needs CUDA tensors; the CUDA "
                         "kernels do not run on the CPU")
    return impl


def fused_cut_round(a, v, g_other, mask, c, active, s, gamma, *,
                    eta_z: float, eta_s: float, eta_dual: float,
                    rho2: float, impl: str = None):
    """One fused level-2 inner-ADMM cut round -> (v_new, cv1, s_new,
    gamma_new); see `kernels.inner_round`.  Routed like `cut_eval`:
    impl=None runs `FusedRound` (the kernel) on CUDA tensors and the
    plain version on CPU tensors, "kernel" insists on the kernel, "ref"
    forces the plain version on any device."""
    if route(a, impl) == "ref":
        return _round.fused_cut_round_ref(
            a, v, g_other, mask, c, active, s, gamma, eta_z=eta_z,
            eta_s=eta_s, eta_dual=eta_dual, rho2=rho2)
    return FusedRound.apply(a, v, g_other, mask, c, active, s, gamma,
                            eta_z, eta_s, eta_dual, rho2)


class FusedRound(torch.autograd.Function):
    """The fused round with any-order derivatives and a batching rule.

    Forward: `inner_round.fused_cut_round` (the kernel on CUDA tensors;
    one round, or R at once with a leading run axis).  Backward: a
    `torch.func.vjp` of the same round recomputed from the saved inputs
    on the `cut_ad` MV/VM Functions; jvp: a `torch.func.jvp` of it.
    These are the counterpart of the reference's `custom_jvp`, whose
    tangents run the primitive decomposition
    (`repro/kernels/ops.py:120-156`).  Under `create_graph=True` or an
    outer `torch.func` transform the recomputation stays attached to the
    inputs, so grad-of-grad and forward-over-reverse run on the cut
    kernels too; a derivative with respect to A goes through
    `cut_ad.OUTER`.  vmap: every operand's run axis first (a shared
    operand broadcast at run stride 0) and one batched kernel launch for
    all R runs.  The step scalars take no derivative and cannot be
    batched: they are kernel arguments, as they are static arguments of
    the reference's kernel."""

    @staticmethod
    def forward(a, v, g_other, mask, c, active, s, gamma, eta_z, eta_s,
                eta_dual, rho2):
        return _round.fused_cut_round(
            a, v, g_other, mask, c, active, s, gamma, eta_z=eta_z,
            eta_s=eta_s, eta_dual=eta_dual, rho2=rho2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:8])
        ctx.save_for_forward(*inputs[:8])
        ctx.steps = inputs[8:]

    @staticmethod
    def _math(ctx, *ins):
        return _round.fused_round_math(cut_ad.MV.apply, cut_ad.VM.apply,
                                       *ins, *ctx.steps)

    @staticmethod
    def backward(ctx, *cts):
        need = ctx.needs_input_grad[:8]
        ins = ctx.saved_tensors
        wrt = [i for i, n in enumerate(need) if n]

        def round_of(*xs):
            full = list(ins)
            for i, x in zip(wrt, xs):
                full[i] = x
            return FusedRound._math(ctx, *full)

        # every output depends on every input, so no cotangent is unused
        _, pullback = torch.func.vjp(round_of, *(ins[i] for i in wrt))
        grads = iter(pullback(tuple(ct.contiguous() for ct in cts)))
        return (*(next(grads) if n else None for n in need),
                None, None, None, None)

    @staticmethod
    def jvp(ctx, *tangents):
        ins = ctx.saved_tensors
        tans = tuple(torch.zeros_like(x) if t is None else t
                     for x, t in zip(ins, tangents[:8]))
        return torch.func.jvp(lambda *xs: FusedRound._math(ctx, *xs),
                              ins, tans)[1]

    @staticmethod
    def vmap(info, in_dims, a, v, g_other, mask, c, active, s, gamma,
             eta_z, eta_s, eta_dual, rho2):
        if any(d is not None for d in in_dims[8:]):
            raise ValueError("fused_cut_round: the step sizes cannot be "
                             "batched (swept); they are kernel arguments")
        n = info.batch_size
        ranks = (2, 1, 1, 1, 1, 1, 1, 1)
        operands = (cut_ad.batch_front(x, d, n, k) for x, d, k in zip(
            (a, v, g_other, mask, c, active, s, gamma), in_dims, ranks))
        return (FusedRound.apply(*operands, eta_z, eta_s, eta_dual, rho2),
                (0, 0, 0, 0))


# ---------------------------------------------------------------------------
# attention / mLSTM
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128,
                    impl: str = None):
    """Blockwise GQA attention: q (B,S,H,hd), k/v (B,T,Hkv,hd) ->
    (B,S,H,hd).  Routed like `cut_eval`.

    The reference's wrapper pads to (block_q, block_k) multiples, which
    only causal masking makes harmless, so it refuses non-causal inputs
    that are not block-aligned; this wrapper keeps that contract (the
    same `ValueError`), though the kernel masks ragged edges itself."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    bq = min(block_q, max(8, s))
    bk = min(block_k, max(8, t))
    s_pad = ((s + bq - 1) // bq) * bq
    t_pad = ((t + bk - 1) // bk) * bk
    if not causal and (t_pad != t or s_pad != s):
        raise ValueError(
            "non-causal flash_attention requires block-aligned shapes: "
            f"got q seq len {s} (block_q={bq}, padded {s_pad}) and "
            f"k/v seq len {t} (block_k={bk}, padded {t_pad}); pad the "
            "inputs to block multiples or use causal=True")
    if route(q, impl) == "ref":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _flash.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  window=window)


def mlstm_chunk(q, k, v, li, lf, c, n, m, impl: str = None):
    """One mLSTM chunk for all (batch, head) pairs in the kernel layout
    -> (y, c', n', m'); see `kernels.mlstm_chunk`.  Routed like
    `cut_eval`."""
    if route(q, impl) == "ref":
        return ref.mlstm_chunk_ref(q, k, v, li, lf, c, n, m)
    return _mlstm.mlstm_chunk(q, k, v, li, lf, c, n, m)


def mlstm_sequence(q, k, v, li, lf, state, chunk: int = 256,
                   impl: str = None):
    """Full-sequence chunkwise mLSTM through `mlstm_chunk`: q/k/v
    (B,S,H,hd), li/lf (B,S,H); state dict(c,n,m) as in models.xlstm.
    The full chunks run one after another and a ragged tail shorter than
    `chunk` is one more call at its own length, as in the reference.
    Returns (y (B,S,H,hd), state)."""
    s = q.shape[1]
    n_full = s // chunk

    def to_bh(a):                     # (B,S,H,...) -> (B,H,S,...)
        return a.transpose(1, 2).contiguous() if a.dim() == 4 \
            else a.transpose(1, 2)[..., None].contiguous()

    qb, kb, vb, lib, lfb = (to_bh(x) for x in (q, k, v, li, lf))
    c = state["c"]
    n = state["n"][:, :, None]
    m = state["m"][:, :, None, None]
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n_full)]
    if s > n_full * chunk:
        bounds.append((n_full * chunk, s))
    ys = []
    for lo, hi in bounds:
        y, c, n, m = mlstm_chunk(*(x[:, :, lo:hi].contiguous()
                                   for x in (qb, kb, vb, lib, lfb)),
                                 c, n, m, impl=impl)
        ys.append(y)
    y = torch.cat(ys, dim=2).transpose(1, 2)
    return y, {"c": c, "n": n[:, :, 0], "m": m[:, :, 0, 0]}
