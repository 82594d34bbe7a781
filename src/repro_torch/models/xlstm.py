"""xLSTM sequence mixers: mLSTM (matrix memory) and sLSTM (scalar memory).

Counterpart of `repro/models/xlstm.py`.  mLSTM prefill uses the
chunkwise-parallel form: within a chunk the intra-chunk terms are a
decayed attention-like product, across chunks the (hd x hd) matrix
memory C and normalizer n are carried with a max-stabilizer m.  On CUDA
tensors each chunk runs the hand-written `mlstm_chunk` kernel
(`ops.mlstm_chunk`); on CPU tensors it runs `mlstm_chunk_body`, the
kernel's oracle.  Decode is the O(1) recurrent update, plain torch.

sLSTM keeps a per-head scalar-memory recurrence with exponential gating;
it is sequential, so prefill loops over time in plain torch.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, full


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def mlstm_init(generator, d, n_heads, head_dim, dtype, device=None,
               lead: Sequence[int] = ()):
    kw = dict(device=device, lead=lead)
    f32 = torch.float32
    return {
        "wq": dense_init(generator, (d, n_heads, head_dim), dtype,
                         fan_in=d, **kw),
        "wk": dense_init(generator, (d, n_heads, head_dim), dtype,
                         fan_in=d, **kw),
        "wv": dense_init(generator, (d, n_heads, head_dim), dtype,
                         fan_in=d, **kw),
        "wi": dense_init(generator, (d, n_heads), f32, fan_in=d, **kw),
        "wf": dense_init(generator, (d, n_heads), f32, fan_in=d, **kw),
        "fb": full((n_heads,), 3.0, f32, **kw),  # forget-bias ~ keep
        "wo": dense_init(generator, (n_heads, head_dim, d), dtype,
                         fan_in=n_heads * head_dim, **kw),
    }


def slstm_init(generator, d, n_heads, head_dim, dtype, device=None,
               lead: Sequence[int] = ()):
    kw = dict(device=device, lead=lead)
    f32 = torch.float32
    return {
        "wz": dense_init(generator, (d, n_heads, head_dim), dtype,
                         fan_in=d, **kw),
        "wo_gate": dense_init(generator, (d, n_heads, head_dim), dtype,
                              fan_in=d, **kw),
        "wi": dense_init(generator, (d, n_heads), f32, fan_in=d, **kw),
        "wf": dense_init(generator, (d, n_heads), f32, fan_in=d, **kw),
        "fb": full((n_heads,), 3.0, f32, **kw),
        "rz": dense_init(generator, (n_heads, head_dim, head_dim), dtype,
                         fan_in=head_dim, **kw),  # block-diag recurrence
        "wo": dense_init(generator, (n_heads, head_dim, d), dtype,
                         fan_in=n_heads * head_dim, **kw),
    }


def init_mlstm_state(batch, n_heads, head_dim, device=None):
    f32 = torch.float32
    return {"c": torch.zeros((batch, n_heads, head_dim, head_dim),
                             dtype=f32, device=device),
            "n": torch.zeros((batch, n_heads, head_dim), dtype=f32,
                             device=device),
            "m": torch.full((batch, n_heads), -1e9, dtype=f32,
                            device=device)}


def init_slstm_state(batch, n_heads, head_dim, device=None):
    f32 = torch.float32

    def z():
        return torch.zeros((batch, n_heads, head_dim), dtype=f32,
                           device=device)

    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, n_heads), -1e9, dtype=f32,
                            device=device)}


# ---------------------------------------------------------------------------
# mLSTM chunkwise (this math is the kernel's oracle)
# ---------------------------------------------------------------------------

def mlstm_chunk_body(q, k, v, li, lf, state):
    """One chunk. q/k/v: (B,L,H,hd); li/lf: (B,L,H) log gates;
    state: dict(c,n,m).  Returns (y (B,L,H,hd) f32, new_state)."""
    b, l, h, hd = q.shape
    c_prev, n_prev, m_prev = state["c"], state["n"], state["m"]

    bcum = torch.cumsum(lf, dim=1)                    # (B,L,H) inclusive
    btot = bcum[:, -1]                                # (B,H)
    # intra-chunk log weights: D_ts = bcum_t - bcum_s + li_s for s <= t
    dmat = bcum[:, :, None] - bcum[:, None] + li[:, None]   # (B,L,L,H)
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))
    dmat = torch.where(tri[None, :, :, None], dmat, -math.inf)

    # stabilizer: per position max of (inter, intra)
    m_inter = bcum + m_prev[:, None]                  # (B,L,H)
    m_intra = dmat.amax(dim=2)                        # (B,L,H)
    m_t = torch.maximum(m_inter, m_intra)

    w_inter = torch.exp(m_inter - m_t)                # (B,L,H)
    w_intra = torch.exp(dmat - m_t[:, :, None])       # (B,L,L,H)

    qf = q.float() / math.sqrt(hd)
    kf, vf = k.float(), v.float()

    scores = torch.einsum("blhd,bshd->blsh", qf, kf) * w_intra
    y_intra = torch.einsum("blsh,bshd->blhd", scores, vf)
    den_intra = scores.sum(dim=2)                     # (B,L,H)

    y_inter = torch.einsum("blhd,bhde->blhe", qf, c_prev) \
        * w_inter[..., None]
    den_inter = torch.einsum("blhd,bhd->blh", qf, n_prev) * w_inter

    den = torch.maximum(torch.abs(den_intra + den_inter), torch.exp(-m_t))
    y = (y_intra + y_inter) / den[..., None]

    # state update to end of chunk
    m_new = torch.maximum(btot + m_prev,
                          (btot[:, None] - bcum + li).amax(dim=1))  # (B,H)
    w_c = torch.exp(btot + m_prev - m_new)            # decay on C_prev
    w_k = torch.exp(btot[:, None] - bcum + li - m_new[:, None])  # (B,L,H)
    c_new = c_prev * w_c[:, :, None, None] \
        + torch.einsum("blh,blhd,blhe->bhde", w_k, kf, vf)
    n_new = n_prev * w_c[..., None] + torch.einsum("blh,blhd->bhd", w_k, kf)
    return y, {"c": c_new, "n": n_new, "m": m_new}


def _gates(params, x):
    xf = x.float()
    li = torch.einsum("bld,dh->blh", xf, params["wi"])
    lf = F.logsigmoid(torch.einsum("bld,dh->blh", xf, params["wf"])
                      + params["fb"])
    return li, lf


def _kernel_chunk(q, k, v, li, lf, state):
    """One chunk through `ops.mlstm_chunk` (the kernel layout is
    (B,H,L,...)); same contract as `mlstm_chunk_body` but y in q's
    dtype."""
    def to_bh(a):
        return a.transpose(1, 2).contiguous()

    y, c, n, m = ops.mlstm_chunk(
        to_bh(q), to_bh(k), to_bh(v), to_bh(li)[..., None],
        to_bh(lf)[..., None], state["c"], state["n"][:, :, None],
        state["m"][:, :, None, None], impl="kernel")
    return y.transpose(1, 2), {"c": c, "n": n[:, :, 0], "m": m[:, :, 0, 0]}


def mlstm_apply(params, x, chunk: int = 256, state=None,
                impl: Optional[str] = None) -> Tuple[torch.Tensor, dict]:
    """x: (B,S,d) -> (y (B,S,d), state).

    The reference's chunking: max(1, S // chunk) equal chunks (S must
    divide into them).  `impl` routes each chunk like `ops.mlstm_chunk`:
    None runs the kernel on CUDA tensors and `mlstm_chunk_body` on CPU
    tensors, "kernel" insists on the kernel, "ref" forces the plain
    math."""
    b, s, d = x.shape
    h, hd = params["wq"].shape[1], params["wq"].shape[2]
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    li, lf = _gates(params, x)
    if state is None:
        state = init_mlstm_state(b, h, hd, device=x.device)

    n_chunks = max(1, s // chunk)
    cl = s // n_chunks
    if n_chunks * cl != s:
        raise ValueError(f"mlstm_apply: sequence length {s} does not split "
                         f"into {n_chunks} equal chunks (chunk={chunk})")
    body = _kernel_chunk if ops.route(x, impl) == "kernel" \
        else mlstm_chunk_body
    ys = []
    for i in range(n_chunks):
        sl = slice(i * cl, (i + 1) * cl)
        y, state = body(q[:, sl], k[:, sl], v[:, sl], li[:, sl], lf[:, sl],
                        state)
        ys.append(y)
    y = torch.cat(ys, dim=1).to(x.dtype)
    return torch.einsum("bshk,hkd->bsd", y, params["wo"]), state


def mlstm_decode(params, x, state) -> Tuple[torch.Tensor, dict]:
    """O(1) recurrent step; x: (B,1,d)."""
    hd = params["wq"].shape[2]
    x0 = x[:, 0]
    q = torch.einsum("bd,dhk->bhk", x0, params["wq"])
    k = torch.einsum("bd,dhk->bhk", x0, params["wk"])
    v = torch.einsum("bd,dhk->bhk", x0, params["wv"])
    li, lf = _gates(params, x)
    li, lf = li[:, 0], lf[:, 0]                        # (B,H)

    m_new = torch.maximum(lf + state["m"], li)
    wf = torch.exp(lf + state["m"] - m_new)[..., None]
    wi = torch.exp(li - m_new)[..., None]
    kf, vf = k.float(), v.float()
    c = state["c"] * wf[..., None] \
        + (wi[..., None] * kf[..., None] * vf[:, :, None])
    n = state["n"] * wf + wi * kf
    qf = q.float() / math.sqrt(hd)
    num = torch.einsum("bhd,bhde->bhe", qf, c)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qf, n)),
                        torch.exp(-m_new))
    y = (num / den[..., None]).to(x.dtype)[:, None]    # (B,1,H,hd)
    out = torch.einsum("bshk,hkd->bsd", y, params["wo"])
    return out, {"c": c, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_step(params, st, zt, ot_gate, lit, lft):
    """One recurrence step. zt/ot_gate: (B,H,hd); lit/lft: (B,H)."""
    rz = torch.einsum("bhd,hde->bhe", st["h"].to(params["rz"].dtype),
                      params["rz"]).float()
    z = torch.tanh(zt.float() + rz)
    m_new = torch.maximum(lft + st["m"], lit)
    wf = torch.exp(lft + st["m"] - m_new)[..., None]
    wi = torch.exp(lit - m_new)[..., None]
    c = wf * st["c"] + wi * z
    n = wf * st["n"] + wi
    h = torch.sigmoid(ot_gate.float()) * c / torch.clamp(n, min=1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_inputs(params, x):
    z = torch.einsum("bsd,dhk->bshk", x, params["wz"])
    og = torch.einsum("bsd,dhk->bshk", x, params["wo_gate"])
    xf = x.float()
    li = torch.einsum("bsd,dh->bsh", xf, params["wi"])
    lf = F.logsigmoid(torch.einsum("bsd,dh->bsh", xf, params["wf"])
                      + params["fb"])
    return z, og, li, lf


def slstm_apply(params, x, state=None) -> Tuple[torch.Tensor, dict]:
    b = x.shape[0]
    h_heads, hd = params["wz"].shape[1], params["wz"].shape[2]
    z, og, li, lf = _slstm_inputs(params, x)
    if state is None:
        state = init_slstm_state(b, h_heads, hd, device=x.device)
    hs = []
    for t in range(x.shape[1]):
        state = _slstm_step(params, state, z[:, t], og[:, t], li[:, t],
                            lf[:, t])
        hs.append(state["h"])
    y = torch.stack(hs, dim=1).to(x.dtype)             # (B,S,H,hd)
    return torch.einsum("bshk,hkd->bsd", y, params["wo"]), state


def slstm_decode(params, x, state) -> Tuple[torch.Tensor, dict]:
    z, og, li, lf = _slstm_inputs(params, x)
    state = _slstm_step(params, state, z[:, 0], og[:, 0], li[:, 0],
                        lf[:, 0])
    y = state["h"].to(x.dtype)[:, None]
    return torch.einsum("bshk,hkd->bsd", y, params["wo"]), state
