"""The batching (`vmap`) and forward-mode (`jvp`) rules of the port's cut
Functions (`kernels.cut_ad` MV / VM / OUTER) and of `ops.FusedRound`,
the batched wrappers' plain versions, and the fused round's launch plan
for R runs, on the CPU.

The Functions are called directly, so on the CPU their forward runs the
wrappers' plain versions while every rule runs as it does on the card.
They are held to the reference's `jax.vmap` / `jax.jvp` of
`ops.cut_eval` and `ops.fused_cut_round` (impl="ref") at the reference's
tolerances, 1e-4/1e-5 (tests/test_kernels.py:58,107,162;
grad-of-grad 1e-4/1e-4).  A spy on the wrappers checks that a vmapped
call reaches each wrapper once with a leading run axis (one batched
launch on the card) and that an unbatched operand arrives at run stride
0 (not copied).  functorch's per-run fallback warning is an error here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, jvp, vmap

from repro.kernels import ops as jax_ops
from repro_torch.kernels import cut_ad, inner_round, ops
from repro_torch.kernels import cut_eval as kern
from test_torch_round_plan import SMS, h100_occupancy

F32 = dict(rtol=1e-4, atol=1e-5)
GOG = dict(rtol=1e-4, atol=1e-4)
STEPS = dict(eta_z=0.05, eta_s=0.1, eta_dual=0.07, rho2=0.5)
ROUND_IN = ("a", "v", "g_other", "mask", "c", "active", "s", "gamma")

pytestmark = pytest.mark.filterwarnings("error:There is a performance drop")


@pytest.fixture(autouse=True)
def fallback_warns():
    """functorch warns when an op has no batching rule and it loops over
    the runs instead; the mark above makes that warning an error."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    yield
    torch._C._functorch._set_vmap_fallback_warning_enabled(False)


@pytest.fixture
def calls(monkeypatch):
    """(wrapper, operand shapes, run strides) of every wrapper call."""
    seen = []
    for name in ("matvec", "vecmat", "rank1"):
        inner = getattr(kern, name)

        def spy(x, y, name=name, inner=inner):
            seen.append((name, (tuple(x.shape), tuple(y.shape)),
                         (x.stride(0), y.stride(0))))
            return inner(x, y)
        monkeypatch.setattr(kern, name, spy)
    return seen


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _np(x):
    return np.asarray(x, np.float32)


def _cut_port(c, act):
    return lambda a, v: (cut_ad.MV.apply(a, v) - c) * act


def _cut_ref(c, act):
    return lambda a, v: jax_ops.cut_eval(a, v, c, act, impl="ref")


def _batch(r, p, d, seed=0):
    rng = _rng(seed)
    a = (rng.normal(size=(r, p, d)) * d ** -0.5).astype(np.float32)
    v = rng.normal(size=(r, d)).astype(np.float32)
    c = rng.normal(size=(p,)).astype(np.float32)
    act = (rng.uniform(size=(p,)) > 0.3).astype(np.float32)
    return a, v, c, act


# ---------------------------------------------------------------------------
# the batched plain versions
# ---------------------------------------------------------------------------

def test_batched_plain_versions_are_the_per_run_ones():
    rng = _rng(1)
    a = _t(rng.normal(size=(3, 5, 40)))
    v, y = _t(rng.normal(size=(3, 40))), _t(rng.normal(size=(3, 40)))
    g = _t(rng.normal(size=(3, 5)))
    for got, one in ((kern.matvec(a, v), lambda r: kern.matvec(a[r], v[r])),
                     (kern.vecmat(g, a), lambda r: kern.vecmat(g[r], a[r])),
                     (kern.rank1(g, y), lambda r: kern.rank1(g[r], y[r]))):
        for r in range(3):
            assert torch.equal(got[r], one(r))


@pytest.mark.parametrize("call", [
    lambda a, v, g: kern.matvec(a, v[:2]),          # run counts differ
    lambda a, v, g: kern.matvec(a, v[0]),           # 3-D with a 1-D vector
    lambda a, v, g: kern.vecmat(g[:, :2], a),       # wrong row count
    lambda a, v, g: kern.rank1(g, v[0]),            # 2-D x with a 1-D y
    lambda a, v, g: kern.matvec(a.transpose(1, 2).contiguous()
                                .transpose(1, 2), v),   # not contiguous
])
def test_batched_wrappers_refuse_bad_operands(call):
    a, v = torch.zeros(3, 4, 10), torch.zeros(3, 10)
    with pytest.raises(ValueError):
        call(a, v, torch.zeros(3, 4))


# ---------------------------------------------------------------------------
# vmap
# ---------------------------------------------------------------------------

def test_cut_eval_vmap_batches_kernel(calls):
    """tests/test_kernels.py:58 on the port: one batched matvec call."""
    a, v, c, act = _batch(3, 4, 200, seed=4)
    want = jax.vmap(_cut_ref(jnp.asarray(c), jnp.asarray(act)))(
        jnp.asarray(a), jnp.asarray(v))
    got = vmap(_cut_port(_t(c), _t(act)))(_t(a), _t(v))
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    assert calls == [("matvec", ((3, 4, 200), (3, 200)), (800, 200))]


@pytest.mark.parametrize("name", ["MV", "VM", "OUTER"])
def test_each_function_vmaps_to_one_batched_call(calls, name):
    rng = _rng(5)
    r, p, d = 3, 4, 64
    a = rng.normal(size=(r, p, d)).astype(np.float32)
    g = rng.normal(size=(r, p)).astype(np.float32)
    y = rng.normal(size=(r, d)).astype(np.float32)
    fn, args, want = {
        "MV": (cut_ad.MV, (a, y), np.einsum("rpd,rd->rp", a, y)),
        "VM": (cut_ad.VM, (g, a), np.einsum("rp,rpd->rd", g, a)),
        "OUTER": (cut_ad.OUTER, (g, y), np.einsum("rp,rd->rpd", g, y)),
    }[name]
    got = vmap(fn.apply)(*(_t(x) for x in args))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert len(calls) == 1 and calls[0][1] == tuple(
        tuple(x.shape) for x in args)


def test_unbatched_operand_arrives_at_run_stride_zero(calls):
    """A matrix the runs share is broadcast, not copied."""
    a, v, c, act = _batch(3, 4, 128, seed=6)
    got = vmap(_cut_port(_t(c), _t(act)), in_dims=(None, 0))(_t(a[0]),
                                                             _t(v))
    want = jax.vmap(_cut_ref(jnp.asarray(c), jnp.asarray(act)),
                    in_axes=(None, 0))(jnp.asarray(a[0]), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    assert calls == [("matvec", ((3, 4, 128), (3, 128)), (0, 128))]


def test_vmap_over_a_later_dimension():
    """The run axis need not be first: the rule moves it."""
    a, v, c, act = _batch(3, 4, 96, seed=7)
    got = vmap(_cut_port(_t(c), _t(act)), in_dims=(2, 1))(
        _t(a).permute(1, 2, 0), _t(v).T)
    want = jax.vmap(_cut_ref(jnp.asarray(c), jnp.asarray(act)))(
        jnp.asarray(a), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_cut_eval_vmap_of_grad_sweep_axis(calls):
    """tests/test_kernels.py:162 on the port: vmap(grad) through
    MV and its backward (OUTER for da, VM for dv), each one batched
    call."""
    a, v, c, act = _batch(3, 4, 256, seed=11)
    c, act = np.zeros_like(c), np.ones_like(act)

    def loss_t(a, v):
        return 0.5 * torch.sum(_cut_port(_t(c), _t(act))(a, v) ** 2)

    def loss_j(a, v):
        return 0.5 * jnp.sum(_cut_ref(jnp.asarray(c),
                                      jnp.asarray(act))(a, v) ** 2)

    got = vmap(grad(loss_t, argnums=(0, 1)))(_t(a), _t(v))
    want = jax.vmap(jax.grad(loss_j, argnums=(0, 1)))(jnp.asarray(a),
                                                      jnp.asarray(v))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), _np(y), **F32)
    assert sorted(n for n, _, _ in calls) == ["matvec", "rank1", "vecmat"]
    assert all(shapes[0][0] == 3 for _, shapes, _ in calls)


def test_vmap_of_grad_of_grad():
    """tests/test_kernels.py:144's grad-of-grad, under vmap."""
    a, v, c, act = _batch(2, 5, 300, seed=12)
    w = _rng(13).normal(size=(5,)).astype(np.float32)

    def gog_t(a, v):
        def loss(v):
            return 0.5 * torch.sum(
                _cut_port(_t(c), _t(act))(a, v) ** 2 * _t(w))
        return grad(lambda v: torch.sum(grad(loss)(v) ** 2))(v)

    def gog_j(a, v):
        def loss(v):
            return 0.5 * jnp.sum(_cut_ref(jnp.asarray(c), jnp.asarray(act))(
                a, v) ** 2 * jnp.asarray(w))
        return jax.grad(lambda v: jnp.sum(jax.grad(loss)(v) ** 2))(v)

    got = vmap(gog_t)(_t(a), _t(v))
    want = jax.vmap(gog_j)(jnp.asarray(a), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), _np(want), **GOG)


# ---------------------------------------------------------------------------
# jvp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,d", [(5, 300), (8, 4096)])
def test_cut_eval_jvp_parity(p, d):
    """tests/test_kernels.py:107 on the port."""
    a, v, c, act = _batch(1, p, d, seed=9)
    a, v = a[0], v[0]
    rng = _rng(10)
    da = (rng.normal(size=a.shape) * d ** -0.5).astype(np.float32)
    dv = rng.normal(size=v.shape).astype(np.float32)
    yk, tk = jvp(_cut_port(_t(c), _t(act)), (_t(a), _t(v)),
                 (_t(da), _t(dv)))
    yr, tr = jax.jvp(_cut_ref(jnp.asarray(c), jnp.asarray(act)),
                     (jnp.asarray(a), jnp.asarray(v)),
                     (jnp.asarray(da), jnp.asarray(dv)))
    np.testing.assert_allclose(yk.numpy(), _np(yr), **F32)
    np.testing.assert_allclose(tk.numpy(), _np(tr), **F32)


@pytest.mark.parametrize("name", ["VM", "OUTER"])
def test_bilinear_jvp_rules(name):
    rng = _rng(14)
    p, d = 4, 50
    g, dg = (rng.normal(size=(p,)).astype(np.float32) for _ in range(2))
    a, da = (rng.normal(size=(p, d)).astype(np.float32) for _ in range(2))
    y, dy = (rng.normal(size=(d,)).astype(np.float32) for _ in range(2))
    if name == "VM":
        out, tan = jvp(cut_ad.VM.apply, (_t(g), _t(a)), (_t(dg), _t(da)))
        want = jax.jvp(lambda g, a: g @ a, (g, a), (dg, da))
    else:
        out, tan = jvp(cut_ad.OUTER.apply, (_t(g), _t(y)), (_t(dg), _t(dy)))
        want = jax.jvp(jnp.outer, (g, y), (dg, dy))
    np.testing.assert_allclose(out.numpy(), _np(want[0]), **F32)
    np.testing.assert_allclose(tan.numpy(), _np(want[1]), **F32)


def test_forward_over_reverse_through_mv():
    """jvp of a gradient (the Hessian-vector product of
    `core.weakly_convex.curvature_along`) through MV's backward."""
    a, v, c, act = _batch(1, 5, 300, seed=15)
    a, v = a[0], v[0]
    d = _rng(16).normal(size=v.shape).astype(np.float32)

    def loss_t(v):
        return torch.sum(_cut_port(_t(c), _t(act))(_t(a), v) ** 3)

    def loss_j(v):
        return jnp.sum(_cut_ref(jnp.asarray(c), jnp.asarray(act))(
            jnp.asarray(a), v) ** 3)

    got = jvp(grad(loss_t), (_t(v),), (_t(d),))[1]
    want = jax.jvp(jax.grad(loss_j), (jnp.asarray(v),), (jnp.asarray(d),))[1]
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


# ---------------------------------------------------------------------------
# FusedRound
# ---------------------------------------------------------------------------

def _round_operands(r, p, d, seed=0):
    rng = _rng(seed)
    o = {"a": rng.normal(size=(r, p, d)) * d ** -0.5,
         "v": rng.normal(size=(r, d)),
         "g_other": rng.normal(size=(r, d)) * 0.1,
         "mask": np.broadcast_to((rng.uniform(size=d) > 0.5), (r, d)),
         "c": rng.normal(size=(r, p)) * 0.5,
         "active": np.broadcast_to(rng.uniform(size=p) > 0.3, (r, p)),
         "s": np.abs(rng.normal(size=(r, p))) * 0.2,
         "gamma": np.abs(rng.normal(size=(r, p))) * 0.2}
    return {k: np.ascontiguousarray(v, np.float32) for k, v in o.items()}


def _round_port(*xs):
    return ops.FusedRound.apply(*xs, *STEPS.values())


def _round_ref(*xs):
    return jax_ops.fused_cut_round(*xs, **STEPS, impl="ref")


def test_fused_round_vmap_matches_reference(calls, monkeypatch):
    o = _round_operands(3, 5, 300, seed=20)
    seen = []
    inner = inner_round.fused_cut_round

    def spy(a, *rest, **kw):
        seen.append(tuple(a.shape))
        return inner(a, *rest, **kw)
    monkeypatch.setattr(inner_round, "fused_cut_round", spy)
    got = vmap(_round_port)(*(_t(o[k]) for k in ROUND_IN))
    want = jax.vmap(_round_ref)(*(jnp.asarray(o[k]) for k in ROUND_IN))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), _np(y), **F32)
    assert seen == [(3, 5, 300)] and calls == []


def test_fused_round_vmap_with_a_shared_matrix():
    o = _round_operands(2, 4, 200, seed=21)
    dims = (None,) + (0,) * 7
    got = vmap(_round_port, in_dims=dims)(
        _t(o["a"][0]), *(_t(o[k]) for k in ROUND_IN[1:]))
    want = jax.vmap(_round_ref, in_axes=dims)(
        jnp.asarray(o["a"][0]), *(jnp.asarray(o[k]) for k in ROUND_IN[1:]))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), _np(y), **F32)


def _round_loss(round_fn, lib):
    def loss(a, v, s, gamma, rest):
        outs = round_fn(a, v, rest[0], rest[1], rest[2], rest[3], s, gamma)
        return sum(lib.sum(t ** 2) for t in outs)
    return loss


def test_fused_round_vmap_of_grad_matches_reference():
    o = _round_operands(2, 5, 300, seed=22)
    wrt = ("a", "v", "s", "gamma")
    rest = ("g_other", "mask", "c", "active")
    got = vmap(grad(_round_loss(_round_port, torch), argnums=(0, 1, 2, 3)))(
        *(_t(o[k]) for k in wrt), tuple(_t(o[k]) for k in rest))
    want = jax.vmap(jax.grad(_round_loss(_round_ref, jnp),
                             argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(o[k]) for k in wrt),
        tuple(jnp.asarray(o[k]) for k in rest))
    for x, y, k in zip(got, want, wrt):
        np.testing.assert_allclose(x.numpy(), _np(y), **F32, err_msg=k)


def test_fused_round_jvp_matches_reference():
    o = {k: v[0] for k, v in _round_operands(1, 5, 300, seed=23).items()}
    t = {k: v[0] for k, v in _round_operands(1, 5, 300, seed=24).items()}
    for k in ("mask", "active"):
        t[k] = np.zeros_like(t[k])
    got = jvp(_round_port, tuple(_t(o[k]) for k in ROUND_IN),
              tuple(_t(t[k]) for k in ROUND_IN))
    want = jax.jvp(_round_ref, tuple(jnp.asarray(o[k]) for k in ROUND_IN),
                   tuple(jnp.asarray(t[k]) for k in ROUND_IN))
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_allclose(x.numpy(), _np(y), **F32)


def test_fused_round_refuses_batched_step_sizes():
    o = _round_operands(2, 3, 40, seed=25)

    def round_eta(eta_z, *xs):
        return ops.FusedRound.apply(*xs, eta_z, 0.1, 0.1, 0.5)
    with pytest.raises(ValueError, match="step sizes"):
        vmap(round_eta)(torch.tensor([0.1, 0.2]),
                        *(_t(o[k]) for k in ROUND_IN))


# ---------------------------------------------------------------------------
# the fused round's launch for R runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("runs,on_chip,blocks", [
    (1, True, 264), (2, True, 132), (4, False, 66)])
def test_round_plan_for_runs_at_white_wine(runs, on_chip, blocks):
    """One run's A is 7.76 MB at (8, 242,628) f32: two runs' fit the
    SMs' shared memory, four do not (streamed)."""
    plan = inner_round.round_plan(8, 242_628, 4, SMS, h100_occupancy, runs)
    assert (plan.on_chip, plan.blocks) == (on_chip, blocks)
    assert h100_occupancy(plan.on_chip, plan.smem) * SMS \
        >= plan.blocks * runs


def test_round_plan_refuses_runs_that_cannot_be_resident():
    with pytest.raises(ValueError, match="fits the card"):
        inner_round.round_plan(8, 242_628, 4, SMS, h100_occupancy, 1000)
    with pytest.raises(ValueError):
        inner_round.round_plan(8, 1000, 4, SMS, h100_occupancy, 0)
