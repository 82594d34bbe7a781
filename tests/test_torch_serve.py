"""The port's LLM serving path (`repro_torch.models`, `launch.serve`)
against the reference, on the CPU.

Inputs are numpy arrays (or the reference's own `init_params`) handed to
both packages.  Modules are held to the reference at 1e-5 in f32; the
slice as a whole (reduced llama3-8b, gemma3-12b, xlstm-125m,
jamba-v0.1-52b, mixtral-8x22b, kimi-k2-1t-a32b and whisper-large-v3,
f32) at the reference's 2e-4 for prefill logits and caches
(tests/test_attention_impl.py), with greedy tokens equal.  The card's kernel route is covered by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import serve as jax_serve
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tfm
from repro.models import xlstm as jax_xlstm
from repro_torch import convert
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.data.synthetic import make_token_stream
from repro_torch.kernels import cut_eval as kern
from repro_torch.launch import serve as serve_lib
from repro_torch.models import attention, layers, transformer as tfm, xlstm

F32 = dict(rtol=1e-5, atol=1e-5)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch's CPU ops on one thread: the suite runs files in parallel
    processes, and on several threads an elementwise op splits a tensor
    at bounds that depend on its size, so an element may take the
    vectorised or the scalar exp (`f32_logits`' expert groups would
    differ from the whole block in the last bit)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(tree):
    return convert.to_torch(tree, "cpu")


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, tol=F32, msg=""):
    np.testing.assert_allclose(convert.to_numpy(got),
                               np.asarray(want, np.float32), err_msg=msg,
                               **tol)


def _close_tree(got, want, tol=F32):
    gl, wl = jax.tree.leaves(convert.to_numpy(got)), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), **tol)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_rms_norm_rope_glu_mlp():
    rng = _rng(0)
    x = _normal(rng, 2, 7, 3, 16)
    scale = _normal(rng, 16, scale=0.1)
    _close(layers.rms_norm(_t(x), _t(scale)),
           jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    pos = np.arange(7, dtype=np.int32)[None].repeat(2, 0) + 5
    _close(layers.apply_rope(_t(x), _t(pos), 10_000.0),
           jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))
    mlp = {k: _normal(rng, *shape, scale=0.2) for k, shape in
           (("wi", (16, 24)), ("wg", (16, 24)), ("wo", (24, 16)))}
    h = _normal(rng, 2, 7, 16)
    for act in ("silu", "gelu"):
        _close(layers.glu_mlp_apply(_t(mlp), _t(h), act),
               jax_layers.glu_mlp_apply(_j(mlp), jnp.asarray(h), act))


def _attn_params(rng, d, h, hkv, hd, qk_norm=False):
    p = {"wq": _normal(rng, d, h, hd, scale=d ** -0.5),
         "wk": _normal(rng, d, hkv, hd, scale=d ** -0.5),
         "wv": _normal(rng, d, hkv, hd, scale=d ** -0.5),
         "wo": _normal(rng, h, hd, d, scale=(h * hd) ** -0.5)}
    if qk_norm:
        p["q_norm"] = _normal(rng, hd, scale=0.1)
        p["k_norm"] = _normal(rng, hd, scale=0.1)
    return p


@pytest.mark.parametrize("impl,window,qk_norm", [
    ("naive", 0, False), ("naive", 5, True), ("chunked", 0, False),
    ("chunked", 5, False)])
def test_self_attention(impl, window, qk_norm):
    rng = _rng(1)
    b, s, d, h, hkv, hd = 2, 19, 32, 4, 2, 8
    p = _attn_params(rng, d, h, hkv, hd, qk_norm)
    x = _normal(rng, b, s, d)
    pos = np.arange(s, dtype=np.int32)[None].repeat(b, 0)
    kw = dict(n_kv_heads=hkv, rope_theta=10_000.0, window=window,
              qk_norm=qk_norm, impl=impl, block_q=8, block_k=8)
    out, (k, v) = attention.self_attention(_t(p), _t(x), _t(pos), **kw)
    w_out, (w_k, w_v) = jax_attn.self_attention(_j(p), jnp.asarray(x),
                                                jnp.asarray(pos), **kw)
    _close(out, w_out)
    _close(k, w_k)
    _close(v, w_v)


def test_decode_attention_past_the_ring_wrap():
    """seed_kv_cache with a prompt longer than the ring, then decode steps
    past the wrap: outputs and caches (k, v, pos) match."""
    rng = _rng(2)
    b, d, h, hkv, hd, cap, s = 2, 32, 4, 2, 8, 8, 11
    p = _attn_params(rng, d, h, hkv, hd)
    k = _normal(rng, b, s, hkv, hd)
    v = _normal(rng, b, s, hkv, hd)
    pos = np.arange(s, dtype=np.int32)[None].repeat(b, 0)
    cache = attention.seed_kv_cache(
        attention.init_kv_cache(b, hkv, hd, cap, torch.float32),
        _t(k), _t(v), _t(pos))
    jcache = jax_attn.seed_kv_cache(
        jax_attn.init_kv_cache(b, hkv, hd, cap, jnp.float32),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    _close_tree(cache, jcache, dict(rtol=0, atol=0))
    for step in range(6):
        x = _normal(rng, b, 1, d)
        cur = np.full((b,), s + step, np.int32)
        out, cache = attention.decode_attention(
            _t(p), _t(x), cache, _t(cur), rope_theta=10_000.0, window=cap)
        jout, jcache = jax_attn.decode_attention(
            _j(p), jnp.asarray(x), jcache, jnp.asarray(cur),
            rope_theta=10_000.0, window=cap)
        _close(out, jout, msg=f"step {step}")
        _close_tree(cache, jcache)


def _xlstm_params(rng, d, h, hd, kind):
    if kind == "mlstm":
        keys = {"wq": (d, h, hd), "wk": (d, h, hd), "wv": (d, h, hd)}
    else:
        keys = {"wz": (d, h, hd), "wo_gate": (d, h, hd),
                "rz": (h, hd, hd)}
    # the reference's init scales: 1/sqrt(fan_in), fan_in = d for the
    # projections and hd for the recurrent weights
    p = {k: _normal(rng, *shape, scale=(hd if k == "rz" else d) ** -0.5)
         for k, shape in keys.items()}
    p["wi"] = _normal(rng, d, h, scale=d ** -0.5)
    p["wf"] = _normal(rng, d, h, scale=d ** -0.5)
    p["fb"] = np.full((h,), 3.0, np.float32)
    p["wo"] = _normal(rng, h, hd, d, scale=(h * hd) ** -0.5)
    return p


@pytest.mark.parametrize("s,chunk", [(12, 16), (32, 8), (30, 8), (31, 8)])
def test_mlstm_apply_and_decode(s, chunk):
    """The reference's chunking (one chunk of 12; four of 8; three of 10;
    31 tokens do not split into three equal chunks), then two decode
    steps."""
    rng = _rng(3)
    b, d, h, hd = 2, 24, 2, 8
    p = _xlstm_params(rng, d, h, hd, "mlstm")
    x = _normal(rng, b, s, d)
    if s % max(1, s // chunk):
        with pytest.raises(ValueError, match="equal chunks"):
            xlstm.mlstm_apply(_t(p), _t(x), chunk=chunk)
        with pytest.raises(TypeError):
            jax_xlstm.mlstm_apply(_j(p), jnp.asarray(x), chunk=chunk)
        return
    y, st = xlstm.mlstm_apply(_t(p), _t(x), chunk=chunk)
    jy, jst = jax_xlstm.mlstm_apply(_j(p), jnp.asarray(x), chunk=chunk)
    _close(y, jy)
    _close_tree(st, jst)
    for _ in range(2):
        xt = _normal(rng, b, 1, d)
        y, st = xlstm.mlstm_decode(_t(p), _t(xt), st)
        jy, jst = jax_xlstm.mlstm_decode(_j(p), jnp.asarray(xt), jst)
        _close(y, jy)
        _close_tree(st, jst)


def test_slstm_apply_and_decode():
    rng = _rng(4)
    b, s, d, h, hd = 2, 9, 24, 2, 8
    p = _xlstm_params(rng, d, h, hd, "slstm")
    x = _normal(rng, b, s, d)
    y, st = xlstm.slstm_apply(_t(p), _t(x))
    jy, jst = jax_xlstm.slstm_apply(_j(p), jnp.asarray(x))
    _close(y, jy)
    _close_tree(st, jst)
    xt = _normal(rng, b, 1, d)
    y, st = xlstm.slstm_decode(_t(p), _t(xt), st)
    jy, jst = jax_xlstm.slstm_decode(_j(p), jnp.asarray(xt), jst)
    _close(y, jy)
    _close_tree(st, jst)


# ---------------------------------------------------------------------------
# the slice: reduced llama3-8b, gemma3-12b and xlstm-125m
# ---------------------------------------------------------------------------

SLICE = {"llama3-8b": dict(batch=2, prompt_len=12),
         "gemma3-12b": dict(batch=2, prompt_len=12),
         "xlstm-125m": dict(batch=2, prompt_len=32),   # two mLSTM chunks
         "jamba-v0.1-52b": dict(batch=2, prompt_len=32),   # two scan chunks
         "mixtral-8x22b": dict(batch=2, prompt_len=12),
         "kimi-k2-1t-a32b": dict(batch=2, prompt_len=12),
         "whisper-large-v3": dict(batch=2, prompt_len=12)}
# prefill logits and caches: attention models at the reference's 2e-4
# (tests/test_attention_impl.py); xLSTM at the reference's f32 mLSTM
# tolerance 6e-3 (tests/test_kernels.py), because its normalizer
# max(|den|, e^-m) amplifies f32 rounding: against a float64 evaluation
# the reference's own f32 logits are off by up to 3.0e-4 and the port's
# by up to 3.3e-4 on these prompts (ROADMAP Queue 3)
SLICE_TOL = {"llama3-8b": dict(rtol=2e-4, atol=2e-4),
             "gemma3-12b": dict(rtol=2e-4, atol=2e-4),
             "xlstm-125m": dict(rtol=6e-3, atol=6e-3),
             "jamba-v0.1-52b": dict(rtol=2e-4, atol=2e-4),
             "mixtral-8x22b": dict(rtol=2e-4, atol=2e-4),
             "kimi-k2-1t-a32b": dict(rtol=2e-4, atol=2e-4),
             "whisper-large-v3": dict(rtol=2e-4, atol=2e-4)}


@pytest.fixture(scope="module", params=sorted(SLICE))
def model(request):
    """(name, jax cfg, port cfg, jax params, port params), params from the
    reference's init_params(PRNGKey(0))."""
    name = request.param
    jcfg = jax_reduced(jax_get_config(name))
    cfg = reduced(get_config(name))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jax_tfm.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_reference(jparams, "cpu")
    return name, jcfg, cfg, jparams, params


def _prompts(cfg, name):
    kw = SLICE[name]
    return make_token_stream(cfg.vocab_size, kw["batch"], kw["prompt_len"],
                             seed=0)


def _frames(cfg, batch):
    """Frame embeddings (numpy, f32) for a frame-frontend arch, else
    None."""
    if cfg.frontend != "frames":
        return None
    return _normal(_rng(11), batch, cfg.encoder_seq, cfg.d_model)


def _tt(a):
    return None if a is None else torch.from_numpy(a)


def _jt(a):
    return None if a is None else jnp.asarray(a)


def test_prefill_and_greedy_decode_match_reference(model):
    name, jcfg, cfg, jparams, params = model
    toks = _prompts(cfg, name)
    _prefill_and_decode(jcfg, cfg, jparams, params, toks, SLICE_TOL[name],
                        frames=_frames(cfg, toks.shape[0]))


def _prefill_and_decode(jcfg, cfg, jparams, params, toks, tol, n_gen=8,
                        frames=None):
    """Prefill, then n_gen greedy tokens in both packages: logits and
    caches (after prefill and after every decode step) within `tol`, the
    tokens equal."""
    b, s = toks.shape
    with torch.inference_mode():
        logits, caches = tfm.prefill(cfg, params, torch.tensor(toks),
                                     _tt(frames), max_seq=s + n_gen + 1)
    jlogits, jcaches = jax.jit(lambda p, tk, fr: jax_tfm.prefill(
        jcfg, p, tk, fr, max_seq=s + n_gen + 1))(jparams, jnp.asarray(toks),
                                                 _jt(frames))
    _close(logits, jlogits, tol)
    _close_tree(caches, jcaches, tol)
    nxt = tfm.greedy_sample(logits)[:, None]
    jnxt = jax_tfm.greedy_sample(jlogits)[:, None]
    decode = jax.jit(lambda p, c, tk, pos: jax_tfm.decode_step(
        jcfg, p, c, tk, pos))
    got, want = [nxt], [np.asarray(jnxt)]
    for i in range(n_gen - 1):
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        pos = np.full((b,), s + i, np.int32)
        with torch.inference_mode():
            logits, caches = tfm.decode_step(cfg, params, caches, nxt,
                                             torch.tensor(pos))
        jlogits, jcaches = decode(jparams, jcaches, jnxt, jnp.asarray(pos))
        _close(logits, jlogits, tol)
        _close_tree(caches, jcaches, tol)
        nxt = tfm.greedy_sample(logits)[:, None]
        jnxt = jax_tfm.greedy_sample(jlogits)[:, None]
        got.append(nxt)
        want.append(np.asarray(jnxt))
    np.testing.assert_array_equal(torch.cat(got, 1).numpy(),
                                  np.concatenate(want, 1))


def _narrowed(cfg, d_head, window):
    """cfg with head dim `d_head` and every windowed layer's window
    `window` (either package's config classes)."""
    stages = tuple(dataclasses.replace(st, pattern=tuple(
        dataclasses.replace(blk, window=window) if blk.window else blk
        for blk in st.pattern)) for st in cfg.stages)
    return dataclasses.replace(cfg, d_head=d_head, stages=stages).validate()


def test_gemma_hd256_past_the_window_matches_reference():
    """Reduced Gemma 3 at its own head dim 256 with local windows of 8:
    24-token prompts, so the window binds in prefill and the local
    layers' decode rings (capacity 8) hold only the prompt's last 8
    tokens and wrap from the first step; prefill and 8 greedy steps."""
    jcfg = _narrowed(jax_reduced(jax_get_config("gemma3-12b")), 256, 8)
    cfg = _narrowed(reduced(get_config("gemma3-12b")), 256, 8)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.head_dim == 256
    assert sorted({blk.window for blk in cfg.all_layers()}) == [0, 8]
    jparams = jax_tfm.init_params(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_reference(jparams, "cpu")
    toks = make_token_stream(cfg.vocab_size, 2, 24, seed=0)
    _prefill_and_decode(jcfg, cfg, jparams, params, toks,
                        SLICE_TOL["gemma3-12b"])


def test_serve_matches_reference_serve(model):
    """`serve` on the reference's weights (and, for Whisper, the
    reference's frames from PRNGKey(seed + 1)) gives the reference's
    tokens."""
    name, jcfg, cfg, _, params = model
    kw = dict(SLICE[name], gen=4, seed=0)
    frames = None
    if cfg.frontend == "frames":
        frames = convert.to_torch(jax.random.normal(
            jax.random.PRNGKey(1), (kw["batch"], cfg.encoder_seq,
                                    cfg.d_model)).astype(jnp.bfloat16),
            "cpu")
    res = serve_lib.serve(cfg, params=params, device="cpu", frames=frames,
                          **kw)
    want = jax_serve.serve(jcfg, **kw)
    np.testing.assert_array_equal(res["generated"], want["generated"])
    assert res["generated"].shape == (kw["batch"], kw["gen"])
    assert res["prefill_s"] > 0 and res["tok_per_s"] > 0


def test_cpu_routes(model):
    """impl="kernel" on CPU tensors raises; impl="ref" is the CPU route;
    no kernel is launched."""
    name, _, cfg, _, params = model
    toks = torch.tensor(_prompts(cfg, name))
    frames = _tt(_frames(cfg, toks.shape[0]))
    kern.reset_launches()
    with torch.inference_mode():
        with pytest.raises(ValueError, match="impl='kernel' needs CUDA"):
            tfm.prefill(cfg, params, toks, frames, impl="kernel")
        a, _ = tfm.prefill(cfg, params, toks, frames)
        b, _ = tfm.prefill(cfg, params, toks, frames, impl="ref")
    assert torch.equal(a, b)
    assert sum(kern.LAUNCHES.values()) == 0


@pytest.mark.parametrize("name", sorted(SLICE))
def test_chip_smoke_f32_logits_is_the_f32_prefill(name):
    """chip_smoke.py's yardstick for the bf16 gates, `f32_logits` (one
    block's weights widened to f32 at a time, and an MoE block's experts
    a few at a time: here one by one, as Kimi K2's 384 experts are on
    the card), is bitwise the plain route's prefill of the whole tree
    widened to f32."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    from repro_torch.utils.tree import tree_map
    cfg = dataclasses.replace(reduced(get_config(name)), dtype="bfloat16")
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.tensor(_prompts(cfg, name))
    frames = serve_lib.draw_frames(cfg, toks.shape[0], 0, "cpu")
    per_expert = 3 * cfg.d_model * cfg.d_ff * 4
    got = chip_smoke.f32_logits(cfg, params, toks, frames,
                                widen_bytes=per_expert)
    with torch.inference_mode():
        want = tfm.prefill(dataclasses.replace(cfg, dtype="float32"),
                           tree_map(lambda a: a.float(), params), toks,
                           frames, impl="ref")[0]
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# conversion, init, entry point
# ---------------------------------------------------------------------------

def test_bf16_round_trip_through_convert():
    """The reference's bf16 parameter tree crosses unchanged: same keys,
    shapes and values (bf16 widened to f32 on the way back)."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("llama3-8b")),
                               dtype="bfloat16")
    jparams = jax_tfm.init_params(jcfg, jax.random.PRNGKey(1))
    params = convert.params_from_reference(jparams, "cpu")
    assert params["embed"].dtype == torch.bfloat16
    assert params["stages"][0]["pos0"]["attn"]["wq"].shape \
        == jparams["stages"][0]["pos0"]["attn"]["wq"].shape
    back = convert.params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_init_params_tree_matches_reference(name):
    """init_params draws the reference's tree for every arch: keys,
    shapes and dtypes."""
    cfg = reduced(get_config(name))
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    jshapes = jax.eval_shape(
        lambda k: jax_tfm.init_params(jax_reduced(jax_get_config(name)), k),
        jax.random.PRNGKey(0))
    got = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)),
                       convert.to_numpy(params))
    want = jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), jshapes)
    assert got == want
    assert float(params["stages"][0]["pos0"]["norm1"].abs().max()) == 0.0


def test_serve_cli_on_cpu(capsys):
    rc = serve_lib.main(["decode", "--arch", "xlstm-125m", "--reduced",
                         "--device", "cpu", "--batch", "1",
                         "--prompt-len", "16", "--gen", "3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "serving xlstm-125m-reduced on cpu" in out
    assert "first generations" in out


def test_serve_without_a_card_needs_an_explicit_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = reduced(get_config("llama3-8b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_lib.serve(cfg, 1, 4, 2)


def test_serve_runs_with_jax_unimportable():
    """The serving path imports nothing of jax or the reference: the CLI
    runs with both made unimportable."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "from repro_torch.launch.serve import main\n"
            "sys.exit(main(['decode', '--arch', 'llama3-8b', '--reduced',\n"
            "               '--device', 'cpu', '--batch', '1',\n"
            "               '--prompt-len', '8', '--gen', '2']))\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "first generations" in out.stdout


# ---------------------------------------------------------------------------
# serve fed: the async federation runtime
# ---------------------------------------------------------------------------

def _fed_records(out):
    import json
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_serve_fed_inproc_on_cpu_with_status_and_resume(capsys, tmp_path):
    ckpt = str(tmp_path / "fed")
    base = ["fed", "--device", "cpu", "--workers", "3", "--iters", "20",
            "--metrics-every", "5", "--ckpt-dir", ckpt, "--ckpt-every",
            "10", "--death-timeout", "20"]
    assert serve_lib.main(base + ["--status-port", "0",
                                  "--adapt-arrivals"]) == 0
    out = capsys.readouterr().out
    assert "status endpoint: http://127.0.0.1:" in out
    assert "(decreasing)" in out and "tau bound ok" in out
    recs = _fed_records(out)
    assert [r["t"] for r in recs] == [5, 10, 15, 20]
    # resumed from the step-20 checkpoint for 10 more iterations
    assert serve_lib.main(base + ["--iters", "30", "--resume"]) == 0
    recs = _fed_records(capsys.readouterr().out)
    assert [r["t"] for r in recs] == [5, 10, 15, 20, 25, 30]


def test_serve_fed_tcp_streamed_on_cpu(capsys):
    """`serve fed --transport tcp --stream` on the CPU: worker
    subprocesses rebuild the problem and the stream by name, and the run
    exits 0 only through the streamed replay gate."""
    rc = serve_lib.main(["fed", "--transport", "tcp", "--stream",
                         "--device", "cpu", "--workers", "2", "--iters",
                         "10", "--metrics-every", "5", "--accept-timeout",
                         "90", "--death-timeout", "20"])
    out = capsys.readouterr().out
    assert rc == 0, out[-2000:]
    assert "master listening on 127.0.0.1:" in out
    assert "streamed replay gate: max gap rel err" in out and "(ok)" in out
    assert len(_fed_records(out)) == 2


def test_serve_fed_without_a_card_needs_an_explicit_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_lib.main(["fed", "--iters", "2"])
