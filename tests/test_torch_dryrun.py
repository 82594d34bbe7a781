"""The dry-run on the meta device (`repro_torch.launch.dryrun`,
`roofline`, `profile`) on cases that can be checked by hand.

* `roofline.Counter`: peak and live bytes of a chain of ops of known
  sizes, the bytes they move, a product's FLOPs.
* Reduced llama's prefill on a 1 x 1 mesh counts exactly the FLOPs of its
  products, on the kernel route (the flash kernel's own count of the
  causal pairs) and on the naive route (every S x T score).
* On a mesh whose axes divide every sharded dimension, flops_per_dev x
  chips is the unsharded trace's; on (2, 16) reduced xLSTM's replicated
  heads are split by the data axis alone, its vocab-sharded tied head by
  both.
* The meta kernel route builds nothing (`build.load` raises), counts
  `chip_smoke.flash_work` / `mlstm_work`, and holds no S x T scores.
* `run_one` gives the reference's keys (renamed) for all six step kinds
  and honours `DRYRUN_SKIPS`; `analytic_flops` is the reference's for
  every arch x shape; `profile` prints its three sections; `Registry`
  raises the reference's errors.
"""
import contextlib
import io
import json
import os
import sys
from pathlib import Path

import pytest
import torch

from repro import configs as jconfigs
from repro.launch import roofline as jrl
from repro.utils.registry import Registry as JRegistry

# the reference's dry-run module sets XLA_FLAGS for its own command line
# (512 fake devices) when imported; keep this process's setting
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdr  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES,  # noqa: E402
                                 get_config, reduced)
from repro_torch.configs.shapes import InputShape  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import profile  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.utils.registry import Registry  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
META = torch.device("meta")


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def test_counter_chain_of_known_sizes():
    x = _m(1000)
    with rl.Counter((x,)) as c:
        y = x * 2                    # +4000
        z = y + 1                    # +4000 -> 8000 live
        del y                        # 4000
        w = z.view(10, 100)          # a view: nothing allocated or moved
        u = torch.cat([z, z])        # +8000 -> 12000, the peak
        del z, w                     # 8000
        a, b = _m(4, 8), _m(8, 16)   # +128, +512: allocated, not moved
        p = a @ b                    # +256 -> 8896
    assert c.peak == 12000
    assert c.live == 8000 + 128 + 512 + 256
    assert c.flops == 2 * 4 * 8 * 16
    # x*2: 4000 read + 4000 written; y+1 the same; cat 8000 + 8000; the
    # product reads 640 and writes 256
    assert c.bytes == 8000 + 8000 + 16000 + 640 + 256
    assert c.hist["cat"] == 1 and c.hist["view"] == 1
    assert c.largest()[0][:3] == (8000, "cat", (2000,))
    del u, p


def _hand_prefill_flops(cfg, b, s, kernel):
    d, h, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    proj = 2 * b * s * d * (h + 2 * hkv) * hd + 2 * b * s * h * hd * d
    pairs = s * (s + 1) // 2 if kernel else s * s
    attn = 4 * hd * pairs * b * h
    mlp = 3 * 2 * b * s * d * f
    return cfg.n_layers * (proj + attn + mlp) + 2 * b * s * d * \
        cfg.vocab_size


@pytest.mark.parametrize("route", ["kernel", "ref"])
def test_reduced_llama_prefill_counts_its_products(route):
    cfg = reduced(get_config("llama3-8b"))
    row = dr.run_one(cfg, InputShape("p", 64, 2, "prefill"),
                     make_debug_mesh(1, 1), route=route, verbose=False)
    assert row["flops_per_dev"] == _hand_prefill_flops(cfg, 2, 64,
                                                       route == "kernel")
    assert row["chips"] == 1 and row["coll_bytes"]["count"] == 0


@pytest.mark.parametrize("step,kind", [("prefill", "prefill"),
                                       ("decode", "decode"),
                                       ("plain_train", "train")])
def test_flops_split_exactly_where_the_axes_divide(step, kind):
    """(The fed steps also run the master's replicated math, which no
    axis splits.)"""
    cfg = reduced(get_config("llama3-8b"))
    shape = InputShape("s", 32, 4, kind)
    one = dr.run_one(cfg, shape, make_debug_mesh(1, 1), step=step,
                     verbose=False)
    four = dr.run_one(cfg, shape, make_debug_mesh(2, 2), step=step,
                      verbose=False)
    assert one["flops_per_dev"] > 0
    assert four["flops_per_dev"] * 4 == one["flops_per_dev"]
    assert four["arg_bytes"] < one["arg_bytes"]


def test_replicated_heads_split_by_the_data_axis_alone():
    cfg = reduced(get_config("xlstm-125m"))
    shape = InputShape("p", 64, 4, "prefill")
    full = dr.run_one(cfg, shape, make_debug_mesh(1, 1), verbose=False)
    split = dr.run_one(cfg, shape, make_debug_mesh(2, 16), verbose=False)
    assert cfg.n_heads % 16 and cfg.vocab_size % 16 == 0
    head = 2 * 4 * 64 * cfg.d_model * cfg.vocab_size
    assert split["flops_per_dev"] == (full["flops_per_dev"] - head) / 2 \
        + head / 32


def test_meta_kernel_route_counts_the_kernels_work(monkeypatch):
    cs = _chip_smoke()

    def no_build():
        raise AssertionError("a meta tensor built the kernels")

    monkeypatch.setattr(build, "load", no_build)
    for shape in ((2, 96, 96, 8, 2, 128, 0), (1, 80, 80, 4, 4, 64, 32)):
        b, s, t, h, hkv, hd, window = shape
        with rl.Counter() as c:
            out = ops.flash_attention(
                _m(b, s, h, hd, dtype=torch.bfloat16),
                _m(b, t, hkv, hd, dtype=torch.bfloat16),
                _m(b, t, hkv, hd, dtype=torch.bfloat16), causal=True,
                window=window, impl="kernel")
        nbytes, secs = cs.flash_work(shape, torch.bfloat16)
        assert c.flops == pytest.approx(
            secs * cs.flop_rate(torch.bfloat16), rel=1e-12)
        assert c.hist["flash_attention"] == 1 and out.is_meta
        assert c.bytes == nbytes
    mshape = (2, 4, 64, 64)
    with rl.Counter() as c:
        b, h, l, hd = mshape
        ops.mlstm_chunk(_m(b, h, l, hd), _m(b, h, l, hd), _m(b, h, l, hd),
                        _m(b, h, l, 1), _m(b, h, l, 1), _m(b, h, hd, hd),
                        _m(b, h, 1, hd), _m(b, h, 1, 1), impl="kernel")
    nbytes, _ = cs.mlstm_work(mshape, torch.float32)
    assert c.bytes == nbytes and c.hist["mlstm_chunk_f32"] == 1
    bh = b * h
    assert c.flops == bh * (4 * hd * l * (l + 1) // 2 + 4 * l * hd * hd
                            + 4 * l * hd)
    # the kernel route holds no (S, T) scores: where they are the largest
    # tensor, its temp is at least one layer's f32 scores below the naive
    # route's
    cfg = reduced(get_config("llama3-8b"))
    shape = InputShape("p", 1024, 2, "prefill")
    temps = {r: dr.run_one(cfg, shape, make_debug_mesh(1, 1), route=r,
                           verbose=False)["temp_bytes"]
             for r in ("kernel", "ref")}
    assert temps["ref"] - temps["kernel"] >= \
        2 * cfg.n_heads * 1024 * 1024 * 4


def _reference_keys():
    report = jrl.RooflineReport(
        arch="a", shape="s", mesh="m", chips=1, step_kind="k",
        hlo_flops_per_dev=1.0, hlo_bytes_per_dev=1.0, arg_bytes=1.0,
        temp_bytes=1.0, out_bytes=1.0, coll_bytes={"count": 0},
        analytic_flops_total=1.0, model_flops_total=1.0)
    keys = set(report.to_json()) | {"status", "lower_s", "compile_s",
                                    "layer_mode", "cut_mode", "attn_impl",
                                    "kv_seq_shard", "tag"}
    rename = {"hlo_flops_per_dev": "flops_per_dev",
              "hlo_bytes_per_dev": "bytes_per_dev", "lower_s": "trace_s",
              "compile_s": "trace_s", "layer_mode": "route"}
    return {rename.get(k, k) for k in keys} | {"remat"}


def test_run_one_gives_the_reference_keys_for_every_step_kind():
    cfg = reduced(get_config("mixtral-8x22b"))
    want = _reference_keys()
    mesh = make_debug_mesh(2, 4)
    for step in dr.STEP_KINDS:
        kind = {"prefill": "prefill", "decode": "decode"}.get(step, "train")
        row = dr.run_one(cfg, InputShape(f"{kind}_small", 32, 4, kind),
                         mesh, step=step, cut_mode="sketch", sketch_r=64,
                         scan_chunk=2, verbose=False)
        assert set(row) == want, step
        assert row["status"] == "ok" and row["step_kind"] == step
        assert row["mesh"] == "2x4" and row["chips"] == 8
        assert row["temp_bytes"] > 0 and row["flops_per_dev"] > 0
        assert row["coll_bytes"]["all-gather"] > 0     # the MoE router
        json.dumps(row)
    skip = dr.run_one("whisper-large-v3", "long_500k", "pod", verbose=False)
    assert skip["status"] == "skipped"
    assert skip["reason"] == jconfigs.DRYRUN_SKIPS[("whisper-large-v3",
                                                    "long_500k")]


def test_analytic_flops_are_the_reference_counts():
    for arch in ASSIGNED_ARCHS:
        for name, shape in INPUT_SHAPES.items():
            step = dr.default_step_kind(shape)
            assert dr.analytic_flops(get_config(arch), shape, step) == \
                jdr.analytic_flops(jconfigs.get_config(arch),
                                   jconfigs.get_shape(name), step)


def test_profile_and_dryrun_command_lines():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        profile.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                      "--mesh", "pod", "--top", "3"])
    text = out.getvalue()
    for head in ("== op histogram", "== collectives (schedule order) ==",
                 "== top-3 largest tensors =="):
        assert head in text
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        dr.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                 "--mesh", "multipod"])
    assert e.value.code == 0
    row = json.loads(out.getvalue().strip().splitlines()[-1])
    assert row["status"] == "ok" and row["chips"] == 512


def test_registry_errors_match_the_reference():
    msgs = []
    for cls in (Registry, JRegistry):
        r = cls("model")
        r.register("b")(len)
        r.register("a")(len)
        got = []
        for fn in (lambda: r.register("a")(len), lambda: r.get("c")):
            with pytest.raises(KeyError) as e:
                fn()
            got.append(str(e.value))
        msgs.append((got, list(r.names()), "a" in r, r.get("b") is len))
    assert msgs[0] == msgs[1]
