"""The port's LLM sharding specs against the reference's, spec for spec.

`repro_torch.fed.sharding.param_specs` / `cache_specs` / `batch_spec` /
`data_axis` and `repro_torch.launch.dryrun.fed_state_specs` on meta
trees against the reference's on `jax.eval_shape` trees over a
`jax.sharding.AbstractMesh` (as tests/test_fed.py builds them): every
assigned arch at reduced size on the (2, 4), (4, 4), (2, 16) and (2, 16,
16) meshes, and llama3-8b, xlstm-125m and whisper-large-v3 at full size
on the pod mesh (the fallback cases: 8 KV heads, 4 heads and 20 heads
against a 16-way model axis).  The bytes one device holds under the
port's specs (`local_bytes`) equal, to the byte, the sum taken from the
reference's specs and shapes.  The reference's tables (`INPUT_SHAPES`,
`ASSIGNED_ARCHS`, `DRYRUN_SKIPS`) are the port's.
"""
import math
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro import configs as jconfigs
from repro.fed import sharding as jshd
from repro.fed.trilevel_llm import FedHyper as JHyper
from repro.fed.trilevel_llm import init_fed_state as j_init_fed_state
from repro.models import transformer as jtfm

# the reference's dry-run module sets XLA_FLAGS for its own command line
# (512 fake devices) when imported; keep this process's setting
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdr  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.fed import sharding as tshd  # noqa: E402
from repro_torch.fed.trilevel_llm import FedHyper, init_fed_state  # noqa: E402
from repro_torch.launch import dryrun as tdr  # noqa: E402
from repro_torch.launch.mesh import (AbstractMesh as TMesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.utils.tree import tree_flatten, tree_map  # noqa: E402

MESHES = (((2, 4), ("data", "model")), ((4, 4), ("data", "model")),
          ((2, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
META = torch.device("meta")


def _jmesh(sizes, names):
    return AbstractMesh(sizes, names)


def _jspecs(tree):
    return [tuple(p) for p in
            jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))]


def _jbytes(shapes, specs, sizes: dict) -> int:
    def shards(ax):
        axes = ax if isinstance(ax, tuple) else (ax,)
        return math.prod(sizes[a] for a in axes if a is not None)

    total = 0
    for x, sp in zip(jax.tree.leaves(shapes), _jspecs(specs)):
        sp = sp + (None,) * (len(x.shape) - len(sp))
        total += math.prod(n // shards(a) for n, a in zip(x.shape, sp)) \
            * np.dtype(x.dtype).itemsize
    return total


def _same(jshapes, jspecs, ttree, tspecs, tmesh):
    """Specs spec for spec over matching shapes, and the per-device
    bytes to the byte."""
    assert [tuple(x.shape) for x in jax.tree.leaves(jshapes)] == \
        [tuple(x.shape) for x in tree_flatten(ttree)[0]]
    assert _jspecs(jspecs) == tshd.spec_leaves(tspecs, ttree)
    assert tshd.local_bytes(ttree, tspecs, tmesh) == \
        _jbytes(jshapes, jspecs, tmesh.shape)


def _stacked(n, jp, tp):
    return (jax.tree.map(lambda x: jax.ShapeDtypeStruct((n,) + x.shape,
                                                        x.dtype), jp),
            tree_map(lambda x: torch.empty((n,) + tuple(x.shape),
                                           dtype=x.dtype, device=META), tp))


def _check_all(arch, jcfg, tcfg, meshes, batch=4, seq=64, b_local=2,
               s_local=16):
    jp = jax.eval_shape(lambda k: jtfm.init_params(jcfg, k),
                        jax.random.PRNGKey(0))
    tp = ttfm.init_params(tcfg, torch.Generator(), device=META)
    jc = jax.eval_shape(lambda: jtfm.init_cache(jcfg, batch, seq))
    tc = ttfm.init_cache(tcfg, batch, seq, device=META)
    for sizes, names in meshes:
        jm, tm = _jmesh(sizes, names), TMesh(names, sizes)
        assert tshd.data_axis(tm) == jshd.data_axis(jm)
        for stacked in (False, True):
            assert tshd.batch_spec(tm, stacked) == \
                tuple(jshd.batch_spec(jm, stacked))
        for fb in (False, True):
            _same(jp, jshd.param_specs(jp, jm, shard_head_dim_fallback=fb),
                  tp, tshd.param_specs(tp, tm, shard_head_dim_fallback=fb),
                  tm)
        n = math.prod(sizes[:-1])
        jx, tx = _stacked(n, jp, tp)
        ax = jshd.data_axis(jm)
        _same(jx, jshd.param_specs(jx, jm, stack_axes=(ax,)),
              tx, tshd.param_specs(tx, tm, stack_axes=(ax,)), tm)
        for kv in (False, True):
            _same(jc, jshd.cache_specs(jc, jm, kv_seq_sharded=kv),
                  tc, tshd.cache_specs(tc, tm, kv_seq_sharded=kv), tm)
        for mode in ("exact", "sketch"):
            jh = JHyper(n_workers=n, cut_mode=mode, sketch_r=64, p_max=2,
                        k_inner=1, remat=False)
            th = FedHyper(n_workers=n, cut_mode=mode, sketch_r=64, p_max=2,
                          k_inner=1, remat=False)
            js = jax.eval_shape(
                lambda k: j_init_fed_state(jcfg, jh, k, b_local, s_local),
                jax.random.PRNGKey(0))
            ts = init_fed_state(tcfg, th, torch.Generator(), b_local,
                                s_local, device=META)
            _same(js, jdr.fed_state_specs(js, jm, jh),
                  ts, tdr.fed_state_specs(ts, tm, th), tm)


@pytest.mark.parametrize("arch", tconfigs.ASSIGNED_ARCHS)
def test_reduced_specs_match_reference(arch):
    _check_all(arch, jconfigs.reduced(jconfigs.get_config(arch)),
               tconfigs.reduced(tconfigs.get_config(arch)), MESHES)


@pytest.mark.parametrize("arch", ["llama3-8b", "xlstm-125m",
                                  "whisper-large-v3"])
def test_full_size_specs_match_reference_on_the_pod(arch):
    pod = make_production_mesh()
    assert pod.shape == {"data": 16, "model": 16}
    _check_all(arch, jconfigs.get_config(arch), tconfigs.get_config(arch),
               [(pod.sizes, pod.axis_names)], batch=8, seq=128, b_local=1,
               s_local=32)


def test_production_meshes_are_the_reference_layouts():
    for multi in (False, True):
        m = make_production_mesh(multi_pod=multi)
        want = ((2, 16, 16), ("pod", "data", "model")) if multi \
            else ((16, 16), ("data", "model"))
        assert (m.sizes, m.axis_names) == want
        assert m.size == math.prod(want[0])


def test_tables_are_the_reference_tables():
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert tconfigs.DRYRUN_SKIPS == jconfigs.DRYRUN_SKIPS
    assert {k: vars(v) for k, v in tconfigs.INPUT_SHAPES.items()} == \
        {k: vars(v) for k, v in jconfigs.INPUT_SHAPES.items()}
    assert tconfigs.get_shape("long_500k").seq_len == 524_288
