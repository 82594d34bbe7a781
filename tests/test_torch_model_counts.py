"""The port's analytic model counts (`repro_torch.models.config`
`param_count`, `active_param_count`, `step_flops`) equal the
reference's for every architecture, full and reduced, in prefill,
decode and training modes."""
import dataclasses

import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import config as jax_config
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.models import config

# (batch, seq, training, kv_len): prefill, training, decode against a
# cache, and decode past a long-context window
MODES = ((4, 1024, False, 0), (2, 129, True, 0), (4, 1, False, 1056),
         (1, 1, False, 200_000))


def test_the_registries_hold_the_same_architectures():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)


@pytest.mark.parametrize("small", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_counts_equal_the_references(name, small):
    cfg, jcfg = get_config(name), jax_get_config(name)
    if small:
        cfg, jcfg = reduced(cfg), jax_reduced(jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert config.param_count(cfg) == jax_config.param_count(jcfg)
    assert config.active_param_count(cfg) \
        == jax_config.active_param_count(jcfg)
    for batch, seq, training, kv_len in MODES:
        assert config.step_flops(cfg, batch, seq, training, kv_len) \
            == jax_config.step_flops(jcfg, batch, seq, training, kv_len), \
            (batch, seq, training, kv_len)
