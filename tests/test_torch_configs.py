"""The port's config registry holds the same data as the reference's."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.configs import _MODULES as REF_MODULES, ASSIGNED as REF_ASSIGNED
from repro.configs import get_config as ref_get_config
from repro_torch.configs import _MODULES, ASSIGNED, get_config

DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def assert_same(port, ref):
    names = [f.name for f in dataclasses.fields(ref)]
    assert [f.name for f in dataclasses.fields(port)] == names
    for name in names:
        want = getattr(ref, name)
        if name in ("param_dtype", "compute_dtype"):
            want = DTYPES[want]
        assert getattr(port, name) == want, name
    assert port.hd == ref.hd
    assert port.d_inner == ref.d_inner
    if ref.ssm_head_dim:
        assert port.ssm_heads == ref.ssm_heads


def test_registry_ids():
    assert _MODULES == REF_MODULES
    assert ASSIGNED == REF_ASSIGNED


@pytest.mark.parametrize("arch", list(REF_MODULES))
def test_config_fields(arch):
    assert_same(get_config(arch), ref_get_config(arch))
    assert_same(get_config(arch).reduced(), ref_get_config(arch).reduced())
    over = dict(n_layers=3, d_model=64, vocab_size=128)
    assert_same(get_config(arch).reduced(**over),
                ref_get_config(arch).reduced(**over))
