"""The port's DenseLM against the reference's, on the same weights.

Reduced smollm-135m in fp32: the reference initialises the weights, and
``repro_torch.weights`` carries them across as a flat dict of numpy arrays.
Prefill logits and caches, then decode steps, match at the tolerance of
``tests/test_models_smoke.py`` (2e-4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models.transformer import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.models.transformer import build_model
from repro_torch.weights import dense_params_from_flat

TOL = dict(rtol=2e-4, atol=2e-4)


def flat_params(params) -> dict:
    """A JAX param pytree as a flat dict of numpy arrays keyed by path."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in leaves}


@pytest.fixture(scope="module")
def models():
    ref_cfg = ref_get_config("smollm-135m").reduced()
    cfg = get_config("smollm-135m").reduced()
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.key(5))
    model = build_model(cfg, device="cpu")
    params = dense_params_from_flat(flat_params(ref_params), cfg, "cpu")
    return ref_model, ref_params, model, params


def assert_cache_close(cache, ref_cache):
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(ref_cache[name]), **TOL)
    np.testing.assert_array_equal(cache["index"].numpy(),
                                  np.asarray(ref_cache["index"]))


def prefill_both(models, tokens, max_len):
    ref_model, ref_params, model, params = models
    B = tokens.shape[0]
    ref_logits, ref_cache = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(tokens)},
        ref_model.init_cache(B, max_len))
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                                  model.init_cache(B, max_len))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    assert_cache_close(cache, ref_cache)
    return cache, ref_cache


def decode_both(models, cache, ref_cache, tokens):
    ref_model, ref_params, model, params = models
    ref_logits, ref_cache = ref_model.decode(ref_params, jnp.asarray(tokens),
                                             ref_cache)
    logits, cache = model.decode(params, torch.from_numpy(tokens), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    assert_cache_close(cache, ref_cache)
    return cache, ref_cache


def test_prefill_then_decode_matches_reference(models):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (2, 9)).astype(np.int32)
    cache, ref_cache = prefill_both(models, tokens, max_len=32)
    for _ in range(3):
        step = rng.integers(0, 512, (2, 1)).astype(np.int32)
        cache, ref_cache = decode_both(models, cache, ref_cache, step)


def test_long_prefill_goes_through_chunked_attention(models):
    """T >= 1024 takes ``chunked_attention`` in both packages."""
    tokens = np.random.default_rng(1).integers(0, 512, (1, 1024)
                                               ).astype(np.int32)
    cache, ref_cache = prefill_both(models, tokens, max_len=1536)
    step = np.array([[3]], np.int32)
    decode_both(models, cache, ref_cache, step)


def test_idle_slot_past_max_len_clamps_its_write(models):
    """A slot whose index ran past ``max_len`` writes its last row (the
    reference's ``dynamic_update_slice`` clamps) and attends to all rows."""
    max_len = 8
    tokens = np.random.default_rng(2).integers(0, 512, (2, 4)).astype(np.int32)
    cache, ref_cache = prefill_both(models, tokens, max_len)
    index = np.array([4, max_len + 3], np.int32)
    cache["index"] = torch.from_numpy(index)
    ref_cache["index"] = jnp.asarray(index)
    for t in range(3):
        step = np.array([[t + 1], [t + 7]], np.int32)
        cache, ref_cache = decode_both(models, cache, ref_cache, step)
    assert cache["index"].tolist() == [7, max_len + 6]
