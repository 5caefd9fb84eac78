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


def test_stacked_init_draws_a_layer_at_a_time():
    """``init_attn`` and ``init_mlp`` stacked on (L,): each matrix one
    (L, fan_in, fan_out) leaf in the param dtype, as before and as the
    reference stacks it, and each layer its own N(0, 1) / sqrt(fan_in)
    draw. ``dense_init`` draws a leading index at a time into the
    preallocated leaf, so full width never holds a whole stack in fp32."""
    from dataclasses import replace

    from repro_torch.models.attention import init_attn
    from repro_torch.models.common import dense_init
    from repro_torch.models.ffn import init_mlp
    cfg = replace(get_config("smollm-135m").reduced(d_model=256, d_ff=512),
                  param_dtype=torch.bfloat16)
    L, d, ff = 3, cfg.d_model, cfg.d_ff
    hq, hkv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    attn = init_attn(torch.Generator().manual_seed(0), cfg, lead=(L,))
    mlp = init_mlp(torch.Generator().manual_seed(1), d, ff, cfg.param_dtype,
                   lead=(L,))
    assert [tuple(w.shape) for w in (*attn, *mlp)] == [
        (L, d, hq), (L, d, hkv), (L, d, hkv), (L, hq, d),
        (L, d, ff), (L, d, ff), (L, ff, d)]
    for w, fan_in in ((attn.wq, d), (attn.wo, hq), (mlp.w_up, d),
                      (mlp.w_down, ff)):
        assert w.dtype == torch.bfloat16 and w.is_contiguous()
        for layer in w.float():
            assert abs(layer.std().item() * fan_in ** 0.5 - 1) < 0.05
            assert abs(layer.mean().item()) * fan_in ** 0.5 < 0.05
        assert not torch.equal(w[0], w[1])
    # a leaf drawn a layer at a time is each layer's draw, in layer order
    gen = torch.Generator().manual_seed(2)
    leaf = dense_init(gen, (L, 32, 48), n_lead=1)
    gen.manual_seed(2)
    for layer in leaf:
        assert torch.equal(layer, dense_init(gen, (32, 48)))
