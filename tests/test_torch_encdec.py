"""The port's enc-dec backbone against the reference's, on the same weights.

Reduced whisper-tiny (2 + 2 layers, d 128, 4/2 heads of hd 32, enc_len 24,
fp32): the reference initialises the weights, ``repro_torch.weights``
carries them across, and both packages take the inputs of
``tests/test_models_smoke.py:make_batch``. ``_sinusoid`` matches at 1e-6,
the cross-attention ``attention_block`` at 1e-5, ``encode``, prefill, three
decode steps (cache leaves included), the loss and its gradients at 2e-4
(the tolerance of ``tests/test_models_smoke.py``); greedy streams are
equal. JAX is imported inside the tests.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.launch import serve, train
from repro_torch.models import transformer as tm
from repro_torch.models.attention import AttnParams, attention_block
from repro_torch.models.common import tree_leaves
from repro_torch.weights import encdec_params_from_flat

from test_torch_moe import flat_params

TOL = dict(rtol=2e-4, atol=2e-4)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "whisper-tiny"


def jax_side():
    """(jax, jax.numpy, the reference's configs, attention, transformer,
    and ``tests/test_models_smoke.py:make_batch``)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs
    from repro.models import attention, transformer
    from test_models_smoke import make_batch
    return jax, jnp, configs, attention, transformer, make_batch


@pytest.fixture(scope="module")
def models():
    """(reference config, model, params; the port's model and params)."""
    jax, _, rconfigs, _, transformer, _ = jax_side()
    ref_cfg = rconfigs.get_config(ARCH).reduced()
    ref_model = transformer.build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.key(3))
    cfg = get_config(ARCH).reduced()
    model = tm.build_model(cfg, device="cpu")
    params = encdec_params_from_flat(flat_params(ref_params), cfg, "cpu")
    return ref_cfg, ref_model, ref_params, model, params


def batches(ref_cfg, B=2, S=16, seed=4):
    """make_batch's inputs, as JAX arrays and as tensors."""
    jax, _, _, _, _, make_batch = jax_side()
    batch = make_batch(ref_cfg, B=B, S=S, key=jax.random.key(seed))
    return batch, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_build_model_gives_encdec():
    model = tm.build_model(get_config(ARCH).reduced(), device="cpu")
    assert type(model) is tm.EncDecLM
    assert model.cache_slot_axes() == {"k": 1, "v": 1, "cross_k": 1,
                                       "cross_v": 1}


@pytest.mark.parametrize("T,d", [(24, 128), (448, 64)])
def test_sinusoid_matches_reference(T, d):
    _, jnp, _, _, transformer, _ = jax_side()
    np.testing.assert_allclose(
        tm._sinusoid(T, d, torch.float32).numpy(),
        np.asarray(transformer._sinusoid(T, d, jnp.float32)),
        rtol=1e-6, atol=1e-6)


def test_cross_attention_block_matches_reference(models):
    """q projected alone, no RoPE, every encoder position attended (no
    mask), then ``wo``; no cache comes back."""
    jax, jnp, _, attention, _, _ = jax_side()
    ref_cfg, _, _, model, _ = models
    cfg = model.cfg
    ref_p = attention.init_attn(jax.random.key(7), ref_cfg)
    p = AttnParams(*(torch.from_numpy(np.array(w)) for w in ref_p))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, cfg.d_model), np.float32)
    k, v = (rng.standard_normal((2, cfg.enc_len, cfg.n_kv_heads, cfg.hd),
                                np.float32) for _ in range(2))
    want, ref_cache = attention.attention_block(
        ref_p, jnp.asarray(x), ref_cfg, cross_kv=(jnp.asarray(k),
                                                  jnp.asarray(v)))
    got, cache = attention_block(p, torch.from_numpy(x), cfg,
                                 cross_kv=(torch.from_numpy(k),
                                           torch.from_numpy(v)))
    assert cache is None and ref_cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


def test_encode_matches_reference(models):
    ref_cfg, ref_model, ref_params, model, params = models
    batch, tbatch = batches(ref_cfg)
    np.testing.assert_allclose(
        model.encode(params, tbatch["frames"]).numpy(),
        np.asarray(ref_model.encode(ref_params, batch["frames"])), **TOL)


def test_prefill_then_decode_matches_reference(models):
    _, jnp, _, _, _, _ = jax_side()
    ref_cfg, ref_model, ref_params, model, params = models
    batch, tbatch = batches(ref_cfg)
    del batch["labels"], tbatch["labels"]
    ref_logits, ref_cache = ref_model.prefill(ref_params, batch,
                                              ref_model.init_cache(2, 32))
    logits, cache = model.prefill(params, tbatch, model.init_cache(2, 32))
    rng = np.random.default_rng(1)
    for step in range(4):
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   **TOL)
        assert sorted(cache) == sorted(ref_cache)
        for name in ("k", "v", "cross_k", "cross_v"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(ref_cache[name]), **TOL)
        np.testing.assert_array_equal(cache["index"].numpy(),
                                      np.asarray(ref_cache["index"]))
        assert cache["index"].tolist() == [16 + step] * 2
        if step == 3:
            break
        tok = rng.integers(0, ref_cfg.vocab_size, (2, 1)).astype(np.int32)
        ref_logits, ref_cache = ref_model.decode(ref_params,
                                                 jnp.asarray(tok), ref_cache)
        logits, cache = model.decode(params, torch.from_numpy(tok), cache)


def test_prefill_refuses_frames_of_another_length(models):
    _, _, _, model, params = models
    cfg = model.cfg
    frames = torch.zeros((1, cfg.enc_len - 1, cfg.d_model))
    tokens = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="enc_len"):
        model.prefill(params, {"tokens": tokens, "frames": frames},
                      model.init_cache(1, 8))


def test_loss_and_gradients_match_jax(models):
    jax, _, _, _, _, _ = jax_side()
    from repro_torch.train.train_step import value_and_grad
    ref_cfg, ref_model, ref_params, model, params = models
    batch, tbatch = batches(ref_cfg, S=32, seed=5)
    ref_loss, ref_grads = jax.value_and_grad(ref_model.loss_fn)(ref_params,
                                                                batch)
    loss, grads = value_and_grad(model.loss_fn, params, tbatch)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-5)
    ref_leaves = jax.tree_util.tree_leaves(ref_grads)
    leaves = tree_leaves(grads)
    assert len(leaves) == len(ref_leaves)
    for got, want in zip(leaves, ref_leaves):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-6)
    # the cross-attention's K/V weights take gradient through the encoder
    cross = grads["dec_layers"].cross_attn
    assert cross.wk.abs().max() > 0 and cross.wv.abs().max() > 0


def test_remat_block_equals_none(models):
    from repro_torch.train.train_step import value_and_grad
    ref_cfg, _, _, model, params = models
    _, batch = batches(ref_cfg, S=32, seed=6)
    remat = tm.build_model(replace(model.cfg, remat="block"), device="cpu")
    plain_loss, plain_grads = value_and_grad(model.loss_fn, params, batch)
    loss, grads = value_and_grad(remat.loss_fn, params, batch)
    assert torch.equal(loss, plain_loss)
    for g, w in zip(tree_leaves(grads), tree_leaves(plain_grads)):
        assert torch.equal(g, w)


def test_greedy_streams_equal_the_reference(models):
    """Prefill, then 8 greedy decode steps, each package on its own
    argmax."""
    _, jnp, _, _, _, _ = jax_side()
    ref_cfg, ref_model, ref_params, model, params = models
    batch, tbatch = batches(ref_cfg, B=3, S=6, seed=7)
    del batch["labels"], tbatch["labels"]
    ref_logits, ref_cache = ref_model.prefill(ref_params, batch,
                                              ref_model.init_cache(3, 16))
    logits, cache = model.prefill(params, tbatch, model.init_cache(3, 16))
    ref_stream, stream = [], []
    for _ in range(9):
        ref_tok = jnp.argmax(ref_logits[:, -1], -1).astype(jnp.int32)[:, None]
        tok = logits[:, -1].argmax(-1)[:, None]
        ref_stream.append(np.asarray(ref_tok)[:, 0].tolist())
        stream.append(tok[:, 0].tolist())
        ref_logits, ref_cache = ref_model.decode(ref_params, ref_tok,
                                                 ref_cache)
        logits, cache = model.decode(params, tok, cache)
    assert stream == ref_stream


def test_weight_bridge_paths_and_dtypes(models):
    _, _, ref_params, model, _ = models
    cfg = model.cfg
    flat = flat_params(ref_params)
    assert {p.split("/")[0] for p in flat} == {
        "embed", "enc_layers", "dec_layers", "enc_norm", "final_norm",
        "lm_head"}
    assert {p for p in flat if p.startswith("dec_layers/cross_attn/")} == \
        {f"dec_layers/cross_attn/{n}" for n in AttnParams._fields}
    params = encdec_params_from_flat(
        flat, replace(cfg, param_dtype=torch.bfloat16), "cpu")
    assert type(params["enc_layers"]) is tm.EncLayer
    assert type(params["dec_layers"]) is tm.DecLayer
    assert params["dec_layers"].cross_attn.wq.dtype == torch.bfloat16
    assert params["enc_layers"].mlp.w_up.shape[0] == cfg.n_enc_layers
    assert params["dec_layers"].norm3.shape == (cfg.n_layers, cfg.d_model)
    # the bridged tree has the port's own init's paths and shapes
    own = model.init(torch.Generator().manual_seed(0))
    assert [t.shape for t in tree_leaves(own)] == \
        [t.shape for t in tree_leaves(params)]
    missing = dict(flat)
    del missing["dec_layers/norm3"]
    with pytest.raises(KeyError, match="missing"):
        encdec_params_from_flat(missing, cfg, "cpu")
    with pytest.raises(KeyError, match="unexpected"):
        encdec_params_from_flat({**flat, "layers/norm1": flat["enc_norm"]},
                                cfg, "cpu")
    with pytest.raises(ValueError, match="config stacks"):
        encdec_params_from_flat(flat, replace(cfg, n_enc_layers=3), "cpu")


@pytest.mark.parametrize("entry", [serve, train])
def test_launch_refuses_encdec(entry, tmp_path):
    """Neither entry point has frames to hand the model: the engine and
    ``SyntheticLM`` give tokens only, as the reference's do."""
    with pytest.raises(SystemExit, match="frames"):
        entry.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--cas", str(tmp_path)] if entry is train else
                   ["--arch", ARCH, "--reduced", "--device", "cpu"])
