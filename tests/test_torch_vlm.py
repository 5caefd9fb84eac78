"""The port's vlm backbone (``DenseLM`` with ``patch_proj``) against the
reference's, on the same weights.

Reduced llava-next-34b (2 layers, d 128, 4/2 heads of hd 32, 16 patches,
fp32): the reference initialises the weights, ``repro_torch.weights``
carries them across, and both packages take the inputs of
``tests/test_models_smoke.py:make_batch``. The projected patches go before
the text: prefill leaves ``index`` at S + n_patches, the loss counts the
text positions only, and ``patch_proj`` takes a gradient; all at 2e-4. The
serving engine is text-only in both packages, with equal greedy streams.
JAX is imported inside the tests.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.launch import serve, train
from repro_torch.models import transformer as tm
from repro_torch.models.common import cross_entropy, tree_leaves
from repro_torch.weights import dense_params_from_flat

from test_torch_moe import flat_params, run_both

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "llava-next-34b"


def jax_side():
    """(jax, jax.numpy, the reference's configs and transformer, and
    ``tests/test_models_smoke.py:make_batch``)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs
    from repro.models import transformer
    from test_models_smoke import make_batch
    return jax, jnp, configs, transformer, make_batch


@pytest.fixture(scope="module")
def models():
    """(reference model, its params, the port's model, its params, the
    reference config)."""
    jax, _, rconfigs, transformer, _ = jax_side()
    ref_cfg = rconfigs.get_config(ARCH).reduced()
    ref_model = transformer.build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.key(8))
    cfg = get_config(ARCH).reduced()
    model = tm.build_model(cfg, device="cpu")
    params = dense_params_from_flat(flat_params(ref_params), cfg, "cpu")
    return ref_model, ref_params, model, params, ref_cfg


def batches(ref_cfg, B=2, S=16, seed=4):
    """make_batch's inputs (with ``patch_embeds``), as JAX arrays and as
    tensors."""
    jax, _, _, _, make_batch = jax_side()
    batch = make_batch(ref_cfg, B=B, S=S, key=jax.random.key(seed))
    return batch, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_build_model_gives_dense_with_patch_proj():
    cfg = get_config(ARCH).reduced()
    model = tm.build_model(cfg, device="cpu")
    assert type(model) is tm.DenseLM
    params = model.init(torch.Generator().manual_seed(0))
    assert params["patch_proj"].shape == (cfg.d_model, cfg.d_model)
    dense = tm.build_model(get_config("smollm-135m").reduced(), device="cpu")
    assert "patch_proj" not in dense.init(torch.Generator().manual_seed(0))


def test_prefill_with_patches_then_decode_matches_reference(models):
    _, jnp, _, _, _ = jax_side()
    ref_model, ref_params, model, params, ref_cfg = models
    batch, tbatch = batches(ref_cfg)
    del batch["labels"], tbatch["labels"]
    ref_logits, ref_cache = ref_model.prefill(ref_params, batch,
                                              ref_model.init_cache(2, 48))
    logits, cache = model.prefill(params, tbatch, model.init_cache(2, 48))
    assert cache["index"].tolist() == [16 + ref_cfg.n_patches] * 2
    rng = np.random.default_rng(2)
    for step in range(4):
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(ref_cache[name]), **TOL)
        np.testing.assert_array_equal(cache["index"].numpy(),
                                      np.asarray(ref_cache["index"]))
        if step == 3:
            break
        tok = rng.integers(0, ref_cfg.vocab_size, (2, 1)).astype(np.int32)
        ref_logits, ref_cache = ref_model.decode(ref_params,
                                                 jnp.asarray(tok), ref_cache)
        logits, cache = model.decode(params, torch.from_numpy(tok), cache)


def test_text_only_prefill_matches_reference(models):
    """Without ``patch_embeds`` the vlm backbone is a dense LM: index S."""
    ref_model, ref_params, model, params, ref_cfg = models
    batch, tbatch = batches(ref_cfg, seed=9)
    ref_logits, _ = ref_model.prefill(ref_params,
                                      {"tokens": batch["tokens"]},
                                      ref_model.init_cache(2, 32))
    logits, cache = model.prefill(params, {"tokens": tbatch["tokens"]},
                                  model.init_cache(2, 32))
    assert cache["index"].tolist() == [16, 16]
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)


def test_loss_and_gradients_match_jax(models):
    """The loss over the text positions only, and every leaf's gradient,
    ``patch_proj``'s among them."""
    jax, _, _, _, _ = jax_side()
    from repro_torch.train.train_step import value_and_grad
    ref_model, ref_params, model, params, ref_cfg = models
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
    assert grads["patch_proj"].abs().max() > 0
    np.testing.assert_allclose(grads["patch_proj"].numpy(),
                               np.asarray(ref_grads["patch_proj"]),
                               rtol=2e-4, atol=2e-6)
    # the same loss from the trunk's text positions, counted by hand
    h = model._trunk(params, model._embed(params, tbatch["tokens"],
                                          tbatch["patch_embeds"]))
    assert h.shape[1] == 32 + ref_cfg.n_patches
    text = h[:, ref_cfg.n_patches:] @ params["lm_head"]
    assert torch.equal(loss, cross_entropy(text, tbatch["labels"]))


def test_remat_block_equals_none(models):
    from repro_torch.train.train_step import value_and_grad
    _, _, model, params, ref_cfg = models
    _, batch = batches(ref_cfg, S=32, seed=6)
    remat = tm.build_model(replace(model.cfg, remat="block"), device="cpu")
    plain_loss, plain_grads = value_and_grad(model.loss_fn, params, batch)
    loss, grads = value_and_grad(remat.loss_fn, params, batch)
    assert torch.equal(loss, plain_loss)
    for g, w in zip(tree_leaves(grads), tree_leaves(plain_grads)):
        assert torch.equal(g, w)


def test_text_only_engine_streams_equal_the_jax_engine(models):
    ref_model, ref_params, model, params, _ = models
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (5, 9, 13, 4, 7)]
    got, want = run_both((ref_model, ref_params, model, params), prompts,
                         n_slots=4)
    assert got == want


def test_weight_bridge_takes_patch_proj_exactly_for_vlm(models):
    _, ref_params, model, _, _ = models
    cfg = model.cfg
    flat = flat_params(ref_params)
    assert "patch_proj" in flat
    params = dense_params_from_flat(
        flat, replace(cfg, param_dtype=torch.bfloat16), "cpu")
    assert params["patch_proj"].dtype == torch.bfloat16
    assert params["patch_proj"].shape == (cfg.d_model, cfg.d_model)
    with pytest.raises(KeyError, match="unexpected"):
        dense_params_from_flat(flat, replace(cfg, family="dense"), "cpu")
    text_only = {k: v for k, v in flat.items() if k != "patch_proj"}
    with pytest.raises(KeyError, match="missing"):
        dense_params_from_flat(text_only, cfg, "cpu")


def test_launch_serve_and_train_on_the_cpu(tmp_path):
    """Both entry points run the vlm backbone text-only, as the
    reference's do."""
    result = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                         "--requests", "6", "--max-new", "4"])
    assert result["requests"] == 6 and result["tokens_generated"] == 6 * 3
    done = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--steps", "2", "--seq", "16", "--batch", "2",
                       "--ckpt-every", "2", "--log-every", "0", "--cas",
                       str(tmp_path / "cas")])
    assert len(done["losses"]) == 2 and np.isfinite(done["losses"]).all()
    assert done["manifest"]
