"""The port's training path against the reference's, on the same weights
and the same batches.

Reduced smollm-135m in fp32: the reference initialises the weights and
draws the batches (``jax.random``), and both go to the port as numpy
arrays. The loss and its gradients, decode against the full forward, three
steps of AdamW and of Adafactor with momentum, gradient accumulation and
the compress hook are held against JAX at the tolerance of
``tests/test_models_smoke.py`` (2e-4) unless stated otherwise.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.models.common import count_params as ref_count_params
from repro.models.transformer import build_model as ref_build_model
from repro.train import optimizer as ref_opt
from repro.train.data import DataConfig as RefDataConfig
from repro.train.data import SyntheticLM as RefSyntheticLM
from repro.train.train_step import build_train_step as ref_build_train_step
from repro_torch.configs import get_config
from repro_torch.models.common import count_params, tree_leaves
from repro_torch.models.transformer import build_model
from repro_torch.train import optimizer
from repro_torch.train.train_step import value_and_grad, build_train_step
from repro_torch.weights import dense_params_from_flat

TOL = dict(rtol=2e-4, atol=2e-4)
SEQ, BATCH = 32, 4


def flat_params(params) -> dict:
    """A JAX param pytree as a flat dict of numpy arrays keyed by path."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def assert_tree_close(tree, ref_tree, **tol):
    """Port tree against a JAX tree, leaf by leaf in flattening order."""
    ref_leaves = jax.tree_util.tree_leaves(ref_tree)
    leaves = tree_leaves(tree)
    assert len(leaves) == len(ref_leaves)
    for got, want in zip(leaves, ref_leaves):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   np.asarray(want, np.float32), **tol)


@pytest.fixture(scope="module")
def models():
    ref_model = ref_build_model(ref_get_config("smollm-135m").reduced())
    ref_params = ref_model.init(jax.random.key(5))
    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg, device="cpu")
    return ref_model, ref_params, model


def port_params(models):
    ref_model, ref_params, model = models
    return dense_params_from_flat(flat_params(ref_params), model.cfg, "cpu")


def ref_batch(step, batch=BATCH, seq=SEQ):
    data = RefSyntheticLM(RefDataConfig(512, seq, batch, seed=3))
    return {k: np.asarray(v) for k, v in data.batch(step).items()}


def to_port(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def test_loss_and_gradients_match_jax(models):
    ref_model, ref_params, model = models
    batch = ref_batch(0)
    ref_loss, ref_grads = jax.value_and_grad(ref_model.loss_fn)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    params = port_params(models)
    assert count_params(params) == ref_count_params(ref_params)
    loss, grads = value_and_grad(model.loss_fn, params, to_port(batch))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-5)
    assert_tree_close(grads, ref_grads, rtol=2e-4, atol=2e-6)


def test_remat_block_equals_none(models):
    """Checkpointing each layer changes when the forward runs, not what
    the loss and gradients are."""
    _, _, model = models
    batch = to_port(ref_batch(1))
    params = port_params(models)
    remat = build_model(replace(model.cfg, remat="block"), device="cpu")
    plain_loss, plain_grads = value_and_grad(model.loss_fn, params, batch)
    loss, grads = value_and_grad(remat.loss_fn, params, batch)
    assert torch.equal(loss, plain_loss)
    for g, p in zip(tree_leaves(grads), tree_leaves(plain_grads)):
        assert torch.equal(g, p)


def test_decode_matches_full_forward_dense(models):
    """The port of ``tests/test_models_smoke.py``'s test: step-by-step
    decode reproduces the teacher-forced forward pass."""
    _, _, model = models
    params = port_params(models)
    toks = torch.from_numpy(np.array(jax.random.randint(
        jax.random.key(6), (1, 8), 0, model.cfg.vocab_size), np.int32))
    with torch.no_grad():
        full = model._trunk(params, model._embed(params, toks)) @ \
            params["lm_head"]
        cache = model.init_cache(1, 12)
        _, cache = model.prefill(params, {"tokens": toks[:, :1]}, cache)
        outs = []
        for i in range(1, 8):
            logits, cache = model.decode(params, toks[:, i:i + 1], cache)
            outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               full[:, 1:].numpy(), **TOL)


OPTIMIZERS = {
    # weight decay 0.1, so that decaying (or not) the (L, d) norm weights
    # moves them by lr * 0.1 per step, far above the tolerance. AdamW's
    # eps 1e-4 (typical gradients here are ~5e-3): with 1e-8, an entry
    # whose gradient is ~1e-8 moves by +-lr on the sign of fp32 noise
    # (4 of 65536 embedding entries did), in either package.
    "adamw": dict(name="adamw", peak_lr=3e-3, warmup=2, total_steps=10,
                  weight_decay=0.1, eps=1e-4),
    "adafactor": dict(name="adafactor", peak_lr=3e-3, warmup=2,
                      total_steps=10, weight_decay=0.1, momentum=True),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_three_optimizer_steps_match_jax(models, name):
    """Three steps from shared params on the reference's batches: the same
    losses and params. The optimizer sees the stacked (L, ...) leaves, so
    the norms are decayed and Adafactor factors them over (L, d), as in
    the reference."""
    ref_model, ref_params, model = models
    ref_o = ref_opt.build_optimizer(ref_opt.OptimizerConfig(
        **OPTIMIZERS[name]))
    o = optimizer.build_optimizer(optimizer.OptimizerConfig(
        **OPTIMIZERS[name]))
    ref_state = {"params": ref_params, "opt": ref_o.init(ref_params)}
    params = port_params(models)
    state = {"params": params, "opt": o.init(params)}
    ref_step = jax.jit(ref_build_train_step(ref_model, ref_o))
    step = build_train_step(model, o)
    for i in range(3):
        batch = ref_batch(i)
        ref_state, ref_m = ref_step(
            ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, to_port(batch))
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=2e-4)
    assert int(state["opt"]["step"]) == 3
    assert_tree_close(state["params"], ref_state["params"], atol=2e-5,
                      rtol=2e-5)
    # the norms moved off 1 by the decay, identically in both
    norm1 = state["params"]["layers"].norm1
    assert not torch.all(norm1 == 1.0)


def test_grad_accum_equals_full_batch_and_compress_carries_residual(models):
    """Four microbatches, gradients summed in fp32 and divided by four,
    equal the full batch's; the compress hook sees them and its residual
    is carried in the state."""
    _, _, model = models
    batch = to_port(ref_batch(2, batch=8))
    seen = {}

    def compress(key):
        def hook(grads, residual):
            seen[key] = grads
            return grads, (0 if residual is None else residual) + 1
        return hook

    o = optimizer.build_optimizer(optimizer.OptimizerConfig())
    metrics = {}
    for accum in (1, 4):
        params = port_params(models)
        state = {"params": params, "opt": o.init(params)}
        step = build_train_step(model, o, grad_accum=accum,
                                compress=compress(accum))
        state, metrics[accum] = step(state, batch)
        state, _ = step(state, batch)
        assert state["compress_residual"] == 2
    np.testing.assert_allclose(float(metrics[4]["loss"]),
                               float(metrics[1]["loss"]), rtol=1e-6)
    for g4, g1 in zip(tree_leaves(seen[4]), tree_leaves(seen[1])):
        assert g4.dtype == torch.float32
        np.testing.assert_allclose(g4.numpy(), g1.numpy(), rtol=1e-5,
                                   atol=1e-7)
