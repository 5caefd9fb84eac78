"""The port's MoE family against the reference's, on the same weights.

Reduced qwen2-moe-a2.7b and kimi-k2-1t-a32b (E 4, top-2, one shared
expert, d 128, fp32): the reference initialises the weights, and
``repro_torch.weights`` carries them across. ``moe_block`` matches the
reference's output and auxiliary loss at 1e-5, with the same dispatch rows,
and an independent per-token loop; ``MoELM`` matches prefill, decode, the
loss and its gradients at the tolerances of ``tests/test_models_smoke.py``
(2e-4); the serving engine's greedy streams equal the JAX engine's, also
past the capacity, where a slot's output depends on its neighbours in both.
JAX is imported inside the tests: the machine with the card runs the
``gpu`` case without it.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.launch import serve, train
from repro_torch.models import ffn
from repro_torch.models.common import tree_leaves
from repro_torch.models.transformer import MoELM, build_model
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.weights import moe_params_from_flat

TOL = dict(rtol=2e-4, atol=2e-4)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"]


def jax_side():
    """(jax, jax.numpy, the reference's configs, ffn and transformer)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs
    from repro.models import ffn as rffn
    from repro.models import transformer
    return jax, jnp, configs, rffn, transformer


def flat_params(params) -> dict:
    """A JAX param pytree as a flat dict of numpy arrays keyed by path."""
    import jax
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def configs(arch="qwen2-moe-a2.7b", **overrides):
    """The reference's reduced config and the port's, same overrides."""
    _, _, rconfigs, _, _ = jax_side()
    return (rconfigs.get_config(arch).reduced(**overrides),
            get_config(arch).reduced(**overrides))


def block_params(ref_cfg, cfg, seed):
    """A reference ``MoEParams`` and the port's copy of it."""
    jax, _, _, rffn, _ = jax_side()
    rp = rffn.init_moe(jax.random.key(seed), ref_cfg)
    shared = None
    if rp.shared is not None:
        shared = ffn.MLPParams(*(torch.from_numpy(np.array(w))
                                 for w in rp.shared))
    p = ffn.MoEParams(*(torch.from_numpy(np.array(w)) for w in rp[:4]),
                      shared)
    assert p.router.dtype == torch.float32
    assert p.w_gate.shape[0] == max(cfg.n_experts, cfg.moe_pad_experts)
    return rp, p


def ref_dest(jnp, x, router, cfg, C):
    """``dest`` of the reference's dispatch (``repro/models/ffn.py:96-121``,
    its own lines in jnp), moved to the flat (token, choice) order the
    port's ``dispatch_plan`` returns it in."""
    import jax
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = cfg.moe_groups if (B * T) % cfg.moe_groups == 0 else 1
    ng = B * T // G
    probs = jax.nn.softmax(jnp.einsum("gnd,de->gne", jnp.asarray(x).reshape(
        G, ng, d), jnp.asarray(router)), axis=-1)
    _, expert_ids = jax.lax.top_k(probs, k)
    flat = expert_ids.reshape(G, ng * k)
    order = jnp.argsort(flat, axis=-1, stable=True)
    sorted_expert = jnp.take_along_axis(flat, order, axis=-1)
    first = jax.vmap(lambda se: jnp.searchsorted(se, jnp.arange(E),
                                                 side="left"))(sorted_expert)
    ranks = jnp.arange(ng * k)[None, :] - jnp.take_along_axis(
        first, sorted_expert, axis=-1)
    dest = np.asarray(jnp.where(ranks < C, sorted_expert * C + ranks, E * C))
    out = np.empty_like(dest)
    np.put_along_axis(out, np.asarray(order), dest, axis=-1)
    return np.asarray(expert_ids), out


def loop_moe(p, x, cfg):
    """An independent reference: per group, token by token and choice by
    choice, a pair is kept while its expert has had fewer than C pairs;
    each kept pair adds its gate times its expert's SwiGLU."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = cfg.moe_groups if (B * T) % cfg.moe_groups == 0 else 1
    ng = B * T // G
    C = ffn._capacity(ng, cfg)
    xt = x.reshape(G, ng, d)
    out = torch.zeros_like(xt)
    for g in range(G):
        load = [0] * E
        for t in range(ng):
            probs = torch.softmax(xt[g, t] @ p.router, -1)
            gates, ids = torch.topk(probs, k)
            gates = gates / gates.sum()
            for gate, e in zip(gates, ids.tolist()):
                if load[e] < C:
                    h = xt[g, t]
                    y = (torch.nn.functional.silu(h @ p.w_gate[e])
                         * (h @ p.w_up[e])) @ p.w_down[e]
                    out[g, t] += gate * y
                load[e] += 1
    if p.shared is not None:
        out = out + ffn.swiglu(p.shared, xt, cfg.compute_dtype)
    return out.reshape(B, T, d)


# (name, overrides, x shape): groups, a token count the groups do not
# divide, tokens dropped at capacity 0.5, no shared expert, padded experts
BLOCK_CASES = [
    ("base", {}, (2, 32)),
    ("groups 2", {"moe_groups": 2}, (2, 32)),
    ("groups 4, n 14 falls back to 1", {"moe_groups": 4}, (2, 7)),
    ("capacity 0.5 drops", {"capacity_factor": 0.5}, (2, 32)),
    ("capacity 0.5, groups 2", {"capacity_factor": 0.5,
                                "moe_groups": 2}, (4, 16)),
    ("no shared expert", {"n_shared_experts": 0}, (2, 32)),
    ("padded to 8 experts", {"moe_pad_experts": 8}, (2, 32)),
]


@pytest.mark.parametrize("name,overrides,shape", BLOCK_CASES,
                         ids=[c[0] for c in BLOCK_CASES])
def test_moe_block_matches_reference(name, overrides, shape):
    jax, jnp, _, rffn, _ = jax_side()
    ref_cfg, cfg = configs(**overrides)
    ref_p, p = block_params(ref_cfg, cfg, seed=len(name))
    x = np.random.default_rng(len(name)).standard_normal(
        (*shape, cfg.d_model), np.float32)
    ref_out, ref_aux = rffn.moe_block(ref_p, jnp.asarray(x), ref_cfg)
    out, aux = ffn.moe_block(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **BLOCK_TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), **BLOCK_TOL)

    G = cfg.moe_groups if x.shape[0] * x.shape[1] % cfg.moe_groups == 0 \
        else 1
    ng = x.shape[0] * x.shape[1] // G
    C = ffn._capacity(ng, cfg)
    assert C == rffn._capacity(ng, ref_cfg)
    ref_ids, want = ref_dest(jnp, x, p.router.numpy(), cfg, C)
    _, _, ids = ffn.route(p, torch.from_numpy(x).reshape(G, ng, -1), cfg)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    dest = ffn.dispatch_plan(ids, cfg.n_experts, C).numpy()
    np.testing.assert_array_equal(dest, want)
    E = cfg.n_experts
    np.testing.assert_array_equal(dest < E * C, want < E * C)   # keep
    if cfg.capacity_factor < 1:
        assert (dest == E * C).any(), "the case must drop tokens"
    np.testing.assert_allclose(
        out.numpy(), loop_moe(p, torch.from_numpy(x), cfg).numpy(),
        **BLOCK_TOL)


def test_capacity_matches_reference():
    _, _, _, rffn, _ = jax_side()
    for overrides in ({}, {"capacity_factor": 0.5}, {"top_k": 1}):
        ref_cfg, cfg = configs(**overrides)
        for n in (1, 7, 8, 12, 64, 100, 1500):
            assert ffn._capacity(n, cfg) == rffn._capacity(n, ref_cfg)
    # qwen2-moe at full width: 8 slots fit, 1500 prompt tokens take 128
    full = get_config("qwen2-moe-a2.7b")
    assert [ffn._capacity(n, full) for n in (8, 12, 108, 1500)] == \
        [8, 8, 16, 128]


def test_init_moe_layout():
    cfg = replace(get_config("qwen2-moe-a2.7b").reduced(),
                  moe_pad_experts=8, param_dtype=torch.bfloat16)
    p = ffn.init_moe(torch.Generator().manual_seed(0), cfg, lead=(3,))
    d, ff = cfg.d_model, cfg.d_ff
    assert p.router.shape == (3, d, 4) and p.router.dtype == torch.float32
    assert p.w_gate.shape == p.w_up.shape == (3, 8, d, ff)
    assert p.w_down.shape == (3, 8, ff, d)
    assert p.w_down.dtype == torch.bfloat16
    assert p.shared.w_gate.shape == (3, d, ff * cfg.n_shared_experts)
    # N(0, 1) / sqrt(fan_in), each layer and expert its own draw
    for w, fan_in in ((p.w_gate, d), (p.w_down, ff)):
        w = w.float()
        assert abs(w.std().item() * fan_in ** 0.5 - 1) < 0.05
        assert not torch.equal(w[0, 0], w[1, 0])
        assert not torch.equal(w[0, 0], w[0, 1])
    no_shared = replace(cfg, n_shared_experts=0)
    assert ffn.init_moe(torch.Generator(), no_shared).shared is None


# ---------------------------------------------------------------------------
# MoELM
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(reference model, its params, the port's model, its params)."""
    jax, _, _, _, transformer = jax_side()
    ref_cfg, cfg = configs(request.param)
    ref_model = transformer.build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.key(5))
    model = build_model(cfg, device="cpu")
    params = moe_params_from_flat(flat_params(ref_params), cfg, "cpu")
    return ref_model, ref_params, model, params


def test_build_model_families():
    for arch in ARCHS:
        assert type(build_model(get_config(arch).reduced(),
                                device="cpu")) is MoELM
    for arch in ("whisper-tiny", "llava-next-34b"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            build_model(get_config(arch).reduced(), device="cpu")


def test_prefill_then_decode_matches_reference(models):
    _, jnp, _, _, _ = jax_side()
    ref_model, ref_params, model, params = models
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (2, 9)).astype(np.int32)
    ref_logits, ref_cache = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(tokens)},
        ref_model.init_cache(2, 32))
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                                  model.init_cache(2, 32))
    for _ in range(4):
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(ref_cache[name]), **TOL)
        np.testing.assert_array_equal(cache["index"].numpy(),
                                      np.asarray(ref_cache["index"]))
        step = rng.integers(0, 512, (2, 1)).astype(np.int32)
        ref_logits, ref_cache = ref_model.decode(ref_params,
                                                 jnp.asarray(step), ref_cache)
        logits, cache = model.decode(params, torch.from_numpy(step), cache)


def loss_batch(seed, B=2, T=16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 512, (B, T + 1)).astype(np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
            "loss_mask": (rng.random((B, T)) < 0.9).astype(np.float32)}


def test_loss_and_gradients_match_jax(models):
    """The loss with its auxiliary term, and every leaf's gradient (the
    router's through the softmax and the aux loss)."""
    jax, jnp, _, _, _ = jax_side()
    from repro_torch.train.train_step import value_and_grad
    ref_model, ref_params, model, params = models
    batch = loss_batch(1)
    ref_loss, ref_grads = jax.value_and_grad(ref_model.loss_fn)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(model.loss_fn, params,
                                 {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-5)
    ref_leaves = jax.tree_util.tree_leaves(ref_grads)
    leaves = tree_leaves(grads)
    assert len(leaves) == len(ref_leaves)
    for got, want in zip(leaves, ref_leaves):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-6)
    # the mean auxiliary loss over the layers, which the loss adds
    _, ref_aux = ref_model._trunk(ref_params, ref_model._embed(
        ref_params, {"tokens": jnp.asarray(batch["tokens"])}))
    _, aux = model._trunk(params, model._embed(params, torch.from_numpy(
        batch["tokens"])))
    assert aux.item() > 0.5
    np.testing.assert_allclose(aux.item(), float(ref_aux), rtol=2e-5)


def test_remat_block_equals_none(models):
    from repro_torch.train.train_step import value_and_grad
    _, _, model, params = models
    batch = {k: torch.from_numpy(v) for k, v in loss_batch(2).items()}
    remat = build_model(replace(model.cfg, remat="block"), device="cpu")
    plain_loss, plain_grads = value_and_grad(model.loss_fn, params, batch)
    loss, grads = value_and_grad(remat.loss_fn, params, batch)
    assert torch.equal(loss, plain_loss)
    for g, w in zip(tree_leaves(grads), tree_leaves(plain_grads)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def engines(models, n_slots, max_len=64):
    from repro.serve import engine as ref_engine
    ref_model, ref_params, model, params = models
    return (ServingEngine(model, params, n_slots=n_slots, max_len=max_len),
            ref_engine.ServingEngine(ref_model, ref_params, n_slots=n_slots,
                                     max_len=max_len), ref_engine.Request)


def run_both(models, prompts, n_slots, max_new=6):
    """Greedy streams of the port's engine and the JAX engine, stepped in
    lockstep with the same requests."""
    eng, ref, RefRequest = engines(models, n_slots)
    reqs = [Request(p.copy(), max_new_tokens=max_new) for p in prompts]
    ref_reqs = [RefRequest(p.copy(), max_new_tokens=max_new)
                for p in prompts]
    for r, rr in zip(reqs, ref_reqs):
        eng.submit(r)
        ref.submit(rr)
    while eng.waiting or eng.active:
        eng.step()
        ref.step()
        assert eng.cache["index"].tolist() == \
            np.asarray(ref.cache["index"]).tolist()
    assert not (ref.waiting or ref.active)
    return [r.generated for r in reqs], [r.generated for r in ref_reqs]


def test_streams_equal_the_jax_engine(models):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (5, 9, 13, 4, 7)]
    got, want = run_both(models, prompts, n_slots=4)
    assert got == want
    # at 4 slots (C = 8 >= 4 tokens a step) a stream does not depend on
    # its neighbours: each equals its prompt served alone
    _, _, model, params = models
    for p, stream in zip(prompts, got):
        alone = Request(p.copy(), max_new_tokens=6)
        ServingEngine(model, params, n_slots=4, max_len=64).run([alone])
        assert alone.generated == stream


def test_past_the_capacity_a_slot_depends_on_its_neighbours(models):
    """12 slots decode 12 tokens a step with C = 8. Twelve copies of one
    prompt route alike, so each of their experts gets 12 pairs and slots 8
    to 11 are dropped to the shared expert: their logits differ from slot
    0's, in both packages alike (both decode the port engine's cache). At
    8 slots nothing is dropped. Past the capacity the engines' greedy
    streams are equal as well."""
    _, jnp, _, _, _ = jax_side()
    ref_model, ref_params, model, params = models
    prompt = np.random.default_rng(4).integers(0, 512, 6).astype(np.int32)
    out = {}
    for n_slots in (8, 12):
        assert ffn._capacity(n_slots, model.cfg) == 8
        eng = ServingEngine(model, params, n_slots=n_slots, max_len=64)
        for _ in range(n_slots):
            eng.submit(Request(prompt.copy(), max_new_tokens=4))
        eng._admit()
        toks = np.full((n_slots, 1), eng.active[0].generated[-1], np.int32)
        logits, _ = model.decode(params, torch.from_numpy(toks), eng.cache)
        ref_logits, _ = ref_model.decode(
            ref_params, jnp.asarray(toks),
            {k: jnp.asarray(v.numpy()) for k, v in eng.cache.items()})
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   **TOL)
        out[n_slots] = logits[:, 0].numpy()
    kept, full = out[8], out[12]
    np.testing.assert_allclose(kept, kept[:1].repeat(8, 0), **BLOCK_TOL)
    np.testing.assert_allclose(full[:8], kept, **BLOCK_TOL)
    np.testing.assert_allclose(full[8:], full[8:9].repeat(4, 0), **BLOCK_TOL)
    assert np.abs(full[8:] - full[:1]).max() > 1e-2
    rng = np.random.default_rng(5)
    prompts = [prompt] * 6 + [rng.integers(0, 512, 6).astype(np.int32)
                              for _ in range(6)]
    got, want = run_both(models, prompts, n_slots=12, max_new=4)
    assert got == want


# ---------------------------------------------------------------------------
# the weight bridge and the entry points
# ---------------------------------------------------------------------------
def test_weight_bridge_paths_and_dtypes():
    jax, _, _, _, transformer = jax_side()
    for shared in (1, 0):
        ref_cfg, cfg = configs(n_shared_experts=shared)
        flat = flat_params(transformer.build_model(ref_cfg).init(
            jax.random.key(0)))
        moe = {p for p in flat if p.startswith("layers/moe/")}
        want = {f"layers/moe/{n}" for n in ("router", "w_gate", "w_up",
                                            "w_down")}
        if shared:
            want |= {f"layers/moe/shared/{n}" for n in ("w_gate", "w_up",
                                                        "w_down")}
        assert moe == want
        bf16 = replace(cfg, param_dtype=torch.bfloat16)
        params = moe_params_from_flat(flat, bf16, "cpu")
        layer = params["layers"]
        assert layer.moe.router.dtype == torch.float32
        assert layer.moe.w_gate.dtype == torch.bfloat16
        assert layer.attn.wq.dtype == torch.bfloat16
        assert (layer.moe.shared is None) == (not shared)
        assert layer.moe.w_up.shape[0] == cfg.n_layers
        missing = dict(flat)
        del missing["layers/moe/router"]
        with pytest.raises(KeyError, match="missing"):
            moe_params_from_flat(missing, cfg, "cpu")
        with pytest.raises(KeyError, match="unexpected"):
            moe_params_from_flat({**flat, "layers/mlp/w_up": flat["embed"]},
                                 cfg, "cpu")
        with pytest.raises(KeyError):     # shared paths when there are none
            moe_params_from_flat(flat, replace(cfg, n_shared_experts=1 -
                                               shared), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_and_train_on_the_cpu(arch, tmp_path):
    result = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--requests", "6", "--max-new", "4"])
    assert result["requests"] == 6 and result["tokens_generated"] == 6 * 3
    done = train.main(["--arch", arch, "--reduced", "--device",
                       "cpu", "--steps", "2", "--seq", "16", "--batch", "2",
                       "--ckpt-every", "2", "--log-every", "0", "--cas",
                       str(tmp_path / "cas")])
    assert len(done["losses"]) == 2 and np.isfinite(done["losses"]).all()
    assert done["manifest"]


@pytest.mark.parametrize("entry", [serve, train])
def test_launch_without_a_card_raises(entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        entry.main(["--arch", "qwen2-moe-a2.7b", "--reduced"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_moe_block_on_the_card_is_deterministic():
    """Repeated calls bit-identical (no atomic adds), and equal to the CPU
    at 1e-5 in fp32, with tokens dropped."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(get_config("qwen2-moe-a2.7b").reduced(),
                  capacity_factor=0.5, moe_groups=2)
    p = ffn.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    want, want_aux = ffn.moe_block(p, x, cfg)
    dev = torch.device("cuda")
    pc = ffn.MoEParams(*(t.to(dev) for t in p[:4]),
                       ffn.MLPParams(*(t.to(dev) for t in p.shared)))
    got, aux = ffn.moe_block(pc, x.to(dev), cfg)
    for _ in range(3):
        again, again_aux = ffn.moe_block(pc, x.to(dev), cfg)
        assert torch.equal(again, got) and torch.equal(again_aux, aux)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **BLOCK_TOL)
    np.testing.assert_allclose(aux.item(), want_aux.item(), **BLOCK_TOL)
