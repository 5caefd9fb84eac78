"""The port's SSD scan, Mamba2 block, MambaLM and HybridLM against the
reference's.

On the CPU the seam runs the chunked plain version ``ref.ssd_scan_ref``;
it and the port's sequential ``ref.ssd_ref`` are held against the Pallas
kernel in interpret mode and the reference's sequential oracle over the
sweep of ``tests/test_kernels.py`` (y at 2e-4, the state at 1e-3), with an
initial state, and across chunk sizes. Blocks and models take the
reference's weights through ``repro_torch.weights`` and match at 2e-4.
The cases marked ``gpu`` hold the CUDA kernel against both plain versions
on the card and skip without one; JAX is imported only inside the tests
that need it, since the machine with the card has none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as sk
from repro_torch.models import mamba2
from repro_torch.models.transformer import (HybridLM, MambaLM, build_model,
                                            unstack)
from repro_torch.weights import hybrid_params_from_flat, ssm_params_from_flat

TOL = dict(rtol=2e-4, atol=2e-4)          # tests/test_kernels.py:144-149
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
# (B, T, H, P, N, Q): the sweep of tests/test_kernels.py:130-135
SWEEP = [(1, 32, 2, 16, 8, 8), (2, 64, 3, 16, 8, 16), (1, 128, 4, 32, 16, 32),
         (2, 64, 1, 64, 64, 64)]


def make_inputs(B, T, H, P, N, seed, h0=False):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((B, T, H, P), np.float32) * 0.5,
           -rng.uniform(0, 0.5, (B, T, H)).astype(np.float32),
           rng.standard_normal((B, T, N), np.float32) * 0.3,
           rng.standard_normal((B, T, N), np.float32) * 0.3]
    if h0:
        out.append(rng.standard_normal((B, H, N, P), np.float32))
    return out


def jax_side():
    """(jax, jax.numpy, the reference's oracles, its Pallas scan)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.ssd_scan import ssd_scan
    return jax, jnp, jref, ssd_scan


def flat_params(params) -> dict:
    """A JAX param pytree as a flat dict of numpy arrays keyed by path."""
    import jax
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in leaves}


def t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,T,H,P,N,Q", SWEEP)
def test_ssd_scan_sweep(B, T, H, P, N, Q):
    u, loga, Bm, Cm = make_inputs(B, T, H, P, N, seed=T * 10 + N)
    _, jnp, jref, pallas_scan = jax_side()
    a = [jnp.asarray(x) for x in (u, loga, Bm, Cm)]
    y_pl, s_pl = pallas_scan(*a, chunk=Q, interpret=True)
    y_or, s_or = jref.ssd_ref(*a)
    y, s = ops.ssd_scan(*map(t, (u, loga, Bm, Cm)), chunk=Q)
    y_seq, s_seq = ref.ssd_ref(*map(t, (u, loga, Bm, Cm)))
    assert y.dtype == torch.float32 and s.shape == (B, H, N, P)
    for got_y, got_s in ((y, s), (y_seq, s_seq)):
        for want_y, want_s in ((y_pl, s_pl), (y_or, s_or)):
            np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                       **TOL)
            np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                       **STATE_TOL)


@pytest.mark.parametrize("Q", [8, 32, 64])
def test_ssd_scan_initial_state(Q):
    """The chunked scan from h0 against the reference's sequential oracle
    from h0, the one path in the reference that takes an initial state."""
    u, loga, Bm, Cm, h0 = make_inputs(2, 64, 3, 16, 8, seed=Q, h0=True)
    _, jnp, jref, _ = jax_side()
    y_or, s_or = jref.ssd_ref(*(jnp.asarray(x) for x in (u, loga, Bm, Cm)),
                              h0=jnp.asarray(h0))
    for y, s in (ops.ssd_scan(*map(t, (u, loga, Bm, Cm)), chunk=Q, h0=t(h0)),
                 ref.ssd_ref(*map(t, (u, loga, Bm, Cm)), h0=t(h0))):
        np.testing.assert_allclose(y.numpy(), np.asarray(y_or), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_or), **STATE_TOL)


@pytest.mark.parametrize("Q,N,B", [(8, 8, 1), (16, 16, 2), (32, 8, 2)])
def test_ssd_chunk_size_invariance(Q, N, B):
    u, loga, Bm, Cm, h0 = make_inputs(B, 64, 2, 16, N, seed=Q + N, h0=True)
    args = [t(x) for x in (u, loga, Bm, Cm)]
    y1, s1 = ops.ssd_scan(*args, chunk=Q, h0=t(h0))
    y2, s2 = ops.ssd_scan(*args, chunk=64, h0=t(h0))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), **TOL)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), **TOL)


def test_cpu_tensors_never_reach_the_kernel():
    args = [t(x) for x in make_inputs(1, 16, 2, 16, 8, seed=1)]
    before = sk.ssd_scan_fwd.launches
    ops.ssd_scan(*args, chunk=8)
    assert sk.ssd_scan_fwd.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.ssd_scan(*args, chunk=8)


# ---------------------------------------------------------------------------
# the block and the models
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ssm_pair():
    """(reference MambaLM, its params, port MambaLM, bridged params)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as ref_get_config
    from repro.models.transformer import build_model as ref_build_model
    ref_model = ref_build_model(ref_get_config("mamba2-1.3b").reduced())
    ref_params = ref_model.init(jax.random.key(3))
    cfg = get_config("mamba2-1.3b").reduced()
    return (ref_model, ref_params, build_model(cfg, device="cpu"),
            ssm_params_from_flat(flat_params(ref_params), cfg, "cpu"))


@pytest.fixture(scope="module")
def hybrid_pair():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as ref_get_config
    from repro.models.transformer import build_model as ref_build_model
    ref_model = ref_build_model(ref_get_config("zamba2-2.7b").reduced())
    ref_params = ref_model.init(jax.random.key(4))
    cfg = get_config("zamba2-2.7b").reduced()
    return (ref_model, ref_params, build_model(cfg, device="cpu"),
            hybrid_params_from_flat(flat_params(ref_params), cfg, "cpu"))


@pytest.mark.parametrize("case", ["no_state", "carried_state", "decode"])
def test_mamba2_block_matches_reference(ssm_pair, case):
    """Layer 0's block alone: from no state over 32 tokens (two chunks),
    from a carried state over 16, and one decode step from it."""
    import jax.numpy as jnp
    from repro.models import mamba2 as ref_mamba2
    ref_model, ref_params, model, params = ssm_pair
    cfg = model.cfg
    rng = np.random.default_rng(5)
    T = {"no_state": 32, "carried_state": 16, "decode": 1}[case]
    x = rng.standard_normal((2, T, cfg.d_model), np.float32)
    ref_p = ref_mamba2.Mamba2Params(*(leaf[0] for leaf in
                                      ref_params["layers"].mamba))
    p = unstack(params["layers"].mamba)[0]
    ref_state = state = None
    if case != "no_state":
        tail = rng.standard_normal((2, cfg.conv_kernel - 1,
                                    mamba2.conv_channels(cfg)), np.float32)
        ssm = rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_state,
                                   cfg.ssm_head_dim), np.float32)
        ref_state = ref_mamba2.MambaState(jnp.asarray(tail), jnp.asarray(ssm))
        state = mamba2.MambaState(t(tail), t(ssm))
    want, want_st = ref_mamba2.mamba2_block(
        ref_p, jnp.asarray(x), cfg=ref_model.cfg, state=ref_state,
        return_state=case != "no_state")
    got, got_st = mamba2.mamba2_block(p, t(x), cfg, state=state,
                                      return_state=case != "no_state")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if case == "no_state":
        assert got_st is None and want_st is None
    else:
        for g, w in zip(got_st, want_st):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def lm_pair(request, family):
    return request.getfixturevalue({"ssm": "ssm_pair",
                                    "hybrid": "hybrid_pair"}[family])


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_loss_matches_reference(request, family):
    import jax.numpy as jnp
    ref_model, ref_params, model, params = lm_pair(request, family)
    rng = np.random.default_rng(6)
    batch = {k: rng.integers(0, 512, (2, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    want = ref_model.loss_fn(ref_params, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    got = model.loss_fn(params, {k: t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), **TOL)


def assert_cache_close(cache, ref_cache):
    for name in cache:
        got, want = cache[name], ref_cache[name]
        if name == "state":
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        elif name == "index":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("T", [12, 32])
@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_prefill_then_decode_matches_reference(request, family, T):
    """Prefill of one chunk (12 tokens) or two (32; the reduced chunk is
    16), then three decode steps: logits and every cache leaf."""
    import jax.numpy as jnp
    ref_model, ref_params, model, params = lm_pair(request, family)
    rng = np.random.default_rng(T)
    tokens = rng.integers(0, 512, (2, T)).astype(np.int32)
    ref_logits, ref_cache = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(tokens)},
        ref_model.init_cache(2, 48))
    logits, cache = model.prefill(params, {"tokens": t(tokens)},
                                  model.init_cache(2, 48))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    assert_cache_close(cache, ref_cache)
    for _ in range(3):
        step = rng.integers(0, 512, (2, 1)).astype(np.int32)
        ref_logits, ref_cache = ref_model.decode(ref_params,
                                                 jnp.asarray(step), ref_cache)
        logits, cache = model.decode(params, t(step), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   **TOL)
        assert_cache_close(cache, ref_cache)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_decode_matches_chunked_prefill(family):
    """Token-by-token recurrence == the chunked scan, on the port alone
    (``test_models_smoke.py:102``: chunk 4, 8 tokens, 2e-3)."""
    arch = {"ssm": "mamba2-1.3b", "hybrid": "zamba2-2.7b"}[family]
    model = build_model(get_config(arch).reduced(ssm_chunk=4), device="cpu")
    params = model.init(torch.Generator().manual_seed(7))
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, model.cfg.vocab_size, (1, 8)).astype(np.int32))
    logits_pre, _ = model.prefill(params, {"tokens": toks},
                                  model.init_cache(1, 8))
    cache = model.init_cache(1, 8)
    for i in range(8):
        logits_inc, cache = model.decode(params, toks[:, i:i + 1], cache)
    np.testing.assert_allclose(logits_inc[:, 0].numpy(),
                               logits_pre[:, 0].numpy(), rtol=2e-3, atol=2e-3)


def test_ragged_prompt_past_the_chunk_raises_like_the_reference(ssm_pair):
    """T > ssm_chunk with T % ssm_chunk != 0: the reference asserts
    (``repro/models/mamba2.py:84``), the port raises ValueError."""
    import jax.numpy as jnp
    ref_model, ref_params, model, params = ssm_pair
    tokens = np.zeros((1, 20), np.int32)
    with pytest.raises(AssertionError, match="not divisible"):
        ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)},
                          ref_model.init_cache(1, 32))
    with pytest.raises(ValueError, match="not divisible"):
        model.prefill(params, {"tokens": t(tokens)}, model.init_cache(1, 32))


@pytest.mark.parametrize("bridge,pair", [
    (ssm_params_from_flat, "ssm_pair"), (hybrid_params_from_flat,
                                         "hybrid_pair")])
def test_weight_bridges_raise_on_wrong_paths(request, bridge, pair):
    ref_model, ref_params, model, _ = request.getfixturevalue(pair)
    flat = flat_params(ref_params)
    missing = dict(flat)
    del missing["layers/mamba/A_log"]
    with pytest.raises(KeyError, match="A_log"):
        bridge(missing, model.cfg, "cpu")
    with pytest.raises(KeyError, match="extra"):
        bridge({**flat, "extra": flat["embed"]}, model.cfg, "cpu")
    fewer = {k: v[:1] if k.startswith("layers/") else v
             for k, v in flat.items()}
    with pytest.raises(ValueError, match="leading shape"):
        bridge(fewer, model.cfg, "cpu")
    # the dense bridge refuses an SSM param dict
    from repro_torch.weights import dense_params_from_flat
    with pytest.raises(KeyError, match="missing"):
        dense_params_from_flat(flat, model.cfg, "cpu")


# (B, T, H, P, N, Q): the served prefill shapes of mamba2-1.3b and
# zamba2-2.7b, a single chunk of 37 tokens, an initial state over 3 chunks,
# the sweep and an N that is no power of two
PLAN_CASES = [(1, 2048, 64, 64, 128, 256), (1, 2048, 80, 64, 64, 256),
              (8, 37, 64, 64, 128, 37), (2, 768, 64, 64, 128, 256), *SWEEP,
              (1, 96, 2, 16, 100, 32)]


@pytest.mark.parametrize("B,T,H,P,N,Q", PLAN_CASES)
def test_ssd_plan_covers_every_chunk_head_and_slice_once(B, T, H, P, N, Q):
    """Passes 2 and 4 take every (chunk, head, b, P slice) exactly once;
    pass 1 every 64 x 64 tile of each (chunk, b) panel; pass 3 every (n, p)
    of each (head, b)."""
    plan = sk.ssd_plan(B, T, H, P, N, Q)
    nc, ps = plan["chunks"], plan["p_slice"]
    assert nc == T // Q and ps in (16, 32, 64) and P % ps == 0
    want = {(c, h, b, j) for c in range(nc) for h in range(H)
            for b in range(B) for j in range(P // ps)}
    for name in ("summaries", "output"):
        x, y, z = plan["grids"][name]
        # block (x, y, z) is (P slice, head, b * chunks + chunk)
        seen = [(k % nc, j, k // nc, i) for i in range(x)
                for j in range(y) for k in range(z)]
        assert len(seen) == len(want) and set(seen) == want
    assert plan["grids"]["cb"] == ((sk.MAX_CHUNK // 64) ** 2, B * nc, 1)
    x, y, z = plan["grids"]["states"]
    assert (x - 1) * 256 < N * P <= x * 256 and (y, z) == (H, B)


@pytest.mark.parametrize("B,T,H,P,N,Q", PLAN_CASES)
def test_ssd_plan_workspace_shapes(B, T, H, P, N, Q):
    """C B^T as a (256, 256) panel a chunk, C^T with N rounded up to 32, 64
    or 128 rows, the chunk states (B, nc, H, N, P) and decays (B, nc, H);
    each part a whole number of 16-byte vectors, so the next starts
    aligned."""
    plan = sk.ssd_plan(B, T, H, P, N, Q)
    nc, rows = T // Q, plan["state_rows"]
    assert rows in (32, 64, 128) and N <= rows and (rows == 32 or N > rows // 2)
    assert plan["workspace"] == {"cbt": (B, nc, 256, 256),
                                 "ct": (B, nc, rows, 256),
                                 "states": (B, nc, H, N, P),
                                 "decay": (B, nc, H)}
    for name in ("cbt", "ct", "states"):
        assert np.prod(plan["workspace"][name]) % 4 == 0


@pytest.mark.parametrize("T,Q,chunks,blocks", [(2048, 256, 8, 512),
                                               (37, 37, 1, 64),
                                               (256, 256, 1, 64),
                                               (512, 64, 8, 512)])
def test_ssd_plan_single_and_multi_chunk(T, Q, chunks, blocks):
    """At mamba2's widths (H 64, P 64, N 128, B 1): a prompt under one
    chunk is one chunk of its own length; 8 chunks give 512 blocks to
    passes 2 and 4 where the single-pass kernel had 128; C B^T takes 2 MiB
    and the chunk states 16 MiB at T 2048."""
    plan = sk.ssd_plan(1, T, 64, 64, 128, Q)
    assert plan["chunks"] == chunks and plan["p_slice"] == 64
    for name in ("summaries", "output"):
        assert np.prod(plan["grids"][name]) == blocks
    nbytes = {k: 4 * int(np.prod(v)) for k, v in plan["workspace"].items()}
    assert nbytes["cbt"] == chunks * 2 ** 18
    assert nbytes["states"] == chunks * 2 ** 21


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("B,T,H,P,N,Q", SWEEP)
def test_plain_chunk_states_match_the_sequential_recurrence(B, T, H, P, N,
                                                            Q, h0):
    """The state entering each chunk (what pass 3 writes) from the plain
    version, against the sequential recurrence run over the tokens before
    the chunk, from the same h0; the last against its final state."""
    arrays = make_inputs(B, T, H, P, N, seed=T + N + int(h0), h0=h0)
    u, loga, Bm, Cm = map(t, arrays[:4])
    init = t(arrays[4]) if h0 else None
    h_in, final = ref.ssd_chunk_states(u, loga, Bm, chunk=Q, h0=init)
    assert h_in.shape == (B, T // Q, H, N, P)
    for c in range(T // Q + 1):
        if c == 0:
            want = init if h0 else torch.zeros((B, H, N, P))
        else:
            n = c * Q
            _, want = ref.ssd_ref(u[:, :n], loga[:, :n], Bm[:, :n],
                                  Cm[:, :n], h0=init)
        got = h_in[:, c] if c < T // Q else final
        np.testing.assert_allclose(got.numpy(), want.numpy(), **STATE_TOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,P,N,Q,h0", [
    *(s + (False,) for s in SWEEP), (1, 512, 4, 64, 128, 256, True),
    (8, 37, 3, 64, 64, 37, True), (2, 256, 5, 32, 16, 64, True),
    (1, 96, 2, 16, 100, 32, True)])
def test_kernel_matches_plain_on_card(cuda, B, T, H, P, N, Q, h0):
    arrays = make_inputs(B, T, H, P, N, seed=T + N, h0=h0)
    args = [t(a, cuda) for a in arrays[:4]]
    init = t(arrays[4], cuda) if h0 else None
    before = sk.ssd_scan_fwd.launches
    y, s = ops.ssd_scan(*args, chunk=Q, h0=init)
    torch.cuda.synchronize()
    assert sk.ssd_scan_fwd.launches == before + 1
    for want_y, want_s in (ref.ssd_scan_ref(*args, chunk=Q, h0=init),
                           ref.ssd_ref(*args, h0=init)):
        np.testing.assert_allclose(y.cpu().numpy(), want_y.cpu().numpy(),
                                   **TOL)
        np.testing.assert_allclose(s.cpu().numpy(), want_s.cpu().numpy(),
                                   **STATE_TOL)


@pytest.mark.gpu
def test_backward_through_the_kernel_raises(cuda):
    args = [t(a, cuda) for a in make_inputs(1, 32, 2, 16, 8, seed=2)]
    u = args[0].requires_grad_(True)
    y, _ = ops.ssd_scan(u, *args[1:], chunk=16)
    with pytest.raises(NotImplementedError, match="SSM training slice"):
        y.sum().backward()
    with pytest.raises(ValueError, match="fp32"):
        sk.ssd_scan(*(a.double() for a in args), chunk=16)
    with pytest.raises(ValueError, match="chunk"):
        sk.ssd_scan(*args, chunk=12)


@pytest.mark.gpu
@pytest.mark.parametrize("cls", [MambaLM, HybridLM])
def test_model_kernel_against_plain_on_card(cuda, cls):
    """Reduced fp32 prefill with the scan kernel against the plain scan:
    logits and states."""
    arch = "mamba2-1.3b" if cls is MambaLM else "zamba2-2.7b"
    cfg = get_config(arch).reduced()
    model = cls(cfg, device=cuda)
    plain = cls(cfg, device=cuda, ssd_scan=ref.ssd_scan_ref)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tokens = t(np.random.default_rng(0).integers(0, 512, (1, 48))
               .astype(np.int32), cuda)
    before = sk.ssd_scan_fwd.launches
    got, cache = model.prefill(params, {"tokens": tokens},
                               model.init_cache(1, 64))
    torch.cuda.synchronize()
    assert sk.ssd_scan_fwd.launches - before == cfg.n_layers
    want, want_cache = plain.prefill(params, {"tokens": tokens},
                                     plain.init_cache(1, 64))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(cache["state"].ssm.cpu().numpy(),
                               want_cache["state"].ssm.cpu().numpy(),
                               rtol=1e-3, atol=1e-3)


# chip_smoke.py's SSD_SHAPES: the served prefill shapes of mamba2-1.3b and
# zamba2-2.7b, a single chunk of 37 tokens at B 8, h0 over 3 chunks, the
# sweep (B, T, H, P, N, Q, h0)
SMOKE_SHAPES = [(1, 2048, 64, 64, 128, 256, False),
                (1, 2048, 80, 64, 64, 256, False),
                (8, 37, 64, 64, 128, 37, False),
                (2, 768, 64, 64, 128, 256, True),
                *(s + (False,) for s in SWEEP)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,P,N,Q,h0", SMOKE_SHAPES)
def test_passes_match_both_plain_versions_at_smoke_shapes(cuda, B, T, H, P,
                                                          N, Q, h0):
    arrays = make_inputs(B, T, H, P, N, seed=T + H + N, h0=h0)
    args = [t(a, cuda) for a in arrays[:4]]
    init = t(arrays[4], cuda) if h0 else None
    y, s = sk.ssd_scan(*args, chunk=Q, h0=init)
    torch.cuda.synchronize()
    for want_y, want_s in (ref.ssd_scan_ref(*args, chunk=Q, h0=init),
                           ref.ssd_ref(*args, h0=init)):
        np.testing.assert_allclose(y.cpu().numpy(), want_y.cpu().numpy(),
                                   **TOL)
        np.testing.assert_allclose(s.cpu().numpy(), want_s.cpu().numpy(),
                                   **STATE_TOL)


@pytest.mark.gpu
def test_passes_bit_identical_and_under_graph_replay(cuda):
    """Three calls give the same bits, and so do replays of a captured CUDA
    graph, also after new inputs are copied into the captured tensors: the
    cached workspace is safe to reuse."""
    arrays = make_inputs(1, 768, 8, 64, 128, seed=5, h0=True)
    args = [t(a, cuda) for a in arrays[:4]]
    init = t(arrays[4], cuda)
    first = sk.ssd_scan(*args, chunk=256, h0=init)
    for _ in range(2):
        again = sk.ssd_scan(*args, chunk=256, h0=init)
        assert all(torch.equal(a, b) for a, b in zip(again, first))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sk.ssd_scan(*args, chunk=256, h0=init)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = sk.ssd_scan(*args, chunk=256, h0=init)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(static, first))
    other = make_inputs(1, 768, 8, 64, 128, seed=6, h0=True)
    for dst, src in zip((*args, init), other):
        dst.copy_(t(src, cuda))
    graph.replay()
    eager = sk.ssd_scan(*args, chunk=256, h0=init)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(static, eager))
    want_y, want_s = ref.ssd_ref(*args, h0=init)
    np.testing.assert_allclose(static[0].cpu().numpy(),
                               want_y.cpu().numpy(), **TOL)
    np.testing.assert_allclose(static[1].cpu().numpy(),
                               want_s.cpu().numpy(), **STATE_TOL)
