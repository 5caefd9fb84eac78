"""What surrounds the split-KV decode kernel, on the CPU.

``ref.decode_attention_split_ref`` computes the kernel's arithmetic: a
partial (m, l, acc) per split of the sequence, merged in split order. It is
held against the Pallas kernel in interpret mode and the reference's jnp
oracle over the reference's sweep and the head-dim cases, for 1 to 12
splits (splits wholly past a length among them) and ``length == 0``, at the
tolerances of ``tests/test_torch_kernels.py`` (fp32 2e-5, bf16 2e-2).
``split_plan``, the wrapper's choice of splits, is checked for covering the
sequence once and filling the card.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import ref

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# the reference's sweep (tests/test_kernels.py) and the head dims of zamba2
# (80), phi3-mini (96) and kimi-k2 (112): (B, S, Hq, Hkv, hd, Pallas blk_k)
CASES = [(1, 64, 4, 4, 32, 32), (3, 128, 8, 2, 32, 32),
         (2, 256, 16, 4, 64, 128), (4, 64, 4, 1, 16, 16),
         (2, 96, 4, 4, 80, 32), (3, 64, 8, 2, 96, 16),
         (2, 128, 8, 1, 112, 64)]
EDGE_LENGTHS = [0, 1, 64, 64 + 9, 17]       # S = 64: 0, 1, S, past S


def make_inputs(B, S, Hq, Hkv, hd, seed, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, hd), np.float32)
    k = rng.standard_normal((B, S, Hkv, hd), np.float32)
    v = rng.standard_normal((B, S, Hkv, hd), np.float32)
    if lengths is None:
        lengths = rng.integers(1, S + 1, B)
    return q, k, v, np.asarray(lengths, np.int32)


@functools.lru_cache(maxsize=None)
def reference(case, dtype, edge=False):
    """(inputs, Pallas kernel in interpret mode, jnp oracle), once a case."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import decode_attention
    B, S, Hq, Hkv, hd, bk = case
    inputs = make_inputs(B, S, Hq, Hkv, hd, seed=hd * 10 + S + B,
                         lengths=EDGE_LENGTHS if edge else None)
    a = lambda x: jnp.asarray(x).astype(getattr(jnp, dtype))
    q, k, v, lengths = inputs
    args = (a(q), a(k), a(v), jnp.asarray(lengths))
    pallas = decode_attention(*args, blk_k=bk, interpret=True)
    oracle = jref.decode_attention_ref(*args)
    return inputs, np.asarray(pallas, np.float32), \
        np.asarray(oracle, np.float32)


def split_port(q, k, v, lengths, dtype, splits, tile):
    t = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))
    out = ref.decode_attention_split_ref(t(q), t(k), t(v),
                                         torch.from_numpy(lengths), splits,
                                         tile)
    assert out.dtype == getattr(torch, dtype)
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 3, 12])
@pytest.mark.parametrize("case", CASES)
def test_split_ref_matches_pallas_and_oracle(case, splits, dtype):
    (q, k, v, lengths), pallas, oracle = reference(case, dtype)
    S = case[1]
    out = split_port(q, k, v, lengths, dtype, splits, -(-S // splits))
    np.testing.assert_allclose(out, pallas, **TOL[dtype])
    np.testing.assert_allclose(out, oracle, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", range(1, 13))
def test_split_ref_edge_lengths(splits, dtype):
    """Lengths 0, 1, S, past S and 17 over 1 to 12 splits of 16 keys (S
    64): splits past S and past a length add nothing, and ``length == 0``
    gives exact zeros as the Pallas kernel does (the jnp oracle gives the
    mean of V there, so row 0 is held to Pallas only)."""
    case = (5, 64, 6, 2, 32, 16)
    (q, k, v, lengths), pallas, oracle = reference(case, dtype, edge=True)
    out = split_port(q, k, v, lengths, dtype, splits, 16 * -(-4 // splits))
    np.testing.assert_allclose(out, pallas, **TOL[dtype])
    np.testing.assert_allclose(out[1:], oracle[1:], **TOL[dtype])
    assert np.all(out[0] == 0.0)


@pytest.mark.parametrize("B,Hkv,Hq,hd", [(8, 3, 9, 64), (8, 8, 32, 64),
                                         (8, 32, 32, 80)])
def test_split_ref_at_the_plan_of_served_shapes(B, Hkv, Hq, hd):
    """At the decode shapes of smollm-135m, llama-3.2-1b and zamba2-2.7b
    (8 slots of 2048), the plan's splits merged as the kernel merges them
    equal the plain version in fp32."""
    S = 2048
    lengths = [0, 1, 63, 64, 65, S, S + 5, 1305][:B]
    q, k, v, lengths = make_inputs(B, S, Hq, Hkv, hd, seed=hd + Hkv,
                                   lengths=lengths)
    splits, tps = dk.split_plan(B, Hkv, S, n_sm=132)
    t = torch.from_numpy
    want = ref.decode_attention_ref(t(q), t(k), t(v), t(lengths))
    got = ref.decode_attention_split_ref(t(q), t(k), t(v), t(lengths),
                                         splits, tps * dk.TILE)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL["float32"])


def test_split_ref_rejects_splits_short_of_the_sequence():
    q, k, v, lengths = make_inputs(2, 64, 4, 2, 32, seed=5)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="do not cover"):
        ref.decode_attention_split_ref(t(q), t(k), t(v), t(lengths), 3, 16)


# (B, Hkv, S, n_sm): the served shapes on an H100 (132 SMs), small and
# ragged sequences, batches that fill the card alone, another SM count
PLANS = [(8, 3, 2048, 132), (8, 8, 2048, 132), (8, 32, 2048, 132),
         (1, 1, 64, 132), (1, 2, 100, 132), (2, 3, 2053, 132),
         (4, 1, 5000, 132), (64, 8, 4096, 132), (2, 2, 640, 114),
         (3, 1, 11 * 64, 132), (1, 8, 1, 132), (16, 16, 8192, 132),
         (1, 1, 40000, 132)]


@pytest.mark.parametrize("B,Hkv,S,n_sm", PLANS)
def test_split_plan_covers_the_sequence_once(B, Hkv, S, n_sm):
    splits, tps = dk.split_plan(B, Hkv, S, n_sm)
    n_tiles = -(-S // dk.TILE)
    assert splits >= 1 and tps >= 1
    # split s takes tiles [s * tps, (s + 1) * tps): the ranges tile [0, S)
    # with no gap or overlap, and none starts at or past S
    assert (splits - 1) * tps < n_tiles <= splits * tps
    starts = [s * tps * dk.TILE for s in range(splits)]
    ends = [min((s + 1) * tps * dk.TILE, S) for s in range(splits)]
    assert starts[0] == 0 and ends[-1] == S
    assert all(e == s for e, s in zip(ends[:-1], starts[1:]))
    assert all(s < S for s in starts)
    assert splits <= dk.MAX_SPLITS
    if splits < dk.MAX_SPLITS // 2:
        assert tps & (tps - 1) == 0          # a power of two
    want = -(-2 * n_sm // (B * Hkv))         # splits for 2 blocks an SM
    if n_tiles >= want and want <= dk.MAX_SPLITS:
        assert B * Hkv * splits >= 2 * n_sm
    if B * Hkv >= 2 * n_sm:
        assert splits == 1


def test_split_plan_at_the_served_shapes():
    """smollm-135m's 24 (slot, KV head) pairs take 16 splits of 2 tiles,
    llama-3.2-1b's 64 take 8 of 4 (6 tiles would do for two blocks an SM;
    tiles per split are a power of two), zamba2-2.7b's 256 take 2 of 16,
    and one split once the pairs fill 128 SMs twice."""
    assert dk.split_plan(8, 3, 2048, 132) == (16, 2)
    assert dk.split_plan(8, 8, 2048, 132) == (8, 4)
    assert dk.split_plan(8, 32, 2048, 132) == (2, 16)
    assert dk.split_plan(8, 32, 2048, 128) == (1, 32)
