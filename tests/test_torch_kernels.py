"""The port's decode attention against the reference's.

On the CPU the seam runs the plain version, which is held against the
Pallas kernel in interpret mode and against the reference's jnp oracle over
the reference's own sweep (``tests/test_kernels.py``), at its tolerances.
The cases marked ``gpu`` hold the CUDA kernel against the plain version on
the card and skip without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import ops, ref

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SWEEP = [(1, 64, 4, 4, 32, 32), (3, 128, 8, 2, 32, 32),
         (2, 256, 16, 4, 64, 128), (4, 64, 4, 1, 16, 16)]
# head dims that are not a multiple of 32: zamba2 (80), phi3-mini (96),
# kimi-k2 (112)
HEAD_DIM_CASES = [(2, 96, 4, 4, 80, 32), (3, 64, 8, 2, 96, 16),
                  (2, 128, 8, 1, 112, 64)]


def make_inputs(B, S, Hq, Hkv, hd, seed, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, hd), np.float32)
    k = rng.standard_normal((B, S, Hkv, hd), np.float32)
    v = rng.standard_normal((B, S, Hkv, hd), np.float32)
    if lengths is None:
        lengths = rng.integers(1, S + 1, B)
    return q, k, v, np.asarray(lengths, np.int32)


def port(q, k, v, lengths, dtype, device="cpu"):
    t = lambda a: torch.from_numpy(a).to(device=device,
                                         dtype=getattr(torch, dtype))
    out = ops.decode_attention(t(q), t(k), t(v),
                               torch.from_numpy(lengths).to(device))
    assert out.dtype == getattr(torch, dtype)
    return out.float().cpu().numpy()


def reference(q, k, v, lengths, dtype, bk=None):
    """(Pallas kernel in interpret mode, jnp oracle) on the same inputs."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import decode_attention
    a = lambda x: jnp.asarray(x).astype(getattr(jnp, dtype))
    args = (a(q), a(k), a(v), jnp.asarray(lengths))
    kw = {} if bk is None else {"blk_k": bk}
    pallas = decode_attention(*args, interpret=True, **kw)
    oracle = jref.decode_attention_ref(*args)
    return (np.asarray(pallas, np.float32), np.asarray(oracle, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,bk", SWEEP)
def test_decode_attention_sweep(B, S, Hq, Hkv, hd, bk, dtype):
    q, k, v, lengths = make_inputs(B, S, Hq, Hkv, hd, seed=B * 1000 + S)
    out = port(q, k, v, lengths, dtype)
    pallas, oracle = reference(q, k, v, lengths, dtype, bk)
    np.testing.assert_allclose(out, pallas, **TOL[dtype])
    np.testing.assert_allclose(out, oracle, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,bk", HEAD_DIM_CASES)
def test_decode_attention_head_dims(B, S, Hq, Hkv, hd, bk, dtype):
    q, k, v, lengths = make_inputs(B, S, Hq, Hkv, hd, seed=hd * 10 + S)
    out = port(q, k, v, lengths, dtype)
    pallas, oracle = reference(q, k, v, lengths, dtype, bk)
    np.testing.assert_allclose(out, pallas, **TOL[dtype])
    np.testing.assert_allclose(out, oracle, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_edge_lengths(dtype):
    """Ragged lengths, ``length > S`` read as S, and ``length == 0``
    giving zeros as the Pallas kernel does. The reference's jnp oracle
    gives the mean of V at ``length == 0`` instead: pinned here."""
    S = 64
    lengths = [0, 1, S, S + 9, 17]
    q, k, v, lengths = make_inputs(5, S, 6, 2, 32, seed=7, lengths=lengths)
    out = port(q, k, v, lengths, dtype)
    pallas, oracle = reference(q, k, v, lengths, dtype, bk=16)
    np.testing.assert_allclose(out, pallas, **TOL[dtype])
    assert np.all(out[0] == 0.0)
    np.testing.assert_allclose(out[1:], oracle[1:], **TOL[dtype])
    np.testing.assert_allclose(out[3], port(q, k, v, np.full(5, S, np.int32),
                                            dtype)[3])
    mean_v = np.repeat(v[0].mean(axis=0), 3, axis=0)       # (Hq, hd)
    np.testing.assert_allclose(oracle[0], mean_v, **TOL[dtype])


def test_cpu_tensors_never_reach_the_kernel():
    q, k, v, lengths = make_inputs(2, 32, 4, 2, 32, seed=1)
    t = torch.from_numpy
    before = dk.decode_attention.launches
    ops.decode_attention(t(q), t(k), t(v), t(lengths))
    assert dk.decode_attention.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        dk.decode_attention(t(q), t(k), t(v), t(lengths))


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd", [
    (8, 2048, 9, 3, 64), (8, 2048, 32, 8, 64), (3, 100, 8, 2, 32),
    (2, 300, 8, 1, 128), (1, 64, 4, 4, 32), (8, 2048, 32, 32, 80),
    (4, 700, 32, 32, 96), (3, 500, 64, 8, 112), (8, 448, 6, 6, 64),
    (8, 2048, 56, 8, 128)])
def test_kernel_matches_plain_on_card(cuda, B, S, Hq, Hkv, hd, dtype):
    lengths = np.arange(B) * (S // max(B - 1, 1))
    lengths[-1] = S + 3
    q, k, v, lengths = make_inputs(B, S, Hq, Hkv, hd, seed=S + hd,
                                   lengths=lengths)
    before = dk.decode_attention.launches
    got = port(q, k, v, lengths, dtype, device=cuda)
    torch.cuda.synchronize()
    assert dk.decode_attention.launches == before + 1
    want = port(q, k, v, lengths, dtype, device="cpu")
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.gpu
def test_kernel_reads_cache_slices_through_strides(cuda):
    """A layer's slot slice of the (L, B, S, Hkv, hd) cache, read without a
    copy, against the plain version on a contiguous copy."""
    L, B, S, Hkv, hd, Hq = 3, 4, 96, 2, 64, 6
    rng = np.random.default_rng(3)
    cache = torch.from_numpy(rng.standard_normal(
        (2, L, B, S, Hkv, hd), np.float32)).to(cuda, torch.bfloat16)
    k, v = cache[0][1, 1:3], cache[1][1, 1:3]              # (2, S, Hkv, hd)
    q = torch.from_numpy(rng.standard_normal((2, Hq, hd), np.float32)
                         ).to(cuda, torch.bfloat16)
    lengths = torch.tensor([S, 37], dtype=torch.int32, device=cuda)
    got = dk.decode_attention(q, k, v, lengths)
    want = ref.decode_attention_ref(q, k.contiguous(), v.contiguous(),
                                    lengths)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu(), want.float().cpu(),
                               **TOL["bfloat16"])
    with pytest.raises(ValueError, match="head_dim"):
        dk.decode_attention(q[..., :48], k[..., :48], v[..., :48], lengths)


def cache_slices(cuda, dtype, B, S, Hq, Hkv, hd, seed):
    """q and layer 1 of a (2, L, B, S, Hkv, hd) cache: k and v read through
    the cache's strides, as a decode step reads them."""
    rng = np.random.default_rng(seed)
    cache = torch.from_numpy(rng.standard_normal(
        (2, 3, B, S, Hkv, hd), np.float32)).to(cuda, dtype)
    q = torch.from_numpy(rng.standard_normal((B, Hq, hd), np.float32)
                         ).to(cuda, dtype)
    return q, cache[0][1], cache[1][1]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,hd", [(9, 3, 64), (32, 32, 80)])
def test_kernel_at_split_boundaries_on_card(cuda, Hq, Hkv, hd, dtype):
    """Lengths at the edges of a 64-key tile and of a split (the plan's
    tiles per split x 64, plus and minus one), 0, 1, S and past S, through
    the cache's strides, against the plain version on contiguous copies."""
    S = 2048
    B = 12
    splits, tps = dk.split_plan(B, Hkv, S, dk._sm_count(cuda))
    edge = tps * dk.TILE
    lengths = torch.tensor([63, 64, 65, edge - 1, edge, edge + 1, 0, 1, S,
                            S + 3, 2 * edge + 7, S - 1][:B],
                           dtype=torch.int32, device=cuda)
    q, k, v = cache_slices(cuda, getattr(torch, dtype), B, S, Hq, Hkv, hd,
                           seed=hd)
    got = dk.decode_attention(q, k, v, lengths)
    want = ref.decode_attention_ref(q, k.contiguous(), v.contiguous(),
                                    lengths)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu(), want.float().cpu(),
                               **TOL[dtype])
    assert splits > 1 or Hkv * B >= 2 * dk._sm_count(cuda)
    assert torch.all(got[6] == 0)


@pytest.mark.gpu
def test_kernel_bit_identical_and_under_graph_replay(cuda):
    """Three calls give the same bits; so do replays of a captured CUDA
    graph, also after the lengths change between replays, which holds only
    if every call leaves the merge counters at zero."""
    B, S, Hq, Hkv, hd = 8, 2048, 9, 3, 64
    q, k, v = cache_slices(cuda, torch.bfloat16, B, S, Hq, Hkv, hd, seed=1)
    lengths = torch.tensor([0, 1, 64, 65, 1305, S, S + 5, 979],
                           dtype=torch.int32, device=cuda)
    first = dk.decode_attention(q, k, v, lengths)
    for _ in range(2):
        assert torch.equal(dk.decode_attention(q, k, v, lengths), first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dk.decode_attention(q, k, v, lengths)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = dk.decode_attention(q, k, v, lengths)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static_out, first)
    lengths.copy_(torch.tensor([7, 2048, 3, 640, 0, 129, 1, 2000],
                               dtype=torch.int32))
    graph.replay()
    eager = dk.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    assert torch.equal(static_out, eager)
    want = ref.decode_attention_ref(q, k.contiguous(), v.contiguous(),
                                    lengths)
    np.testing.assert_allclose(static_out.float().cpu(),
                               want.float().cpu(), **TOL["bfloat16"])
