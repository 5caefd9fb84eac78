"""The port's flash attention against the reference's.

On the CPU the seam runs the plain version (``chunked_attention`` from 1024
query positions on), which is held against the Pallas kernel in interpret
mode and the reference's jnp oracle, forward at the reference's tolerances
(fp32 2e-5, bf16 2e-2), and against ``jax.grad`` of the oracle for the
gradients. The cases marked ``gpu`` hold the CUDA kernels, forward and
backward, against the plain version on the card and skip without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops, ref

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# (B, T, S, Hq, Hkv, hd, causal): GQA, T != S both ways, full attention
CASES = [(2, 64, 64, 4, 2, 32, True), (1, 128, 128, 8, 2, 64, True),
         (2, 32, 64, 4, 1, 32, True), (2, 64, 32, 6, 3, 64, True),
         (2, 64, 96, 6, 3, 32, False), (1, 32, 32, 2, 2, 128, False),
         # head dims of zamba2 (80), phi3-mini (96) and kimi-k2 (112)
         (1, 64, 64, 4, 4, 80, True), (2, 64, 96, 4, 2, 96, False),
         (1, 64, 64, 8, 1, 112, True)]


def make_inputs(B, T, S, Hq, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, Hq, hd), np.float32),
            rng.standard_normal((B, S, Hkv, hd), np.float32),
            rng.standard_normal((B, S, Hkv, hd), np.float32),
            rng.standard_normal((B, T, Hq, hd), np.float32))


def jax_side():
    """(jax, jax.numpy, the reference's oracles, its Pallas flash), imported
    here: the machine with the card runs the ``gpu`` cases without JAX."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention
    return jax, jnp, jref, flash_attention


def to_torch(a, dtype="float32", device="cpu", grad=False):
    t = torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))
    return t.requires_grad_(grad)


def port_grads(q, k, v, dout, causal, dtype="float32", device="cpu",
               fn=ops.flash_attention):
    tq, tk, tv = (to_torch(a, dtype, device, grad=True) for a in (q, k, v))
    out = fn(tq, tk, tv, causal=causal)
    out.backward(to_torch(dout, dtype, device))
    return [t.float().cpu().numpy()
            for t in (out.detach(), tq.grad, tk.grad, tv.grad)]


def jax_grads(q, k, v, dout, causal):
    jax, jnp, jref, _ = jax_side()

    def f(q, k, v):
        return jnp.sum(jref.flash_attention_ref(q, k, v, causal=causal)
                       * dout)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,S,Hq,Hkv,hd,causal", CASES)
def test_flash_forward_matches_pallas_and_oracle(B, T, S, Hq, Hkv, hd,
                                                 causal, dtype):
    q, k, v, _ = make_inputs(B, T, S, Hq, Hkv, hd, seed=T * 7 + S + hd)
    out = ops.flash_attention(*(to_torch(a, dtype) for a in (q, k, v)),
                              causal=causal)
    assert out.dtype == getattr(torch, dtype) and out.shape == q.shape
    _, jnp, jref, pallas_flash = jax_side()
    a = lambda x: jnp.asarray(x).astype(getattr(jnp, dtype))
    blk = min(T, S, 32)
    pallas = pallas_flash(a(q), a(k), a(v), causal=causal, blk_q=blk,
                          blk_k=blk, interpret=True)
    oracle = jref.flash_attention_ref(a(q), a(k), a(v), causal=causal)
    got = out.float().numpy()
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               **TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(oracle, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("B,T,S,Hq,Hkv,hd,causal", CASES)
def test_flash_gradients_match_jax(B, T, S, Hq, Hkv, hd, causal):
    q, k, v, dout = make_inputs(B, T, S, Hq, Hkv, hd, seed=hd + S)
    _, *got = port_grads(q, k, v, dout, causal)
    for g, want in zip(got, jax_grads(q, k, v, dout, causal)):
        np.testing.assert_allclose(g, want, **TOL["float32"])


@pytest.mark.parametrize("causal", [True, False])
def test_seam_long_route_is_chunked_and_matches_oracle(causal):
    """From 1024 query positions the seam's CPU route is
    ``chunked_attention`` (as the reference's XLA route), forward and
    gradients equal to the oracle's."""
    q, k, v, dout = make_inputs(1, 1024, 1024, 2, 1, 32, seed=11)
    out, *grads = port_grads(q, k, v, dout, causal)
    _, *plain = port_grads(q, k, v, dout, causal,
                           fn=ref.flash_attention_ref)
    _, jnp, jref, _ = jax_side()
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(out, np.asarray(want), **TOL["float32"])
    for g, p in zip(grads, plain):
        np.testing.assert_allclose(g, p, **TOL["float32"])


def test_cpu_tensors_never_reach_the_kernel():
    q, k, v, _ = make_inputs(1, 16, 16, 2, 1, 32, seed=3)
    before = (fk.flash_attention_fwd.launches,
              fk.flash_attention_bwd.launches)
    port_grads(q, k, v, np.ones_like(q), True)
    assert (fk.flash_attention_fwd.launches,
            fk.flash_attention_bwd.launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk.flash_attention(*(to_torch(a) for a in (q, k, v)))


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


# kernel against plain, fp32 at 1e-4 and bf16 at 2e-2 (sums in another
# order; bf16 rounds O, dq, dk and dv once, from fp32, in both)
CARD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,S,Hq,Hkv,hd,causal", CASES + [
    (2, 1000, 1000, 9, 3, 64, True), (3, 1, 1, 4, 2, 64, True),
    (2, 77, 200, 8, 2, 128, False), (1, 300, 130, 4, 4, 32, True),
    (2, 256, 256, 32, 8, 128, True), (2, 1024, 1024, 32, 32, 80, True),
    (1, 1024, 1024, 32, 32, 96, True), (1, 1024, 1024, 64, 8, 112, True),
    (8, 448, 448, 6, 6, 64, True), (2, 1088, 1088, 56, 8, 128, True)])
def test_kernel_matches_plain_on_card(cuda, B, T, S, Hq, Hkv, hd, causal,
                                      dtype):
    q, k, v, dout = make_inputs(B, T, S, Hq, Hkv, hd, seed=T + S + hd)
    before = (fk.flash_attention_fwd.launches,
              fk.flash_attention_bwd.launches)
    got = port_grads(q, k, v, dout, causal, dtype, cuda)
    torch.cuda.synchronize()
    assert (fk.flash_attention_fwd.launches,
            fk.flash_attention_bwd.launches) == (before[0] + 1,
                                                 before[1] + 1)
    want = port_grads(q, k, v, dout, causal, dtype, cuda,
                      fn=ref.flash_attention_ref)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **CARD_TOL[dtype])


@pytest.mark.gpu
def test_kernel_reads_strided_inputs_and_gradient(cuda):
    """q, k, v as slices of one fused projection and a non-contiguous dO,
    against the plain version on contiguous copies."""
    B, T, Hq, Hkv, hd = 2, 130, 6, 2, 64
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal(
        (B, T, Hq + 2 * Hkv, hd), np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]
    dout = torch.from_numpy(rng.standard_normal((B, Hq, T, hd), np.float32)
                            ).to(cuda, torch.bfloat16).transpose(1, 2)
    out, lse = fk.flash_attention_fwd(q, k, v, True)
    got = fk.flash_attention_bwd(q, k, v, out, lse, dout, True)
    qc, kc, vc = (t.contiguous().requires_grad_(True) for t in (q, k, v))
    want = ref.flash_attention_ref(qc, kc, vc, causal=True)
    want.backward(dout)
    torch.cuda.synchronize()
    for g, w in zip((out, *got), (want, qc.grad, kc.grad, vc.grad)):
        np.testing.assert_allclose(g.detach().float().cpu(),
                                   w.detach().float().cpu(),
                                   **CARD_TOL["bfloat16"])
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_attention(q[..., :48], k[..., :48], v[..., :48])


@pytest.mark.gpu
def test_train_loss_and_gradients_kernel_against_plain_on_card(cuda):
    """The reduced model's loss and gradients through the kernels (remat
    "block": two forward launches a layer) against the plain attention."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import DenseLM
    from repro_torch.train.train_step import value_and_grad
    cfg = get_config("smollm-135m").reduced(remat="block")
    model = DenseLM(cfg, device=cuda)
    plain = DenseLM(cfg, device=cuda, flash_attention=ref.flash_attention_ref)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, 512, (2, 200))
                                 .astype(np.int32)).to(cuda)
             for k in ("tokens", "labels")}
    before = fk.flash_attention_fwd.launches, fk.flash_attention_bwd.launches
    loss, grads = value_and_grad(model.loss_fn, params, batch)
    torch.cuda.synchronize()
    assert (fk.flash_attention_fwd.launches - before[0],
            fk.flash_attention_bwd.launches - before[1]) == (4, 2)
    want_loss, want = value_and_grad(plain.loss_fn, params, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("hd", fk.HEAD_DIMS)
def test_forward_route_table(hd):
    """The fixed route table of the forward: bf16 on wgmma at hd 64 and 128
    (whole 64-column panels), on mma.sync at 32, 80, 96 and 112; fp32 on
    the CUDA cores at every head dim."""
    want = "wgmma" if hd in (64, 128) else "mma.sync"
    assert fk.fwd_route(torch.bfloat16, hd) == want
    assert fk.fwd_route(torch.float32, hd) == "cuda cores"


@pytest.mark.gpu
@pytest.mark.parametrize("hd", fk.HEAD_DIMS)
def test_library_route_table_matches(cuda, hd):
    for dtype in (torch.bfloat16, torch.float32):
        assert fk.library_fwd_route(dtype, hd) == fk.fwd_route(dtype, hd)


def scaled_lse(q, k, causal):
    """The natural log-sum-exp of the scaled scores, (B, Hq, T) fp32."""
    B, T, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    g = Hq // Hkv
    qg = q.float().reshape(B, T, Hkv, g, hd)
    s = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) / hd ** 0.5
    if causal:
        mask = torch.arange(T, device=q.device)[:, None] >= \
            torch.arange(S, device=q.device)[None, :]
        s = torch.where(mask, s, -torch.inf)
    return torch.logsumexp(s, dim=-1).reshape(B, Hq, T)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,S,Hq,Hkv,hd,causal", [
    (8, 2048, 2048, 9, 3, 64, True), (2, 1000, 1000, 9, 3, 64, True),
    (3, 1, 1, 4, 2, 64, True), (1, 130, 300, 4, 2, 64, True),
    (2, 256, 256, 32, 8, 128, True), (2, 77, 200, 8, 2, 128, False),
    (2, 300, 130, 4, 4, 128, True), (1, 1, 50, 2, 1, 128, False)])
def test_wgmma_forward_out_and_lse_on_card(cuda, B, T, S, Hq, Hkv, hd,
                                           causal):
    """The bf16 forward at hd 64 and 128 (the wgmma route): O against the
    plain version at 2e-2, lse against ``logsumexp`` of the scaled fp32
    scores of the same bf16 inputs at 1e-3 (sums in another order and
    exp2 for exp), and three calls bit-identical."""
    assert fk.fwd_route(torch.bfloat16, hd) == "wgmma"
    q, k, v, _ = (to_torch(a, "bfloat16", cuda) for a in
                  make_inputs(B, T, S, Hq, Hkv, hd, seed=T + S + hd))
    out, lse = fk.flash_attention_fwd(q, k, v, causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    want_lse = scaled_lse(q, k, causal)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu(), want.float().cpu(),
                               **CARD_TOL["bfloat16"])
    np.testing.assert_allclose(lse.cpu(), want_lse.cpu(), rtol=1e-3,
                               atol=1e-3)
    for _ in range(2):
        again, again_lse = fk.flash_attention_fwd(q, k, v, causal)
        assert torch.equal(again, out) and torch.equal(again_lse, lse)


@pytest.mark.parametrize("hd", fk.HEAD_DIMS)
def test_backward_route_table(hd):
    """The fixed route table of the backward: bf16 on wgmma at hd 64 and
    128, on mma.sync at 32, 80, 96 and 112; fp32 on the CUDA cores."""
    want = "wgmma" if hd in (64, 128) else "mma.sync"
    assert fk.bwd_route(torch.bfloat16, hd) == want
    assert fk.bwd_route(torch.float32, hd) == "cuda cores"


@pytest.mark.gpu
@pytest.mark.parametrize("hd", fk.HEAD_DIMS)
def test_library_backward_route_table_matches(cuda, hd):
    for dtype in (torch.bfloat16, torch.float32):
        assert fk.library_bwd_route(dtype, hd) == fk.bwd_route(dtype, hd)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,S,Hq,Hkv,hd,causal", [
    (2, 256, 256, 8, 8, 64, True), (2, 256, 256, 9, 3, 64, True),
    (1, 384, 384, 16, 2, 64, True), (2, 256, 256, 4, 4, 128, True),
    (1, 320, 320, 6, 2, 128, True), (1, 256, 256, 16, 2, 128, True),
    (2, 1000, 1000, 9, 3, 64, True), (2, 333, 333, 8, 1, 128, True),
    (3, 1, 1, 4, 2, 64, True), (2, 1, 1, 8, 1, 128, True),
    (2, 77, 200, 8, 2, 128, False), (2, 300, 130, 6, 3, 64, False),
    (1, 130, 300, 4, 4, 128, True)])
def test_wgmma_backward_matches_autograd_on_card(cuda, B, T, S, Hq, Hkv, hd,
                                                 causal):
    """The bf16 backward at hd 64 and 128 (the wgmma route) against
    autograd through the plain version: GQA groups 1, 3 and 8, ragged T,
    T = 1, full attention with T != S; two more backwards bit-identical."""
    assert fk.bwd_route(torch.bfloat16, hd) == "wgmma"
    q, k, v, dout = (to_torch(a, "bfloat16", cuda) for a in
                     make_inputs(B, T, S, Hq, Hkv, hd, seed=T + S + Hq))
    out, lse = fk.flash_attention_fwd(q, k, v, causal)
    got = fk.flash_attention_bwd(q, k, v, out, lse, dout, causal)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref.flash_attention_ref(*leaves, causal=causal).backward(dout)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, leaves):
        np.testing.assert_allclose(g.float().cpu(), w.grad.float().cpu(),
                                   err_msg=name, **CARD_TOL["bfloat16"])
    for _ in range(2):
        again = fk.flash_attention_bwd(q, k, v, out, lse, dout, causal)
        assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
def test_wgmma_backward_reads_strided_inputs_and_gradient(cuda, hd):
    """q, k, v as slices of one fused projection and a dO transposed in
    memory, through the wgmma backward, against the plain version on
    contiguous copies."""
    B, T, Hq, Hkv = 2, 200, 8, 2
    rng = np.random.default_rng(hd)
    qkv = torch.from_numpy(rng.standard_normal(
        (B, T, Hq + 2 * Hkv, hd), np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :Hq], qkv[:, :, Hq:Hq + Hkv], qkv[:, :, Hq + Hkv:]
    dout = torch.from_numpy(rng.standard_normal((B, Hq, T, hd), np.float32)
                            ).to(cuda, torch.bfloat16).transpose(1, 2)
    out, lse = fk.flash_attention_fwd(q, k, v, True)
    got = fk.flash_attention_bwd(q, k, v, out, lse, dout, True)
    leaves = [t.contiguous().requires_grad_(True) for t in (q, k, v)]
    ref.flash_attention_ref(*leaves, causal=True).backward(dout)
    torch.cuda.synchronize()
    for g, w in zip(got, leaves):
        np.testing.assert_allclose(g.float().cpu(), w.grad.float().cpu(),
                                   **CARD_TOL["bfloat16"])
