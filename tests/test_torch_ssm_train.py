"""Training through the port's SSD scan: its backward against the
reference's gradients.

On the CPU: the plain backward ``ref.ssd_scan_bwd_ref`` (the chunked
formulas the CUDA backward runs, pass by pass) against autograd through
the plain forward ``ref.ssd_scan_ref`` and against ``jax.vjp`` of the
reference's sequential oracle, over the sweep of ``tests/test_kernels.py``
with and without an initial state and with a nonzero final-state
gradient; the port's ``ssd_chunked`` against ``jax.vjp`` of the
reference's; reduced ``MambaLM`` and ``HybridLM`` losses and gradients
against ``jax.value_and_grad`` of the reference's. The cases marked
``gpu`` hold the backward kernel against the plain backward on the card
and skip without one; JAX is imported only inside the tests that need it,
since the machine with the card has none.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as sk
from repro_torch.models import mamba2
from repro_torch.models.common import tree_leaves
from repro_torch.models.transformer import build_model
from repro_torch.train.train_step import value_and_grad
from repro_torch.weights import hybrid_params_from_flat, ssm_params_from_flat

TOL = dict(rtol=2e-4, atol=2e-4)          # tests/test_kernels.py:144-149
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
# (B, T, H, P, N, Q): the sweep of tests/test_kernels.py:130-135
SWEEP = [(1, 32, 2, 16, 8, 8), (2, 64, 3, 16, 8, 16), (1, 128, 4, 32, 16, 32),
         (2, 64, 1, 64, 64, 64)]
GRADS = ("du", "dloga", "dBm", "dCm", "dh0")


def make_inputs(B, T, H, P, N, seed, h0=False):
    """The scan's inputs as ``tests/test_torch_ssm.py`` draws them, then
    dy ~ N and a nonzero final-state gradient ~ N."""
    rng = np.random.default_rng(seed)
    out = {"u": rng.standard_normal((B, T, H, P), np.float32) * 0.5,
           "loga": -rng.uniform(0, 0.5, (B, T, H)).astype(np.float32),
           "Bm": rng.standard_normal((B, T, N), np.float32) * 0.3,
           "Cm": rng.standard_normal((B, T, N), np.float32) * 0.3,
           "h0": rng.standard_normal((B, H, N, P), np.float32)
           if h0 else None}
    out["dy"] = rng.standard_normal((B, T, H, P), np.float32)
    out["dstate"] = rng.standard_normal((B, H, N, P), np.float32)
    return out


def t(a, device="cpu"):
    return None if a is None else \
        torch.from_numpy(np.ascontiguousarray(a)).to(device)


def plain_backward(x, Q, device="cpu"):
    return ref.ssd_scan_bwd_ref(
        t(x["u"], device), t(x["loga"], device), t(x["Bm"], device),
        t(x["Cm"], device), t(x["h0"], device), t(x["dy"], device),
        t(x["dstate"], device), chunk=Q)


def assert_grads_close(got, want, with_h0):
    """du, dloga, dBm, dCm at TOL, dh0 (a state) at STATE_TOL."""
    for name, g, w in zip(GRADS, got, want):
        if name == "dh0" and not with_h0:
            continue
        np.testing.assert_allclose(
            g.detach().cpu().numpy(), np.asarray(w),
            **(STATE_TOL if name == "dh0" else TOL), err_msg=name)


# ---------------------------------------------------------------------------
# the plain backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("B,T,H,P,N,Q", SWEEP)
def test_plain_backward_matches_autograd(B, T, H, P, N, Q, h0):
    """The written-out passes against autograd through the plain forward,
    for the loss <y, dy> + <final state, dstate>."""
    x = make_inputs(B, T, H, P, N, seed=T + N + int(h0), h0=h0)
    names = ("u", "loga", "Bm", "Cm") + (("h0",) if h0 else ())
    leaves = {k: t(x[k]).requires_grad_(True) for k in names}
    y, state = ref.ssd_scan_ref(leaves["u"], leaves["loga"], leaves["Bm"],
                                leaves["Cm"], chunk=Q, h0=leaves.get("h0"))
    loss = (y * t(x["dy"])).sum() + (state * t(x["dstate"])).sum()
    want = torch.autograd.grad(loss, list(leaves.values()))
    got = plain_backward(x, Q)
    assert all(g.dtype == torch.float32 for g in got)
    assert got[4].shape == (B, H, N, P)
    assert_grads_close(got, [w.numpy() for w in want] + ([] if h0 else
                                                         [None]), h0)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("B,T,H,P,N,Q", SWEEP)
def test_plain_backward_matches_the_reference_oracle(B, T, H, P, N, Q, h0):
    """Against ``jax.vjp`` of the reference's sequential recurrence
    (``repro/kernels/ref.py:ssd_ref``), with the same cotangents."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    x = make_inputs(B, T, H, P, N, seed=T * 3 + N + int(h0), h0=h0)
    primals = [jnp.asarray(x[k]) for k in ("u", "loga", "Bm", "Cm")]
    if h0:
        primals.append(jnp.asarray(x["h0"]))
    _, vjp = jax.vjp(lambda *a: jref.ssd_ref(*a), *primals)
    want = vjp((jnp.asarray(x["dy"]), jnp.asarray(x["dstate"])))
    assert_grads_close(plain_backward(x, Q), list(want), h0)


def test_plain_backward_without_a_state_gradient():
    """dstate None (the final state unused, as in the loss) is zeros."""
    x = make_inputs(2, 64, 3, 16, 8, seed=9, h0=True)
    got = ref.ssd_scan_bwd_ref(*(t(x[k]) for k in ("u", "loga", "Bm", "Cm",
                                                   "h0", "dy")), None,
                               chunk=16)
    want = plain_backward({**x, "dstate": np.zeros_like(x["dstate"])}, 16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("Q", [8, 16, 64])
def test_plain_backward_is_chunk_size_invariant(Q):
    x = make_inputs(2, 64, 2, 16, 8, seed=Q, h0=True)
    for g, w in zip(plain_backward(x, Q), plain_backward(x, 64)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_gradients_match_reference(with_state):
    """The port's ``ssd_chunked`` (x * dt and dt * A into the scan) against
    ``jax.vjp`` of the reference's, with respect to x, dt, A, Bm, Cm and
    the initial state."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import mamba2 as ref_mamba2
    rng = np.random.default_rng(11)
    B, T, H, P, N, Q = 2, 48, 3, 16, 8, 16
    arrays = {"x": rng.standard_normal((B, T, H, P), np.float32),
              "dt": rng.uniform(0.01, 0.2, (B, T, H)).astype(np.float32),
              "A": -rng.uniform(0.5, 3.0, (H,)).astype(np.float32),
              "Bm": rng.standard_normal((B, T, N), np.float32) * 0.3,
              "Cm": rng.standard_normal((B, T, N), np.float32) * 0.3,
              "init": rng.standard_normal((B, H, N, P), np.float32)}
    dy = rng.standard_normal((B, T, H, P), np.float32)
    dstate = rng.standard_normal((B, H, N, P), np.float32)
    names = list(arrays) if with_state else list(arrays)[:-1]

    def ref_fn(*a):
        kw = dict(zip(names, a))
        return ref_mamba2.ssd_chunked(
            kw["x"], kw["dt"], kw["A"], kw["Bm"], kw["Cm"], chunk=Q,
            initial_state=kw.get("init"), return_state=True)

    _, vjp = jax.vjp(ref_fn, *(jnp.asarray(arrays[k]) for k in names))
    want = vjp((jnp.asarray(dy), jnp.asarray(dstate)))
    leaves = {k: t(arrays[k]).requires_grad_(True) for k in names}
    y, state = mamba2.ssd_chunked(
        leaves["x"], leaves["dt"], leaves["A"], leaves["Bm"], leaves["Cm"],
        chunk=Q, initial_state=leaves.get("init"), return_state=True)
    got = torch.autograd.grad((y * t(dy)).sum() + (state * t(dstate)).sum(),
                              list(leaves.values()))
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the models' losses and gradients
# ---------------------------------------------------------------------------
def flat_params(params) -> dict:
    import jax
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in leaves}


@pytest.mark.parametrize("arch,bridge,seed", [
    ("mamba2-1.3b", ssm_params_from_flat, 3),
    ("zamba2-2.7b", hybrid_params_from_flat, 4)])
@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_gradients_match_jax(arch, bridge, seed, remat):
    """Reduced MambaLM and HybridLM (two chunks of 16 a sequence): the loss
    and every leaf's gradient against ``jax.value_and_grad`` of the
    reference's loss, with and without checkpointed layers, as
    ``tests/test_torch_train.py`` holds the dense family."""
    from dataclasses import replace
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.models.transformer import build_model as ref_build_model
    ref_model = ref_build_model(ref_get_config(arch).reduced())
    ref_params = ref_model.init(jax.random.key(seed))
    cfg = replace(get_config(arch).reduced(), remat=remat)
    model = build_model(cfg, device="cpu")
    params = bridge(flat_params(ref_params), cfg, "cpu")
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    ref_loss, ref_grads = jax.value_and_grad(ref_model.loss_fn)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = value_and_grad(model.loss_fn, params,
                                 {k: t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-5)
    ref_leaves = jax.tree_util.tree_leaves(ref_grads)
    leaves = tree_leaves(grads)
    assert len(leaves) == len(ref_leaves)
    for got, want in zip(leaves, ref_leaves):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_launch_train_on_the_cpu(arch, tmp_path):
    """``launch.train --arch ... --reduced --device cpu``: finite losses,
    the SSM and hybrid families through the same entry point as the
    dense."""
    from repro_torch.launch import train
    result = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "32",
                         "--ckpt-every", "0", "--log-every", "0",
                         "--cas", str(tmp_path)])
    assert len(result["losses"]) == 3
    assert all(np.isfinite(result["losses"] + result["grad_norms"]))


def test_cpu_tensors_never_reach_the_backward_kernel():
    """On the CPU the loss differentiates through the plain version; the
    backward wrapper refuses CPU tensors."""
    x = make_inputs(1, 16, 2, 16, 8, seed=1)
    u = t(x["u"]).requires_grad_(True)
    before = sk.ssd_scan_bwd.launches
    y, _ = ops.ssd_scan(u, *(t(x[k]) for k in ("loga", "Bm", "Cm")), chunk=8)
    y.sum().backward()
    assert sk.ssd_scan_bwd.launches == before and u.grad is not None
    states = torch.zeros((1, 2, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        sk.ssd_scan_bwd(*(t(x[k]) for k in ("u", "loga", "Bm", "Cm")),
                        states, t(x["dy"]), None, chunk=8)


@pytest.fixture
def plain_passes(monkeypatch):
    """``ssd_scan_fwd`` and ``ssd_scan_bwd`` replaced by their plain
    versions (the forward filling ``chunk_states`` as the kernel does), so
    that ``SSDScan``'s autograd plumbing runs on the CPU; returns the
    ``chunk_states`` each forward was given."""
    given = []

    def fwd(u, loga, Bm, Cm, *, chunk, h0=None, chunk_states=None):
        given.append(chunk_states)
        if chunk_states is not None:
            chunk_states.copy_(ref.ssd_chunk_states(u, loga, Bm, chunk=chunk,
                                                    h0=h0)[0])
        return ref.ssd_scan_ref(u, loga, Bm, Cm, chunk=chunk, h0=h0)

    def bwd(u, loga, Bm, Cm, chunk_states, dy, dstate, *, chunk):
        return ref.ssd_scan_bwd_ref(u, loga, Bm, Cm, chunk_states[:, 0], dy,
                                    dstate, chunk=chunk)

    monkeypatch.setattr(sk, "ssd_scan_fwd", fwd)
    monkeypatch.setattr(sk, "ssd_scan_bwd", bwd)
    return given


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("h0,final", [(False, False), (True, True)])
def test_autograd_function_saves_states_and_routes_the_gradient(
        plain_passes, remat, h0, final):
    """``SSDScan`` (the kernels' autograd Function) with its passes run by
    the plain versions: the gradients of u, loga, Bm, Cm and h0 equal
    autograd through the plain forward, with the final state used or not
    (dstate None), with and without a checkpoint around it; the forward is
    given a chunk-states tensor only when grad mode is on and an input
    needs a gradient."""
    from torch.utils.checkpoint import checkpoint
    x = make_inputs(2, 48, 3, 16, 8, seed=21, h0=h0)
    names = ("u", "loga", "Bm", "Cm") + (("h0",) if h0 else ())

    def loss_of(scan, leaves):
        y, state = scan(*(leaves[k] for k in ("u", "loga", "Bm", "Cm")),
                        chunk=16, h0=leaves.get("h0"))
        loss = (y * t(x["dy"])).sum()
        return loss + (state * t(x["dstate"])).sum() if final else loss

    def grads(scan, checkpointed):
        leaves = {k: t(x[k]).requires_grad_(True) for k in names}
        fn = lambda *a: loss_of(scan, dict(zip(names, a)))
        loss = checkpoint(fn, *leaves.values(), use_reentrant=False) \
            if checkpointed else fn(*leaves.values())
        return torch.autograd.grad(loss, list(leaves.values()))

    got = grads(sk.ssd_scan, remat)
    want = grads(ref.ssd_scan_ref, False)
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL, err_msg=name)
    assert all(s is not None and s.shape == (2, 3, 3, 8, 16)
               for s in plain_passes)
    plain_passes.clear()
    with torch.no_grad():
        sk.ssd_scan(*(t(x[k]).requires_grad_(True) for k in names[:4]),
                    chunk=16, h0=t(x["h0"]))
    sk.ssd_scan(*(t(x[k]) for k in names[:4]), chunk=16, h0=t(x["h0"]))
    assert plain_passes == [None, None]


@pytest.mark.parametrize("B,T,H,P,N,Q", [(8, 2048, 64, 64, 128, 256),
                                         (8, 2048, 80, 64, 64, 256), *SWEEP])
def test_ssd_bwd_plan_covers_every_tile_once(B, T, H, P, N, Q):
    """b2 takes every (P slice, head, chunk, b) once, as the forward's pass
    2; b4 every tile (it, jt) of each chunk's panel once (x = it * tiles +
    jt; those above the diagonal only write zeros), b5 every (head, chunk,
    b), b6 every 128-row tile for dC and for dB over all of N, 2 x N rounded
    up threads; the workspace's parts."""
    plan = sk.ssd_bwd_plan(B, T, H, P, N, Q)
    nc = T // Q
    tq = -(-Q // 64)
    ps = plan["p_slice"]
    assert P % ps == 0 and ps == sk.ssd_plan(B, T, H, P, N, Q)["p_slice"]
    g = plan["grids"]
    assert g["summaries"] == sk.ssd_plan(B, T, H, P, N, Q)["grids"][
        "summaries"] == (P // ps, H, B * nc)
    assert g["panel"] == (tq * tq, B * nc, 1)
    tiles = {(x // tq, x % tq) for x in range(g["panel"][0])}
    assert tiles == {(i, j) for i in range(tq) for j in range(tq)}
    assert g["du"] == (H, B * nc, 1)
    x, y, z = g["dbc"]
    assert (x - 1) * 128 < Q <= x * 128 and (y, z) == (2, B * nc)
    threads = plan["threads"]
    n_pad = plan["workspace"]["ct"][2]
    assert N <= n_pad and threads["dbc"] == 2 * n_pad
    assert threads["panel"] == 64 and threads["du"] == 256
    x, y, z = g["states"]
    assert (x - 1) * 256 < N * P <= x * 256 and (y, z) == (H, B)
    ws = plan["workspace"]
    assert list(ws) == ["cbt", "ct", "g", "panel", "rows", "cols", "cum",
                        "decay"]
    assert ws["g"] == (B, nc, H, N, P) and ws["decay"] == (B, nc, H)
    assert ws["cum"] == (B, nc, H, 256)
    for name in list(ws)[:-1]:
        assert np.prod(ws[name]) % 4 == 0


def test_ssd_bwd_workspace_at_the_training_shape():
    """mamba2-1.3b's training scan (B 8, T 2048): the state gradients take
    134 MB, as the states the forward keeps for the backward do; the prefix
    sums of loga 4 MB; 214 MB in all."""
    plan = sk.ssd_bwd_plan(8, 2048, 64, 64, 128, 256)
    nbytes = {k: 4 * int(np.prod(v)) for k, v in plan["workspace"].items()}
    assert nbytes["g"] == 8 * 8 * 64 * 128 * 64 * 4 == 134217728
    assert nbytes["panel"] == nbytes["cbt"] == 64 * 2 ** 18
    assert nbytes["cum"] == 8 * 8 * 64 * 256 * 4 == 4194304
    assert sum(nbytes.values()) == 213925888


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
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("B,T,H,P,N,Q", SWEEP)
def test_backward_kernel_matches_plain_on_card(cuda, B, T, H, P, N, Q, h0):
    """The kernel through autograd against the plain backward, and three
    calls of ``ssd_scan_bwd`` bit-identical."""
    x = make_inputs(B, T, H, P, N, seed=T + N + int(h0), h0=h0)
    names = ("u", "loga", "Bm", "Cm") + (("h0",) if h0 else ())
    leaves = {k: t(x[k], cuda).requires_grad_(True) for k in names}
    before = sk.ssd_scan_bwd.launches
    y, state = ops.ssd_scan(leaves["u"], leaves["loga"], leaves["Bm"],
                            leaves["Cm"], chunk=Q, h0=leaves.get("h0"))
    loss = (y * t(x["dy"], cuda)).sum() + \
        (state * t(x["dstate"], cuda)).sum()
    got = torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    assert sk.ssd_scan_bwd.launches == before + 1
    want = plain_backward(x, Q, cuda)
    assert_grads_close(list(got) + ([] if h0 else [got[0]]),
                       [w.cpu().numpy() for w in want], h0)
    args = [t(x[k], cuda) for k in ("u", "loga", "Bm", "Cm")]
    states = torch.empty((B, T // Q, H, N, P), device=cuda)
    sk.ssd_scan_fwd(*args, chunk=Q, h0=t(x["h0"], cuda),
                    chunk_states=states)
    first = sk.ssd_scan_bwd(*args, states, t(x["dy"], cuda),
                            t(x["dstate"], cuda), chunk=Q)
    for _ in range(2):
        again = sk.ssd_scan_bwd(*args, states, t(x["dy"], cuda),
                                t(x["dstate"], cuda), chunk=Q)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.gpu
def test_served_forward_keeps_nothing_for_backward(cuda):
    """Under ``torch.no_grad`` (a served prefill) the forward saves no
    chunk states and no autograd graph."""
    x = make_inputs(1, 64, 2, 16, 8, seed=3)
    u = t(x["u"], cuda).requires_grad_(True)
    with torch.no_grad():
        y, _ = ops.ssd_scan(u, *(t(x[k], cuda) for k in ("loga", "Bm",
                                                          "Cm")), chunk=16)
    assert y.grad_fn is None
