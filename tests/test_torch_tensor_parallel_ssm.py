"""The port's tensor-parallel compute along "model" for the ssm and hybrid
families (``repro_torch/distributed/tensor_parallel.py``: ``Route.ssm``,
``sharding.tp_layouts`` and ``tp_cache``) against the reference's
single-device steps.

The harness is ``tests/test_torch_tensor_parallel.py``'s, over this
file's cases: the reference runs once in a subprocess, the port in 8 gloo
processes, in a module fixture; the weights come from the reference's
``init`` through the weight bridge, the batches and prompts are made with
numpy from seeds.

Cases (name -> (arch, reduced config, ("data", "model") mesh, training
sequence length)):
  * ``ssm_local``: a reduced mamba2-1.3b (8 SSM heads of 32, N 16, vocab
    512) on (4, 2), T 32: 4 SSM heads a rank, the vocab local,
    sequence-parallel residuals in training;
  * ``ssm_not_seq_parallel``: the same at T 31 (the chunk 31): one
    all-reduce after each block's ``out_proj`` in training too;
  * ``ssm_gathered``: a reduced mamba2 with 3 SSM heads (d_model 96, head
    dim 64) on (2, 4), which 4 ranks do not divide: every rank computes the
    block whole;
  * ``hybrid_local``: a reduced zamba2-2.7b (4 query heads on 2 KV heads,
    d_ff 256, 8 SSM heads, two groups of 2 layers, remat "block") on (4,
    2): the shared block's heads and MLP local, 4 SSM heads a rank, each
    group's recompute in the backward on the same route.
Each trains 3 AdamW steps, then serves a prefill and 8 greedy decode steps
from the initial weights. In this process: the gated RMSNorm's statistic
summed over 4 ranks (threads) against the whole RMSNorm, values and
gradient; the block over 2 ranks against the whole block; the plan where
m does not divide the SSM heads; the slices and the conv tail's layout.
The plan at m = 16 is ``test_torch_tensor_parallel.py``'s table.
"""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_tensor_parallel import (BATCH, DECODES, STEPS, TOL, _Group,
                                        make_inputs, reduced, run_reference,
                                        spawn_ranks)

MAMBA = dict(n_layers=2, d_model=128, vocab_size=512)
CASES = {"ssm_local": ("mamba2-1.3b", MAMBA, (4, 2), 32),
         "ssm_not_seq_parallel": ("mamba2-1.3b", dict(MAMBA, ssm_chunk=32),
                                  (4, 2), 31),
         "ssm_gathered": ("mamba2-1.3b", dict(MAMBA, d_model=96,
                                              ssm_head_dim=64), (2, 4), 32),
         "hybrid_local": ("zamba2-2.7b", dict(vocab_size=512, remat="block"),
                          (4, 2), 32)}
# each case's plan: the "model" size, the attention's mode and local heads
# (None without attention), the MLP's, the vocab's, the SSM block's mode
# and heads a rank, whether training is sequence-parallel; prefill and
# decode take the same modes, never sequence-parallel
PLANS = {"ssm_local": (2, None, None, None, "local", "local", 4, True),
         "ssm_not_seq_parallel": (2, None, None, None, "local", "local", 4,
                                  False),
         "ssm_gathered": (4, None, None, None, "local", "gathered", 3, True),
         "hybrid_local": (2, "local", [2, 1], "local", "local", "local", 4,
                          True)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, the 8 ranks' records)."""
    tmp = tmp_path_factory.mktemp("tensor_parallel_ssm")
    np.savez(tmp / "inputs.npz", **make_inputs(CASES, seed=29))
    run_reference(str(tmp / "inputs.npz"), str(tmp / "ref.npz"), CASES)
    ref = dict(np.load(tmp / "ref.npz"))
    inp = {**dict(np.load(tmp / "inputs.npz")),
           **{k: v for k, v in ref.items() if "/params/" in k}}
    np.savez(tmp / "port_inputs.npz", **inp)
    return ref, spawn_ranks(8, tmp, str(tmp / "port_inputs.npz"), CASES)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_train_steps_match_reference(runs, name):
    """3 AdamW steps: losses and grad norms within 1e-5 relative of the
    reference's single-device step, every leaf within 1e-5."""
    ref, ranks = runs
    rec = ranks[0]
    for i in range(STEPS):
        for m in ("loss", "grad_norm"):
            np.testing.assert_allclose(rec[f"{name}/{m}{i}"],
                                       ref[f"{name}/{m}{i}"], rtol=TOL)
    finals = sorted(k for k in ref if k.startswith(f"{name}/final"))
    assert finals and len(finals) == len(
        [k for k in rec if k.startswith(f"{name}/final")])
    for k in finals:
        np.testing.assert_allclose(rec[k], ref[k], atol=TOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_serve_steps_match_reference(runs, name):
    """The prefill and 8 greedy decode steps of ``serve_step``: the logits
    gathered over the vocab (and the batch) within 1e-5 of the reference's
    ``prefill``/``decode``, the greedy tokens identical."""
    ref, ranks = runs
    rec = ranks[0]
    for j in range(DECODES + 1):
        np.testing.assert_allclose(rec[f"{name}/logits{j}"],
                                   ref[f"{name}/logits{j}"], atol=TOL,
                                   rtol=0, err_msg=f"step {j}")
    for j in range(DECODES):
        np.testing.assert_array_equal(rec[f"{name}/tokens{j}"],
                                      ref[f"{name}/tokens{j}"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_rank_reports_the_same(runs, name):
    """The global metrics, the final leaves and the gathered logits are
    the same bits on every rank."""
    _, ranks = runs
    keys = [k for k in ranks[0] if k.startswith(f"{name}/") and k.split(
        "/")[1].startswith(("loss", "grad_norm", "final", "logits"))]
    for rec in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(rec[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_steps_take_the_plan(runs, name):
    """Each train step takes one route of the case's plan,
    sequence-parallel where "model" divides the sequence (32, not 31); the
    prefill and each decode step one, not sequence-parallel. A rank's
    logits are its batch rows and its vocab columns; its SSM state and
    conv tail hold its heads' where the SSM heads are local (the tail its
    x channels and B and C), else the state is whole (3 heads on 4 ranks)
    and the tail at rest in the reference's layout, its channels cut
    evenly (224 on 4 ranks), gathered for the step."""
    _, ranks = runs
    arch, over, (data, model), _ = CASES[name]
    m, heads, local_heads, mlp, vocab, ssm, ssm_heads, sp = PLANS[name]
    cfg = reduced(arch, over)

    def want(seq_parallel, rank):
        return {"model": m, "heads": heads, "local_heads": local_heads,
                "mlp": mlp, "vocab": vocab, "seq_parallel": seq_parallel,
                "ssm": ssm, "ssm_heads": ssm_heads,
                "model_rank": rank % model, "q_rows": None}

    assert m == model
    rows = BATCH // data
    tail = (cfg.d_inner // m + 2 * cfg.ssm_state if ssm == "local"
            else (cfg.d_inner + 2 * cfg.ssm_state) // m)
    lead = [cfg.n_layers] if cfg.family == "ssm" else [
        cfg.n_layers // cfg.attn_every, cfg.attn_every]
    for rank, rec in enumerate(ranks):
        assert json.loads(str(rec[f"{name}/train_plans"])) == [
            want(sp, rank)] * STEPS
        assert json.loads(str(rec[f"{name}/serve_plans"])) == [
            want(False, rank)] * (1 + DECODES)
        assert list(rec[f"{name}/local_logits"]) == [
            rows, 1, cfg.vocab_size // (m if vocab == "local" else 1)]
        assert json.loads(str(rec[f"{name}/local_state"])) == [
            lead + [rows, cfg.conv_kernel - 1, tail],
            lead + [rows, ssm_heads, cfg.ssm_state, cfg.ssm_head_dim]]


# ---------------------------------------------------------------------------
# the pieces, in this process: ranks as threads over a stand-in group
# ---------------------------------------------------------------------------
class _Board:
    """The collectives of ``size`` threads, each a rank: an all-reduce
    waits for every rank's tensor and returns their sum (or max) to each,
    summed in rank order."""

    def __init__(self, size: int) -> None:
        self.size, self.parts = size, [None] * size
        self.barrier = threading.Barrier(size, timeout=60)

    def all_reduce(self, x, op, group):
        self.parts[group.rank()] = x.detach().clone()
        self.barrier.wait()
        parts = list(self.parts)
        self.barrier.wait()
        out = parts[0]
        for p in parts[1:]:
            out = out + p if op == "sum" else torch.maximum(out, p)
        return out


def on_threads(size: int, fn, monkeypatch) -> list:
    """``fn(rank, group)`` on ``size`` threads whose collectives go
    through one ``_Board``; returns each rank's result, raising the first
    rank's exception."""
    from repro_torch.distributed import tensor_parallel
    board = _Board(size)
    monkeypatch.setattr(tensor_parallel, "_all_reduce", board.all_reduce)
    out, errors = [None] * size, []

    def run(r):
        try:
            out[r] = fn(r, _Group(size, r))
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errors.append(e)
            board.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def test_norm_statistic_sums_to_the_whole_rmsnorm(monkeypatch):
    """The gated RMSNorm over 4 ranks, each with a quarter of ``d_inner``
    and its sum of squares all-reduced (``Route.norm_sum``): the ranks'
    outputs side by side are the whole ``rmsnorm(y * silu(z), w)``, and
    each rank's gradients of the global loss are its slices of the whole
    one's (the statistic's backward all-reduces the gradient)."""
    import torch.nn.functional as F

    from repro_torch.distributed.tensor_parallel import Route, plan
    from repro_torch.models.common import rmsnorm
    from repro_torch.models.mamba2 import gated_rmsnorm
    rng = np.random.default_rng(3)
    y, z, w, g = (torch.from_numpy(rng.standard_normal(s, np.float32))
                  for s in ((2, 5, 64), (2, 5, 64), (64,), (2, 5, 64)))
    leaves = [t.clone().requires_grad_(True) for t in (y, z, w)]
    whole = rmsnorm(leaves[0] * F.silu(leaves[1]), leaves[2], 1e-5)
    (whole * g).sum().backward()
    cfg = reduced("mamba2-1.3b", {})
    m = 4

    def rank(r, group):
        route = Route(plan(cfg, m, kind="prefill", seq_len=5), group)
        mine = [t.chunk(m, -1)[r].clone().requires_grad_(True)
                for t in (y, z, w)]
        out = gated_rmsnorm(*mine, 1e-5, 64, route.norm_sum)
        (out * g.chunk(m, -1)[r]).sum().backward()
        return out.detach(), [t.grad for t in mine]

    got = on_threads(m, rank, monkeypatch)
    torch.testing.assert_close(torch.cat([o for o, _ in got], -1),
                               whole.detach(), rtol=1e-6, atol=1e-6)
    for i, leaf in enumerate(leaves):
        torch.testing.assert_close(torch.cat([gr[i] for _, gr in got], -1),
                                   leaf.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stateful", [False, True])
def test_block_over_ranks_is_the_whole_block(monkeypatch, stateful):
    """``Route.ssm`` over 2 ranks (4 of 8 heads each), not
    sequence-parallel: the output is the whole block's, each rank's state
    its heads' (and its conv channels), and the gradients of the global
    loss are the whole's: the input's on every rank, each rank's heads'
    leaves its slices, and ``in_proj``'s, ``conv_w``'s and ``conv_b``'s
    the sum of the ranks' (B and C read by every head)."""
    from repro_torch.distributed.sharding import ssm_tail_layout
    from repro_torch.distributed.tensor_parallel import Route, plan
    from repro_torch.models.mamba2 import (MambaState, init_mamba2,
                                           mamba2_block)
    cfg = reduced("mamba2-1.3b", {})
    gen = torch.Generator().manual_seed(5)
    p = init_mamba2(gen, cfg)
    p = p._replace(norm_w=1 + 0.1 * torch.randn(p.norm_w.shape,
                                               generator=gen))
    T = 1 if stateful else 16
    x = torch.randn((2, T, cfg.d_model), generator=gen)
    g = torch.randn((2, T, cfg.d_model), generator=gen)
    state = None
    if stateful:
        state = MambaState(
            torch.randn((2, cfg.conv_kernel - 1, cfg.d_inner
                         + 2 * cfg.ssm_state), generator=gen),
            torch.randn((2, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                        generator=gen))

    def leaves(tree):
        return type(tree)(*(t.clone().requires_grad_(True) for t in tree))

    wp, wx = leaves(p), x.clone().requires_grad_(True)
    want, want_state = mamba2_block(wp, wx, cfg, state=state,
                                    return_state=True)
    (want * g).sum().backward()
    m, heads = 2, ("dt_bias", "A_log", "D", "norm_w", "out_proj")

    def rank(r, group):
        route = Route(plan(cfg, m, kind="decode" if stateful else "prefill",
                           seq_len=T), group)
        mine = p._replace(**{k: getattr(p, k).chunk(m, 0)[r]
                             for k in heads})
        mine, mx = leaves(mine), x.clone().requires_grad_(True)
        st = None if state is None else MambaState(
            ssm_tail_layout(state.conv_tail, m, cfg.d_inner).chunk(m, -1)[r],
            state.ssm.chunk(m, 1)[r])
        new = []

        def block(q, h, norm_sum):
            out, s = mamba2_block(q, h, cfg, state=st, return_state=True,
                                  norm_sum=norm_sum)
            new.append(s)
            return out

        out = route.ssm(block, mine, mx)
        (out * g).sum().backward()
        return out.detach(), new[0], mine, mx.grad

    got = on_threads(m, rank, monkeypatch)
    tol = dict(rtol=1e-5, atol=1e-5)
    for out, _, _, dx in got:
        torch.testing.assert_close(out, want.detach(), **tol)
        torch.testing.assert_close(dx, wx.grad, **tol)
    whole_tail = ssm_tail_layout(want_state.conv_tail, m, cfg.d_inner)
    for r, (_, st, _, _) in enumerate(got):
        torch.testing.assert_close(st.ssm, want_state.ssm.chunk(m, 1)[r],
                                   **tol)
        torch.testing.assert_close(st.conv_tail,
                                   whole_tail.chunk(m, -1)[r], **tol)
    for k in heads:
        torch.testing.assert_close(
            torch.cat([getattr(mine, k).grad for _, _, mine, _ in got], 0),
            getattr(wp, k).grad, **tol, msg=k)
    for k in ("in_proj", "conv_w", "conv_b"):
        torch.testing.assert_close(
            sum(getattr(mine, k).grad for _, _, mine, _ in got),
            getattr(wp, k).grad, **tol, msg=k)


def test_ssm_slice_takes_the_ranks_columns():
    """Rank r of 4 takes its heads' z, x and dt columns of ``in_proj`` and
    B and C whole, and its x channels and B and C of ``conv_w``/
    ``conv_b``; its slice's gradient is zero outside them. Over one rank
    the params are returned as they are."""
    from repro_torch.distributed.tensor_parallel import Route, plan
    from repro_torch.models.mamba2 import init_mamba2
    cfg = reduced("mamba2-1.3b", {})
    din, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    p = init_mamba2(torch.Generator().manual_seed(1), cfg)
    ch = din + 2 * N
    assert p.in_proj.shape[-1] == 2 * din + 2 * N + H
    p1 = Route(plan(cfg, 1, kind="train", seq_len=8), None).ssm_slice(p)
    assert p1 is p
    pl = plan(cfg, 4, kind="train", seq_len=8)
    for r in range(4):
        leaf = p.in_proj.clone().requires_grad_(True)
        q = Route(pl, _Group(4, r)).ssm_slice(p._replace(in_proj=leaf))
        xw, hw = din // 4, H // 4
        cols = (list(range(r * xw, (r + 1) * xw))
                + list(range(din + r * xw, din + (r + 1) * xw))
                + list(range(2 * din, din + ch))
                + list(range(din + ch + r * hw, din + ch + (r + 1) * hw)))
        assert torch.equal(q.in_proj, p.in_proj[:, cols])
        conv = list(range(r * xw, (r + 1) * xw)) + list(range(din, ch))
        assert torch.equal(q.conv_w, p.conv_w[:, conv])
        assert torch.equal(q.conv_b, p.conv_b[conv])
        q.in_proj.sum().backward()
        mask = torch.zeros_like(p.in_proj)
        mask[:, cols] = 1
        assert torch.equal(leaf.grad, mask)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_tp_cache_lays_the_conv_tail_out_by_rank(family):
    """Where m divides the SSM heads (mamba2 on (2, 4), zamba2 on (4, 2)),
    ``tp_cache`` gives the conv tail as m ranks' blocks [x_r, B, C],
    sharded on its last axis along "model", and the SSM state the
    reference's spec (heads along "model"); zamba2's KV cache (heads
    local) keeps its spec."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.logical import placements
    from repro_torch.models.transformer import build_model
    arch = "mamba2-1.3b" if family == "ssm" else "zamba2-2.7b"
    cfg = reduced(arch, {})

    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (2, 4) if family == "ssm" else (4, 2)

    m = Mesh.shape[1]
    cache = build_model(cfg, device="cpu").init_cache(4, 8)
    tail = cache["state"].conv_tail
    tail.copy_(torch.arange(tail.shape[-1], dtype=tail.dtype))
    got, specs = shd.tp_cache(cfg, Mesh(), cache)
    din, N = cfg.d_inner, cfg.ssm_state
    new = got["state"].conv_tail
    assert new.shape[-1] == m * (din // m + 2 * N)
    for r, block in enumerate(new.chunk(m, -1)):
        want = torch.cat([torch.arange(r * din // m, (r + 1) * din // m),
                          torch.arange(din, din + 2 * N)]).to(tail.dtype)
        assert torch.equal(block, want.expand_as(block))
    lead = new.ndim - 3
    assert specs["state"].conv_tail == shd.P(*(None,) * lead, "data", None,
                                             "model")
    assert placements(Mesh(), specs["state"].conv_tail)[1] == Shard(
        new.ndim - 1)
    assert specs["state"].ssm == shd.P(*(None,) * lead, "data", "model",
                                       None, None)
    if family == "hybrid":
        want = shd.fit_tree(Mesh(), shd.cache_specs(cfg, Mesh()), cache)
        assert specs["k"] == want["k"] and got["k"] is cache["k"]


# ---------------------------------------------------------------------------
# the plan where m does not divide the SSM heads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m", [2, 4, 16])
def test_ssm_plan_gathers_heads_that_do_not_divide(m):
    """A mamba2 of 3 SSM heads (d_model 96, head dim 64): "gathered" with
    all 3 heads on every rank, and the leaves' layouts whole along
    "model" (``in_proj`` and the heads' leaves alike); at m = 1 "local"."""
    from repro_torch.distributed.sharding import tp_layouts
    from repro_torch.distributed.tensor_parallel import plan
    cfg = reduced("mamba2-1.3b", dict(d_model=96, ssm_head_dim=64))
    p = plan(cfg, m, kind="train", seq_len=4 * m)
    assert (p.ssm, p.ssm_heads, p.heads, p.mlp_local) == ("gathered", 3,
                                                          None, None)
    assert plan(cfg, 1, kind="train", seq_len=8).ssm == "local"

    class Mesh:
        mesh_dim_names = ("data", "model")

    for leaf in tp_layouts(cfg, Mesh(), p)["layers"].mamba:
        compute, grad = leaf
        assert compute[1] == compute[0] and grad[1].is_partial()
