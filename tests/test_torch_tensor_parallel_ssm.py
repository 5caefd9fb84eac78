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
    group's recompute in the backward on the same route;
  * ``ssm_layout_whole``: ``ssm_local`` with a state width N of 9, which 2
    ranks do not divide: the heads local, ``in_proj``, ``conv_w`` and
    ``conv_b`` stored whole along "model" in the reference's order.
The first three store ``in_proj``, ``conv_w`` and ``conv_b`` by rank
(``sharding.ssm_rank_columns``): a rank holds its heads' block of
``in_proj``, d/data x d_proj/m, and no step all-gathers it along "model".
Each trains 3 AdamW steps, then serves a prefill and 8 greedy decode steps
from the initial weights. In this process: the gated RMSNorm's statistic
summed over 4 ranks (threads) against the whole RMSNorm, values and
gradient; the block over 2 ranks against the whole block; the plan where
m does not divide the SSM heads, or N; the by-rank layout, its inverse and
``ssm_slice`` on it against the whole leaf's slices; an AdamW and an
Adafactor step on a leaf in the by-rank order against the whole leaf's
step; the conv tail's layout. The plan at m = 16 is
``test_torch_tensor_parallel.py``'s table.
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
                          (4, 2), 32),
         "ssm_layout_whole": ("mamba2-1.3b", dict(MAMBA, ssm_state=9),
                              (4, 2), 32)}
# each case's plan: the "model" size, the attention's mode and local heads
# (None without attention), the MLP's, the vocab's, the SSM block's mode,
# heads a rank and layout, whether training is sequence-parallel; prefill
# and decode take the same modes, never sequence-parallel
PLANS = {"ssm_local": (2, None, None, None, "local", "local", 4, "by_rank",
                       True),
         "ssm_not_seq_parallel": (2, None, None, None, "local", "local", 4,
                                  "by_rank", False),
         "ssm_gathered": (4, None, None, None, "local", "gathered", 3,
                          "whole", True),
         "hybrid_local": (2, "local", [2, 1], "local", "local", "local", 4,
                          "by_rank", True),
         "ssm_layout_whole": (2, None, None, None, "local", "local", 4,
                              "whole", True)}


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
    m, heads, local_heads, mlp, vocab, ssm, ssm_heads, layout, sp = \
        PLANS[name]
    cfg = reduced(arch, over)

    def want(seq_parallel, rank):
        return {"model": m, "heads": heads, "local_heads": local_heads,
                "mlp": mlp, "vocab": vocab, "seq_parallel": seq_parallel,
                "ssm": ssm, "ssm_heads": ssm_heads, "ssm_layout": layout,
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


LOCAL_BY_RANK = ("ssm_local", "ssm_not_seq_parallel", "hybrid_local")


@pytest.mark.parametrize("name", LOCAL_BY_RANK + ("ssm_layout_whole",))
def test_in_proj_is_stored_and_gathered_by_its_layout(runs, name):
    """Where the layout is "by_rank" a rank's stored ``in_proj`` is its
    block, d/data x d_proj/m a layer, and no all-gather along "model" in a
    train step or a prefill makes a layer of it (d x d_proj, or d/data x
    d_proj): the only such all-gathers of the block are B's and C's, d x
    2N. Where it is "whole" (m does not divide N) the step gathers it
    along "model"."""
    _, ranks = runs
    arch, over, (data, model), _ = CASES[name]
    cfg = reduced(arch, over)
    d, n = cfg.d_model, cfg.ssm_state
    width = 2 * cfg.d_inner + 2 * n + cfg.ssm_heads
    lead = [cfg.n_layers] if cfg.family == "ssm" else [
        cfg.n_layers // cfg.attn_every, cfg.attn_every]
    layer = {4 * d * width, 4 * d * width // data}        # fp32 bytes
    for rec in ranks:
        assert list(rec[f"{name}/in_proj_block"]) == lead + [
            d // data, width // model]
        gathers = set(rec[f"{name}/model_gathers"].tolist())
        if name in LOCAL_BY_RANK:
            assert not gathers & layer, (gathers, layer)
            assert 4 * d * 2 * n in gathers, gathers
        else:
            assert gathers & layer, (gathers, layer)


# ---------------------------------------------------------------------------
# the pieces, in this process: ranks as threads over a stand-in group
# ---------------------------------------------------------------------------
class _Board:
    """The collectives of ``size`` threads, each a rank: an all-reduce
    waits for every rank's tensor and returns their sum (or max) to each,
    summed in rank order; the all-gather and reduce-scatter along axis 1
    of ``tensor_parallel``'s sequence collectives alike."""

    def __init__(self, size: int) -> None:
        self.size, self.parts = size, [None] * size
        self.barrier = threading.Barrier(size, timeout=60)

    def _every(self, x, group) -> list:
        self.parts[group.rank()] = x.detach().clone()
        self.barrier.wait()
        parts = list(self.parts)
        self.barrier.wait()
        return parts

    def all_reduce(self, x, op, group):
        parts = self._every(x, group)
        out = parts[0]
        for p in parts[1:]:
            out = out + p if op == "sum" else torch.maximum(out, p)
        return out

    def all_gather_seq(self, x, group):
        return torch.cat(self._every(x, group), 1)

    def reduce_scatter_seq(self, x, group):
        return self.all_reduce(x, "sum", group).chunk(
            self.size, 1)[group.rank()].contiguous()


def on_threads(size: int, fn, monkeypatch) -> list:
    """``fn(rank, group)`` on ``size`` threads whose collectives go
    through one ``_Board``; returns each rank's result, raising the first
    rank's exception."""
    from repro_torch.distributed import tensor_parallel
    board = _Board(size)
    monkeypatch.setattr(tensor_parallel, "_all_reduce", board.all_reduce)
    monkeypatch.setattr(tensor_parallel, "_all_gather_seq",
                        board.all_gather_seq)
    monkeypatch.setattr(tensor_parallel, "_reduce_scatter_seq",
                        board.reduce_scatter_seq)
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


def _mesh(data: int, model: int):
    """A stand-in ("data", "model") mesh: the spec functions read only its
    names and shape."""
    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (data, model)
    return Mesh()


def _rank_cols(cfg, m: int, r: int) -> tuple[list, list]:
    """Rank r's columns of ``in_proj`` and of the conv channels, in the
    reference's order, in the by-rank block's order: its heads' z, x (and
    dt), its N/m of B's and of C's."""
    din, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    xw, nw, hw = din // m, n // m, h // m

    def span(a, w):
        return list(range(a + r * w, a + (r + 1) * w))
    proj = (span(0, xw) + span(din, xw) + span(2 * din, nw)
            + span(2 * din + n, nw) + span(2 * din + 2 * n, hw))
    conv = span(0, xw) + span(din, nw) + span(din + n, nw)
    return proj, conv


@pytest.mark.parametrize("stateful", [False, True])
def test_block_over_ranks_is_the_whole_block(monkeypatch, stateful):
    """``Route.ssm`` over 2 ranks (4 of 8 heads each), not
    sequence-parallel, each rank's ``in_proj``, ``conv_w`` and ``conv_b``
    its block of the by-rank layout (``sharding.ssm_rank_columns``): the
    output is the whole block's, each rank's state its heads' (and its
    conv channels), and the gradients of the global loss are the whole's:
    the input's on every rank, each rank's heads' leaves its slices, and
    the ranks' blocks of ``in_proj``, ``conv_w`` and ``conv_b``, laid back
    in the reference's order, the whole leaves' (B's and C's summed over
    the ranks' heads by the all-gather's backward)."""
    from repro_torch.distributed.sharding import (ssm_rank_columns,
                                                  ssm_tail_layout)
    from repro_torch.distributed.tensor_parallel import Route, plan
    from repro_torch.models.mamba2 import (MambaState, init_mamba2,
                                           mamba2_block)
    cfg = reduced("mamba2-1.3b", {})
    gen = torch.Generator().manual_seed(5)
    p = init_mamba2(gen, cfg)
    p = p._replace(norm_w=1 + 0.1 * torch.randn(p.norm_w.shape,
                                               generator=gen),
                   conv_b=0.1 * torch.randn(p.conv_b.shape, generator=gen))
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
    order = dict(zip(("in_proj", "conv_w", "conv_b"),
                     (ssm_rank_columns(cfg, m)[i] for i in (0, 1, 1))))

    def rank(r, group):
        route = Route(plan(cfg, m, kind="decode" if stateful else "prefill",
                           seq_len=T), group)
        assert route.plan.ssm_layout == "by_rank"
        mine = p._replace(**{k: getattr(p, k).chunk(m, 0)[r]
                             for k in heads},
                          **{k: getattr(p, k)[..., o].chunk(m, -1)[r]
                             for k, o in order.items()})
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
    for k, o in order.items():
        blocks = torch.cat([getattr(mine, k).grad for _, _, mine, _ in got],
                           -1)
        torch.testing.assert_close(blocks[..., torch.argsort(o)],
                                   getattr(wp, k).grad, **tol, msg=k)


@pytest.mark.parametrize("m", [2, 4])
def test_ssm_slice_takes_the_ranks_columns(monkeypatch, m):
    """The by-rank layout over m ranks (a reduced mamba2: 8 heads, N 16).
    ``sharding.rank_order`` reorders a train state's ``in_proj``,
    ``conv_w`` and ``conv_b`` and AdamW's slots of them alike, leaves
    every other leaf as it is, and its inverse restores the state to the
    bit. The even cut of a reordered leaf along its columns gives rank r
    its heads' z, x and dt columns and its N/m of B's and of C's (the conv
    leaves its x channels and its B and C). On m threads, ``ssm_slice`` of
    the rank's blocks equals the rank's slice of the whole leaves (the
    "whole" layout's), and the blocks' gradients, laid back in the
    reference's order, are the sum of the whole slices' gradients over the
    ranks. Over one rank the params are returned as they are."""
    from dataclasses import replace

    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.tensor_parallel import Route, plan
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.transformer import build_model
    cfg = reduced("mamba2-1.3b", {})
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    slot = lambda: tree_map(lambda t: torch.randn(t.shape, generator=gen),
                            params)
    state = {"params": params,
             "opt": {"m": slot(), "v": slot(), "step": torch.tensor(3)}}
    mesh = _mesh(1, m)
    ordered = shd.rank_order(cfg, mesh, state)
    back = shd.rank_order(cfg, mesh, ordered, inverse=True)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                 tree_leaves(state)))
    moved = [a is not b for a, b in zip(tree_leaves(ordered),
                                        tree_leaves(state))]
    assert sum(moved) == 9                  # 3 leaves x (params, m, v)
    for tree, was in ((ordered["params"], params),
                      (ordered["opt"]["m"], state["opt"]["m"]),
                      (ordered["opt"]["v"], state["opt"]["v"])):
        new, old = tree["layers"].mamba, was["layers"].mamba
        for r in range(m):
            proj, conv = _rank_cols(cfg, m, r)
            assert torch.equal(new.in_proj.chunk(m, -1)[r],
                               old.in_proj[..., proj])
            assert torch.equal(new.conv_w.chunk(m, -1)[r],
                               old.conv_w[..., conv])
            assert torch.equal(new.conv_b.chunk(m, -1)[r],
                               old.conv_b[..., conv])

    layer = lambda tree: type(tree)(*(t[0] for t in tree))
    blocks, whole = (layer(ordered["params"]["layers"].mamba),
                     layer(params["layers"].mamba))
    pl = plan(cfg, m, kind="train", seq_len=8)
    assert pl.ssm_layout == "by_rank"
    assert Route(plan(cfg, 1, kind="train", seq_len=8),
                 None).ssm_slice(whole) is whole
    keys = ("in_proj", "conv_w", "conv_b")
    outs = [{k: torch.randn(getattr(whole, k).shape[:-1] + (w,),
                            generator=gen)
             for k, w in zip(keys, (2 * cfg.d_inner // m + 2 * cfg.ssm_state
                                    + cfg.ssm_heads // m,
                                    cfg.d_inner // m + 2 * cfg.ssm_state,
                                    cfg.d_inner // m + 2 * cfg.ssm_state))}
            for _ in range(m)]

    def rank(r, group):
        mine = blocks._replace(**{k: getattr(blocks, k).chunk(m, -1)[r]
                                  .clone().requires_grad_(True)
                                  for k in keys})
        ref = whole._replace(**{k: getattr(whole, k).clone()
                                .requires_grad_(True) for k in keys})
        got = Route(pl, group).ssm_slice(mine)
        want = Route(replace(pl, ssm_layout="whole"), group).ssm_slice(ref)
        for q in (got, want):
            sum((getattr(q, k) * outs[r][k]).sum() for k in keys).backward()
        return ({k: getattr(got, k).detach() for k in keys},
                {k: getattr(want, k).detach() for k in keys},
                {k: getattr(mine, k).grad for k in keys},
                {k: getattr(ref, k).grad for k in keys})

    got = on_threads(m, rank, monkeypatch)
    order = dict(zip(keys, (shd.ssm_rank_columns(cfg, m)[i]
                            for i in (0, 1, 1))))
    for k in keys:
        for r in range(m):
            assert torch.equal(got[r][0][k], got[r][1][k]), (k, r)
        grads = torch.cat([g[2][k] for g in got], -1)[
            ..., torch.argsort(order[k])]
        torch.testing.assert_close(grads, sum(g[3][k] for g in got),
                                   rtol=1e-6, atol=1e-6, msg=k)


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_optimizer_steps_commute_with_the_layout(opt_name):
    """One optimizer step on a reduced mamba2's state in the by-rank order
    (m = 4) equals the step on the whole state, reordered: AdamW is
    elementwise, Adafactor's factored slots follow their leaf (the column
    statistic reordered, the row statistic, a mean over the columns, as
    it is), and the global norm, the clip, Adafactor's means and its RMS
    clip are sums, which add in another order (fp32)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.transformer import build_model
    from repro_torch.train.optimizer import (OptimizerConfig,
                                             build_optimizer, global_norm)
    cfg = reduced("mamba2-1.3b", {})
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(4)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=gen), params)
    opt = build_optimizer(OptimizerConfig(name=opt_name, peak_lr=1e-2,
                                          warmup=1))
    mesh = _mesh(1, 4)
    runs = []
    for order in (False, True):
        state = {"params": tree_map(torch.clone, params),
                 "opt": opt.init(params)}
        g = grads
        if order:
            state = shd.rank_order(cfg, mesh, state)
            g = shd.rank_order(cfg, mesh, g)
        for _ in range(2):
            state["params"], state["opt"] = opt.update(
                g, state["opt"], state["params"], global_norm(g))
        if order:
            state = shd.rank_order(cfg, mesh, state, inverse=True)
        runs.append(state)
    whole, by_rank = runs
    if opt_name == "adafactor":
        assert any("col" in v for v in whole["opt"]["v"])
    for a, b in zip(tree_leaves(by_rank), tree_leaves(whole)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b"])
def test_layout_by_rank_only_where_m_divides_n(arch):
    """The plan's ``ssm_layout``: "by_rank" where m divides the SSM heads
    and N (the reduced configs' 8 heads and N 16 at m = 2 and 4, and at
    m = 1, where the order is the reference's), "whole" where it divides
    the heads and not N (N 9 at m = 2), "whole" where the heads are
    gathered (m = 16). ``tp_layouts`` computes a by-rank leaf on its
    columns along "model", its gradient the block's own, a "whole" one
    whole, its gradient a partial sum; ``rank_order`` leaves a "whole"
    state as it is."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.tensor_parallel import plan
    from repro_torch.models.transformer import build_model
    lead = 1 if arch == "mamba2-1.3b" else 2
    for over, m, layout in (({}, 1, "by_rank"), ({}, 2, "by_rank"),
                            ({}, 4, "by_rank"),
                            (dict(ssm_state=9), 2, "whole"),
                            ({}, 16, "whole")):
        cfg = reduced(arch, over)
        p = plan(cfg, m, kind="train", seq_len=32)
        assert p.ssm_layout == layout, (over, m)
        assert p.record()["ssm_layout"] == layout
        mamba = shd.tp_layouts(cfg, _mesh(2, m), p)["layers"].mamba
        for k, dim in (("in_proj", lead + 1), ("conv_w", lead + 1),
                       ("conv_b", lead)):
            compute, grad = getattr(mamba, k)
            if layout == "by_rank":
                assert compute == [Replicate(), Shard(dim)], k
                assert grad == [Partial(), Shard(dim)], k
            else:
                assert compute == [Replicate(), Replicate()], k
                assert grad[1].is_partial(), k
        if layout == "whole":
            params = build_model(cfg, device="cpu").init(
                torch.Generator().manual_seed(0))
            assert shd.rank_order(cfg, _mesh(2, m), params) is params


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
