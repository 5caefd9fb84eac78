"""The port's distributed layer against the reference's
(``repro/distributed/``, ``repro/models/moe_ep.py``).

Spec trees, ``fit_spec`` and int8 quantization are compared in this
process. Everything that needs ranks runs once, in a module fixture: the
reference in one subprocess on an 8-device host platform (as
``tests/test_distributed.py`` runs it), then the port in 8 gloo processes
on a 4 x 2 ``("data", "model")`` mesh and in one more alone, each writing
what it computed to an ``.npz``. The reference's own sharded step fails in
this JAX (a ``ShardingTypeError`` at the vocab-sharded embedding gather),
so the port's sharded step is held to the reference's single-device step,
as that test compares with it anyway.

Inputs (batches, MoE weights and tokens, the pipeline's stack) are made
with numpy from seeds; the smollm weights come from the reference's
``init`` through the weight bridge.
"""
import datetime
import logging
import os
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist

from torch_worlds import World
from torch_worlds import run_reference as run_limited

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["phi3-mini-3.8b", "minitron-4b", "smollm-360m", "smollm-135m",
         "whisper-tiny", "kimi-k2-1t-a32b", "qwen2-moe-a2.7b", "zamba2-2.7b",
         "llava-next-34b", "mamba2-1.3b", "llama-3.2-1b", "llama-3.1-8b"]
MESHES = {"data4-model2": {"data": 4, "model": 2},
          "pod2-data4-model2": {"pod": 2, "data": 4, "model": 2}}
# the reduced smollm of tests/test_distributed.py's sharded step
SMOLLM = dict(n_layers=2, d_model=64, vocab_size=256, d_ff=128, n_heads=4,
              n_kv_heads=2, head_dim=16)
STEPS, BATCH, SEQ = 3, 8, 32
# the reduced MoE of tests/test_distributed.py's EP test; each case: (n
# experts, capacity factor, tokens (B, T))
MOE = dict(d_model=32, d_ff=16, top_k=2, n_shared_experts=0)
EP_CASES = {"cf8": (8, 8.0, (8, 4)),          # no drops: the grouped path too
            "cf1.25": (8, 1.25, (8, 64)),     # drops per source shard
            "pad6to8": (6, 8.0, (8, 4)),      # E 6 padded to the EP group 8
            "ragged": (8, 8.0, (3, 5))}       # 15 tokens padded to 16
# the reference's moe_block_ep raises in this JAX where the tokens do not
# divide over the group (a ShardingTypeError at its ``out[:n]``), so the
# port's padding is held to its own local dispatch
REF_EP_CASES = sorted(set(EP_CASES) - {"ragged"})
PIPE_L, PIPE_D, PIPE_M = 8, 16, 6
# each process's limit from its own start (``torch_worlds``)
REF_LIMIT_S, RANK_LIMIT_S = 600, 450


# ---------------------------------------------------------------------------
# inputs, made with numpy from seeds
# ---------------------------------------------------------------------------
def make_inputs() -> dict:
    from repro_torch.train.data import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(SMOLLM["vocab_size"], SEQ, BATCH, seed=0))
    rng = np.random.default_rng(7)
    out = {}
    for i in range(STEPS):
        for k, v in data.batch(i).items():
            out[f"batch{i}/{k}"] = v.numpy()
    # step 1: ragged masks, and the second data rank's two rows masked out
    lens = rng.integers(1, SEQ, BATCH)
    mask = (np.arange(SEQ)[None, :] < lens[:, None]).astype(np.int32)
    mask[2:4] = 0
    out["batch1/loss_mask"] = mask
    for name, (E, _, (B, T)) in EP_CASES.items():
        d, ff = MOE["d_model"], MOE["d_ff"]
        out[f"ep/{name}/router"] = rng.standard_normal((d, E), np.float32) \
            / np.float32(np.sqrt(d))
        for w, shape in (("w_gate", (8, d, ff)), ("w_up", (8, d, ff)),
                         ("w_down", (8, ff, d))):
            out[f"ep/{name}/{w}"] = rng.standard_normal(shape, np.float32) \
                / np.float32(np.sqrt(shape[1]))
        out[f"ep/{name}/x"] = rng.standard_normal((B, T, d), np.float32)
    out["pipe/ws"] = rng.standard_normal(
        (PIPE_L, PIPE_D, PIPE_D), np.float32) * 0.5
    out["pipe/x"] = rng.standard_normal((PIPE_M, 4, PIPE_D), np.float32)
    return out


# ---------------------------------------------------------------------------
# the reference, in one subprocess on 8 host devices
# ---------------------------------------------------------------------------
REF_CODE = textwrap.dedent("""
    import sys
    from dataclasses import replace
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.distributed import logical
    from repro.distributed.pipeline import pipeline, split_stages
    from repro.models import moe_ep
    from repro.models.ffn import MoEParams, moe_block
    from repro.models.transformer import build_model
    from repro.train.optimizer import OptimizerConfig, build_optimizer
    from repro.train.train_step import build_train_step

    SMOLLM, STEPS, MOE, EP_CASES, REF_EP_CASES, PIPE_L = {consts}
    inp = np.load(sys.argv[1])
    out = {{}}

    # the single-device train step of tests/test_distributed.py
    cfg = get_config("smollm-135m").reduced(**SMOLLM)
    model = build_model(cfg)
    opt = build_optimizer(OptimizerConfig(peak_lr=1e-3))
    params = model.init(jax.random.key(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                       for k in path)
        out["params/" + key] = np.asarray(leaf)
    state = {{"params": params, "opt": opt.init(params)}}
    step = jax.jit(build_train_step(model, opt))
    for i in range(STEPS):
        batch = {{k: jnp.asarray(inp[f"batch{{i}}/{{k}}"])
                 for k in ("tokens", "labels", "loss_mask")}}
        state, m = step(state, batch)
        out[f"loss{{i}}"] = np.asarray(m["loss"])
        out[f"grad_norm{{i}}"] = np.asarray(m["grad_norm"])

    # expert parallelism on a (4, 2) mesh, and the grouped dispatch
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    for name in REF_EP_CASES:
        E, cf, _ = EP_CASES[name]
        base = get_config("qwen2-moe-a2.7b").reduced(
            n_experts=E, capacity_factor=cf, **MOE)
        cfg_ep = replace(base, moe_impl="ep", moe_pad_experts=8,
                         moe_groups=1)
        p = MoEParams(*(jnp.asarray(inp[f"ep/{{name}}/{{w}}"]) for w in
                        ("router", "w_gate", "w_up", "w_down")), None)
        x = jnp.asarray(inp[f"ep/{{name}}/x"])
        logical.install(mesh)
        with mesh:
            o, aux = jax.jit(lambda p, x: moe_block(p, x, cfg_ep))(p, x)
        logical.clear()
        out[f"ep/{{name}}/out"], out[f"ep/{{name}}/aux"] = \\
            np.asarray(o), np.asarray(aux)
        o, aux = moe_block(p, x, replace(base, moe_impl="gspmd",
                                         moe_groups=8))
        out[f"grouped/{{name}}/out"], out[f"grouped/{{name}}/aux"] = \\
            np.asarray(o), np.asarray(aux)
        # the dropped (token, choice) pairs: moe_ep.py:61-79's own lines
        # on each source shard, in the flat (token, choice) order
        B, T, d = x.shape
        ep, k, E_pad = 8, base.top_k, 8
        n_pad = -(-B * T // ep) * ep
        n_loc = n_pad // ep
        C = moe_ep._capacity(n_loc, base, E_pad)
        xt = jnp.concatenate([x.reshape(-1, d),
                              jnp.zeros((n_pad - B * T, d))])
        dropped = []
        for r in range(ep):
            probs = jax.nn.softmax(xt[r * n_loc:(r + 1) * n_loc] @ p.router,
                                   axis=-1)
            _, ids = jax.lax.top_k(probs, k)
            flat_e = ids.reshape(-1)
            order = jnp.argsort(flat_e, stable=True)
            sorted_e = flat_e[order]
            first = jnp.searchsorted(sorted_e, jnp.arange(E_pad), side="left")
            keep = (jnp.arange(n_loc * k) - first[sorted_e]) < C
            dropped.append(np.asarray(jnp.zeros(n_loc * k, bool)
                                      .at[order].set(~keep)))
        out[f"ep/{{name}}/dropped"] = np.stack(dropped)

    # the GPipe schedule over 4 stages
    def layer(w, x):
        return jnp.tanh(x @ w)

    def stage_fn(stage_w, x):
        x, _ = jax.lax.scan(lambda x, w: (layer(w, x), None), x, stage_w)
        return x

    ws, x = jnp.asarray(inp["pipe/ws"]), jnp.asarray(inp["pipe/x"])
    run = pipeline(stage_fn, jax.make_mesh((4,), ("stage",)),
                   n_microbatches=x.shape[0])
    out["pipe/out"] = np.asarray(jax.jit(run)(split_stages(ws, 4), x))
    want = x
    for i in range(PIPE_L):
        want = layer(ws[i], want)
    out["pipe/sequential"] = np.asarray(want)
    np.savez(sys.argv[2], **out)
""")


def run_reference(inputs_path: str, out_path: str) -> None:
    consts = repr((SMOLLM, STEPS, MOE, EP_CASES, REF_EP_CASES, PIPE_L))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    run_limited("the reference's steps on 8 host devices",
                [sys.executable, "-c", REF_CODE.format(consts=consts),
                 inputs_path, out_path], env,
                os.path.splitext(out_path)[0] + ".log", REF_LIMIT_S)


# ---------------------------------------------------------------------------
# the port, in gloo processes
# ---------------------------------------------------------------------------
def spec_slice(mesh, full: torch.Tensor, spec) -> torch.Tensor:
    """The block of ``full`` that this rank holds under ``spec``, read off
    the spec as the reference reads it: dim i is cut into as many blocks
    as its axes' sizes multiply to, and the block index is this rank's
    coordinate along those axes, the first major."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else entry or ()
        n, idx = 1, 0
        for a in axes:
            n, idx = n * sizes[a], idx * sizes[a] + coord[a]
        step = full.shape[i] // n
        full = full.narrow(i, idx * step, step)
    return full


def port_smollm(inp: dict):
    """(reduced smollm model, its params from the reference's init)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import build_model
    from repro_torch.weights import dense_params_from_flat
    cfg = get_config("smollm-135m").reduced(**SMOLLM)
    flat = {k[len("params/"):]: v for k, v in inp.items()
            if k.startswith("params/")}
    return (build_model(cfg, device="cpu"),
            dense_params_from_flat(flat, cfg, "cpu"))


def port_batch(inp: dict, i: int) -> dict:
    return {k: torch.from_numpy(inp[f"batch{i}/{k}"].copy())
            for k in ("tokens", "labels", "loss_mask")}


def optimizer_of(name: str):
    from repro_torch.train.optimizer import OptimizerConfig, build_optimizer
    return build_optimizer(OptimizerConfig(name=name, peak_lr=1e-3))


# name -> (optimizer, compress, grad_accum)
RUNS = {"adamw": ("adamw", False, 1), "compressed": ("adamw", True, 1),
        "adafactor": ("adafactor", False, 1), "accum2": ("adamw", False, 2)}


def train_runs(inp: dict, mesh=None, record=None) -> dict:
    """Every run of ``RUNS`` for ``STEPS`` steps from the bridged params:
    single-process (``mesh`` None) or sharded on ``mesh``. Returns each
    run's losses, grad norms and final params (whole leaves) by key; on a
    mesh, ``record`` also gets each run's largest difference between a
    rank's placed shard and the spec's block of the whole leaf."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.compression import \
        make_error_feedback_compressor
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.train_step import build_train_step
    out = {}
    for name, (opt_name, compress, accum) in RUNS.items():
        model, params = port_smollm(inp)
        opt = optimizer_of(opt_name)
        state = {"params": params, "opt": opt.init(params)}
        hook = make_error_feedback_compressor() if compress else None
        if mesh is None:
            step = build_train_step(model, opt, compress=hook,
                                    grad_accum=accum)
        else:
            pspecs = shd.fit_tree(mesh, shd.param_specs(model.cfg, mesh),
                                  params)
            specs = shd.train_state_specs(state, opt_name, pspecs)
            whole = tree_leaves(state)
            state = shd.place(state, shd.to_named(mesh, specs))
            record[f"{name}/shard_err"] = max(
                float((t.to_local() - spec_slice(mesh, w, s)).abs().max())
                for t, w, s in zip(tree_leaves(state), whole,
                                   _spec_leaves(specs)))
            step = shd.shard_train_step(model, opt, mesh, compress=hook,
                                        grad_accum=accum)
        for i in range(STEPS):
            state, m = step(state, port_batch(inp, i))
            out[f"{name}/loss{i}"] = m["loss"].numpy()
            out[f"{name}/grad_norm{i}"] = m["grad_norm"].numpy()
        for j, p in enumerate(tree_leaves(state["params"])):
            out[f"{name}/param{j}"] = (p.full_tensor() if mesh is not None
                                       else p).numpy()
        if compress:
            for j, r in enumerate(tree_leaves(state["compress_residual"])):
                out[f"{name}/residual{j}"] = (
                    r.full_tensor() if mesh is not None else r).numpy()
    return out


def _spec_leaves(spec_tree) -> list:
    """The specs of a spec tree in ``tree_leaves`` order of the tree it
    describes (dict keys sorted)."""
    from repro_torch.distributed.logical import P
    if isinstance(spec_tree, P):
        return [spec_tree]
    if isinstance(spec_tree, dict):
        return [s for k in sorted(spec_tree)
                for s in _spec_leaves(spec_tree[k])]
    if isinstance(spec_tree, (list, tuple)):
        return [s for t in spec_tree for s in _spec_leaves(t)]
    return []


def ep_runs(inp: dict, mesh, record: dict) -> None:
    """``moe_block_ep`` on every EP case; ``moe_block`` with and without a
    policy installed, counting the EP calls; each rank's dropped pairs."""
    from repro_torch.distributed import logical
    from repro_torch.models import ffn, moe_ep
    for name in EP_CASES:
        cfg, p, x = ep_case(inp, name, moe_impl="ep", moe_pad_experts=8,
                            moe_groups=1)
        o, aux = moe_ep.moe_block_ep(p, x, cfg, mesh)
        record[f"ep/{name}/out"], record[f"ep/{name}/aux"] = \
            o.numpy(), aux.numpy()
        B, T, d = x.shape
        n_pad = -(-B * T // 8) * 8
        n_loc, r = n_pad // 8, dist.get_rank()
        xt = torch.cat([x.reshape(-1, d), x.new_zeros((n_pad - B * T, d))])
        C = moe_ep._capacity(n_loc, cfg, 8)
        *_, dest = moe_ep.local_plan(p, xt[r * n_loc:(r + 1) * n_loc], cfg,
                                     8, C)
        record[f"ep/{name}/dropped"] = (dest[0] == 8 * C).numpy()
        if name == "cf8":
            calls = []
            block = moe_ep.moe_block_ep
            moe_ep.moe_block_ep = lambda *a: calls.append(1) or block(*a)
            try:
                with logical.policy(mesh):
                    o_policy, _ = ffn.moe_block(p, x, cfg)
                record["policy/ep_calls"] = np.array(len(calls))
                o_local, _ = ffn.moe_block(p, x, cfg)
                record["no_policy/ep_calls"] = np.array(len(calls))
            finally:
                moe_ep.moe_block_ep = block
            record["policy/out"] = o_policy.numpy()
            record["no_policy/out"] = o_local.numpy()


def pipeline_runs(inp: dict, record: dict) -> None:
    """The GPipe schedule over the 4 stages of a (4, 2) ("stage", "data")
    mesh (two pipelines side by side), the stack placed as DTensors and as
    whole tensors."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.logical import P
    from repro_torch.distributed.pipeline import pipeline, split_stages
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("stage", "data"))

    def stage_fn(stage_w, x):
        for w in stage_w:
            x = torch.tanh(x @ w)
        return x

    ws = split_stages(torch.from_numpy(inp["pipe/ws"].copy()), 4)
    x = torch.from_numpy(inp["pipe/x"].copy())
    run = pipeline(stage_fn, mesh, n_microbatches=x.shape[0])
    record["pipe/whole"] = run(ws, x).numpy()
    placed = shd.place(ws, shd.NamedSharding(mesh, tuple(
        shd.placements(mesh, P("stage")))))
    record["pipe/placed"] = run(placed, x).numpy()


def compression_runs(mesh, record: dict) -> None:
    """A (16, 12) leaf sharded over both mesh axes compressed as a DTensor,
    and each shard's own scale (the per-shard result, which differs)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.compression import (
        make_error_feedback_compressor, quantize_int8)
    from repro_torch.distributed.logical import P
    rng = np.random.default_rng(11)
    g = torch.from_numpy(rng.standard_normal((16, 12), np.float32))
    g[0, 0] = 9.0                  # the whole leaf's max lies on rank 0
    dg = distribute_tensor(g, mesh, shd.placements(mesh, P("data", "model")))
    q, scale = quantize_int8(dg)
    record["comp/q"], record["comp/scale"] = (q.full_tensor().numpy(),
                                              scale.full_tensor().numpy())
    record["comp/shard_scale"] = quantize_int8(dg.to_local())[1].numpy()
    comp = make_error_feedback_compressor()
    cg, resid = comp({"w": dg}, None)
    cg, resid = comp({"w": dg}, resid)
    record["comp/ef_grad"] = cg["w"].full_tensor().numpy()
    record["comp/ef_resid"] = resid["w"].full_tensor().numpy()


def logical_runs(mesh, record: dict) -> None:
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.distributed import logical
    x = torch.ones(8, 4, 6)
    dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    with logical.policy(mesh):
        record["logical/plain_is_same"] = np.array(
            logical.constrain(x, "batch", None, "heads") is x)
        c = logical.constrain(dx, "batch", None, "heads")
        record["logical/placements"] = np.array(repr(c.placements))
        record["logical/active"] = np.array(logical.active())
    record["logical/cleared"] = np.array(
        logical.constrain(dx, "batch", None, "heads") is dx
        and not logical.active())


def _rank_main(rank: int, world: int, store: str, inputs: str,
               out_dir: str) -> None:
    """One gloo rank: every multi-rank case, written to rank<r>.npz."""
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    # DTensor warns that a norm over a leaf sharded on both axes takes two
    # all-reduces
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        inp = dict(np.load(inputs))
        record = {}
        if world == 1:
            mesh = init_device_mesh("cpu", (1, 1),
                                    mesh_dim_names=("data", "model"))
            record.update(train_runs(inp, mesh, record))
        else:
            mesh = init_device_mesh("cpu", (4, 2),
                                    mesh_dim_names=("data", "model"))
            record.update(train_runs(inp, mesh, record))
            ep_runs(inp, mesh, record)
            pipeline_runs(inp, record)
            compression_runs(mesh, record)
            logical_runs(mesh, record)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **record)
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, tmp, inputs: str) -> list[dict]:
    """``_rank_main`` on ``world`` gloo processes; a rank's exception fails
    the caller with its traceback, and a run past ``RANK_LIMIT_S`` from its
    start is killed and fails (``torch_worlds.World``)."""
    out_dir = tmp / f"world{world}"
    out_dir.mkdir()
    return World(f"the port's world of {world}", _rank_main, world,
                 (world, str(tmp / f"store{world}"), inputs, str(out_dir)),
                 out_dir, RANK_LIMIT_S).join()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's outputs, the port's single-process train
    runs, the 8 ranks' records, the lone rank's record)."""
    tmp = tmp_path_factory.mktemp("distributed")
    np.savez(tmp / "inputs.npz", **make_inputs())
    run_reference(str(tmp / "inputs.npz"), str(tmp / "ref.npz"))
    ref = dict(np.load(tmp / "ref.npz"))
    inp = {**dict(np.load(tmp / "inputs.npz")),
           **{k: v for k, v in ref.items() if k.startswith("params/")}}
    np.savez(tmp / "port_inputs.npz", **inp)
    ranks = spawn_ranks(8, tmp, str(tmp / "port_inputs.npz"))
    alone = spawn_ranks(1, tmp, str(tmp / "port_inputs.npz"))[0]
    return inp, ref, train_runs(inp), ranks, alone


# ---------------------------------------------------------------------------
# specs, in this process
# ---------------------------------------------------------------------------
class RefMesh:
    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


class PortMesh:
    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


def plain(tree):
    """A spec tree of either package as nested dicts, (type name, fields)
    and tuples of entries, for an exact comparison."""
    from jax.sharding import PartitionSpec

    from repro_torch.distributed.logical import P
    if isinstance(tree, (P, PartitionSpec)):
        return ("P",) + tuple(tree)
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__name__,
                {f: plain(getattr(tree, f)) for f in tree._fields})
    if isinstance(tree, (list, tuple)):
        return [plain(t) for t in tree]
    return tree


def test_fit_spec_divisibility():
    """``tests/test_distributed.py::test_fit_spec_divisibility``'s cases."""
    from repro_torch.distributed.logical import P
    from repro_torch.distributed.sharding import fit_spec
    m = PortMesh({"data": 4, "model": 2})
    assert fit_spec(m, P("data", "model"), (8, 4)) == P("data", "model")
    assert fit_spec(m, P("data", "model"), (7, 4)) == P(None, "model")
    assert fit_spec(m, P("model", None), (51865, 4)) == P(None, None)
    # multi-axis falls back to a single axis that divides
    assert fit_spec(m, P(("data", "model"), None), (6, 4)) == \
        P(("model",), None)
    assert fit_spec(m, P(("data", "model"),), (4,)) == P(("data",))


TREES = ["params", "fitted_params", "cache", "batch", "adamw", "adafactor"]


@pytest.fixture(scope="module")
def ref_shapes():
    """arch -> the reference model's abstract params."""
    import jax

    from repro.configs import get_config
    from repro.models.transformer import build_model
    cache = {}

    def shapes(arch):
        if arch not in cache:
            model = build_model(get_config(arch))
            cache[arch] = jax.eval_shape(model.init, jax.random.key(0))
        return cache[arch]
    return shapes


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_match_reference(arch, mesh, tree, ref_shapes):
    """The port's spec trees equal the reference's entry for entry, for
    every config on both fake meshes (the fitted params and the optimizer
    slots on the full config's param shapes)."""
    from repro.configs import get_config as ref_get_config
    from repro.distributed import sharding as rshd
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    rm, pm = RefMesh(MESHES[mesh]), PortMesh(MESHES[mesh])
    rp, pp = rshd.param_specs(rcfg, rm), shd.param_specs(cfg, pm)
    shapes = ref_shapes(arch)
    # the reference's shapes in the port's structure (matched by position)
    port_shapes = shd.map_specs(lambda s, x: x, pp, shapes)
    batch = dict.fromkeys(["tokens", "labels", "loss_mask"] + {
        "encdec": ["frames"], "vlm": ["patch_embeds"]}.get(cfg.family, []))
    got, want = {
        "params": lambda: (pp, rp),
        "fitted_params": lambda: (shd.fit_tree(pm, pp, port_shapes),
                                  rshd.fit_tree(rm, rp, shapes)),
        "cache": lambda: (shd.cache_specs(cfg, pm),
                          rshd.cache_specs(rcfg, rm)),
        "batch": lambda: (shd.batch_specs(cfg, pm, batch),
                          rshd.batch_specs(rcfg, rm, batch)),
        "adamw": lambda: (shd.opt_state_specs("adamw", pp, port_shapes),
                          rshd.opt_state_specs("adamw", rp, shapes)),
        "adafactor": lambda: (
            shd.opt_state_specs("adafactor", pp, port_shapes),
            rshd.opt_state_specs("adafactor", rp, shapes)),
    }[tree]()
    assert plain(got) == plain(want)


# ---------------------------------------------------------------------------
# compression, in this process
# ---------------------------------------------------------------------------
def quant_input(case: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096).astype(np.float32) * 3.0
    if case == "halves":          # scale 1.0, x / scale exact halves: the
        x = (np.arange(-254, 255) * 0.5).astype(np.float32)  # ties to even
    elif case == "tiny":           # under the 1e-12 floor of the scale
        x = x * 1e-14
    elif case == "zeros":
        x = np.zeros(64, np.float32)
    elif case == "bf16":
        x = np.asarray(torch.from_numpy(x).to(torch.bfloat16).float())
    return x


@pytest.mark.parametrize("case", ["normal", "halves", "tiny", "zeros",
                                  "bf16"])
def test_quantize_int8_matches_reference_bits(case):
    import jax.numpy as jnp

    from repro.distributed import compression as rcomp
    from repro_torch.distributed.compression import (dequantize_int8,
                                                     quantize_int8)
    x = quant_input(case)
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    q, scale = quantize_int8(torch.from_numpy(x).to(dtype))
    rq, rscale = rcomp.quantize_int8(jnp.asarray(x, dtype=(
        jnp.bfloat16 if case == "bf16" else jnp.float32)))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert scale.item() == float(rscale)
    np.testing.assert_array_equal(
        dequantize_int8(q, scale).numpy(),
        np.asarray(rcomp.dequantize_int8(rq, rscale)))


def test_error_feedback_is_unbiased_over_time():
    """``tests/test_distributed.py::test_grad_compression_error_feedback``
    on the port: the round trip within half an int8 step, and over 50
    steps the compressed signal averages to the true one (rtol 1e-3)."""
    from repro_torch.distributed.compression import (
        dequantize_int8, make_error_feedback_compressor, quantize_int8)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        256).astype(np.float32) * 3.0)
    q, s = quantize_int8(x)
    np.testing.assert_allclose(dequantize_int8(q, s).numpy(), x.numpy(),
                               atol=float(s) * 0.51)
    comp = make_error_feedback_compressor()
    g = {"w": torch.ones(64) * 0.3333}
    total, resid = torch.zeros(64), None
    for _ in range(50):
        cg, resid = comp(g, resid)
        total = total + cg["w"]
    np.testing.assert_allclose(total.numpy() / 50.0, 0.3333, rtol=1e-3)


def test_compressor_matches_reference_bits():
    """Five steps of the hook on a tree of an fp32 and a bf16 leaf: the
    same compressed gradients (in the leaf's dtype) and fp32 residuals as
    the reference's, bit for bit."""
    import jax.numpy as jnp

    from repro.distributed import compression as rcomp
    from repro_torch.distributed.compression import \
        make_error_feedback_compressor
    rng = np.random.default_rng(5)
    comp, rcomp_fn = (make_error_feedback_compressor(),
                      rcomp.make_error_feedback_compressor())
    resid = rresid = None
    for _ in range(5):
        a = rng.standard_normal((32, 8)).astype(np.float32)
        b = np.asarray(torch.from_numpy(rng.standard_normal(40).astype(
            np.float32)).to(torch.bfloat16).float())
        g = {"a": torch.from_numpy(a), "b": torch.from_numpy(b).bfloat16()}
        cg, resid = comp(g, resid)
        rcg, rresid = rcomp_fn({"a": jnp.asarray(a),
                                "b": jnp.asarray(b, jnp.bfloat16)}, rresid)
        for k in ("a", "b"):
            assert cg[k].dtype == g[k].dtype
            assert resid[k].dtype == torch.float32
            np.testing.assert_array_equal(cg[k].float().numpy(),
                                          np.asarray(rcg[k], np.float32))
            np.testing.assert_array_equal(resid[k].numpy(),
                                          np.asarray(rresid[k]))


def test_sharded_leaf_compresses_like_the_whole_leaf(runs):
    """On 8 ranks a leaf sharded over both axes gets the whole leaf's
    scale (a max over the mesh) and the same int8 bits; a shard's own
    scale, the result the trap gives, differs on the ranks that lack the
    leaf's max."""
    from repro_torch.distributed.compression import (
        make_error_feedback_compressor, quantize_int8)
    *_, ranks, _ = runs
    rng = np.random.default_rng(11)
    g = torch.from_numpy(rng.standard_normal((16, 12), np.float32))
    g[0, 0] = 9.0
    q, scale = quantize_int8(g)
    comp = make_error_feedback_compressor()
    cg, resid = comp({"w": g}, None)
    cg, resid = comp({"w": g}, resid)
    for rec in ranks:
        np.testing.assert_array_equal(rec["comp/q"], q.numpy())
        assert rec["comp/scale"] == scale.item()
        np.testing.assert_array_equal(rec["comp/ef_grad"], cg["w"].numpy())
        np.testing.assert_array_equal(rec["comp/ef_resid"],
                                      resid["w"].numpy())
    assert sum(rec["comp/shard_scale"] != scale.item() for rec in ranks) == 7


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------
def test_single_process_step_matches_reference(runs):
    """The port's single-process AdamW step from the bridged params on the
    same batches: the reference's single-device losses within 1e-5."""
    _, ref, single, _, _ = runs
    for i in range(STEPS):
        np.testing.assert_allclose(single[f"adamw/loss{i}"], ref[f"loss{i}"],
                                   rtol=1e-5)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_sharded_step_matches_single_process(runs, name):
    """8 ranks on a 4 x 2 mesh: losses and grad norms within 1e-5 relative
    of the single-process step's (the second batch has ragged masks and
    one data rank's rows all masked out), params after 3 steps within 2e-5,
    every rank reporting the same.

    The compressed run's residuals too, but for ties: a corrected gradient
    within float noise (sums in another order) of a half step of the int8
    grid rounds one way here and the other way there, and its residual is
    then about +scale/2 in one run and -scale/2 in the other. Such pairs
    sum to within 2e-5 of 0, and at most 1e-3 of a leaf's elements may be
    one. A scale taken over a shard instead of the whole leaf moves every
    residual of the shards without the leaf's max."""
    _, _, single, ranks, _ = runs
    for rec in ranks:
        for i in range(STEPS):
            for m in ("loss", "grad_norm"):
                np.testing.assert_allclose(rec[f"{name}/{m}{i}"],
                                           single[f"{name}/{m}{i}"],
                                           rtol=1e-5)
        params = [k for k in single if k.startswith(f"{name}/param")]
        assert params
        for k in params:
            np.testing.assert_allclose(rec[k], single[k], atol=2e-5, rtol=0)
        for k in (k for k in single if k.startswith(f"{name}/residual")):
            off = np.abs(rec[k] - single[k]) > 2e-5
            assert off.mean() <= 1e-3, k
            np.testing.assert_allclose(rec[k][off], -single[k][off],
                                       atol=2e-5, rtol=0)


def test_sharded_step_matches_reference(runs):
    """The sharded AdamW losses within 1e-5 relative of the reference's
    single-device ``jax.jit(build_train_step)`` on the same params and
    batches."""
    _, ref, _, ranks, _ = runs
    for i in range(STEPS):
        np.testing.assert_allclose(ranks[0][f"adamw/loss{i}"],
                                   ref[f"loss{i}"], rtol=1e-5)
        np.testing.assert_allclose(ranks[0][f"adamw/grad_norm{i}"],
                                   ref[f"grad_norm{i}"], rtol=1e-5)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_placed_shards_are_the_specs_blocks(runs, name):
    """After ``place`` each rank's local shard of every leaf (params and
    optimizer state) is exactly the block its spec names."""
    *_, ranks, _ = runs
    for rec in ranks:
        assert rec[f"{name}/shard_err"] == 0.0


@pytest.mark.parametrize("name", sorted(RUNS))
def test_one_rank_is_bit_identical(runs, name):
    """A (1, 1) mesh, as on one card: the sharded step's losses, grad
    norms, params and residuals are the single-process step's bits."""
    *_, single, _, alone = runs
    keys = [k for k in single if k.startswith(f"{name}/")]
    for k in keys:
        np.testing.assert_array_equal(alone[k], single[k], err_msg=k)


# ---------------------------------------------------------------------------
# the pipeline and expert parallelism
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["whole", "placed"])
def test_pipeline_matches_reference_and_sequential(runs, layout):
    """GPipe over 4 stages (``tests/test_distributed.py``'s setup, L 8,
    D 16, 6 microbatches, tanh(x @ w)): within 1e-5 of the reference's
    ``pipeline`` and of the sequential stack, the same bits on every
    rank."""
    _, ref, _, ranks, _ = runs
    got = ranks[0][f"pipe/{layout}"]
    np.testing.assert_allclose(got, ref["pipe/out"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, ref["pipe/sequential"], atol=1e-5,
                               rtol=0)
    for rec in ranks:
        np.testing.assert_array_equal(rec[f"pipe/{layout}"], got)


def test_split_stages():
    from repro_torch.distributed.pipeline import split_stages
    ws = torch.arange(8 * 3).reshape(8, 3)
    assert torch.equal(split_stages({"w": ws}, 4)["w"][1], ws[2:4])
    with pytest.raises(ValueError):
        split_stages(ws, 3)


@pytest.mark.parametrize("case", REF_EP_CASES)
def test_moe_ep_matches_reference(runs, case):
    """``moe_block_ep`` on 8 ranks against the reference's on a (4, 2) host
    mesh: output within 2e-5, aux within 1e-4 relative, the same on every
    rank, and the same dropped (token, choice) pairs on every source
    shard (some are dropped at capacity factor 1.25)."""
    _, ref, _, ranks, _ = runs
    for rec in ranks:
        np.testing.assert_array_equal(rec[f"ep/{case}/out"],
                                      ranks[0][f"ep/{case}/out"])
    np.testing.assert_allclose(ranks[0][f"ep/{case}/out"],
                               ref[f"ep/{case}/out"], atol=2e-5, rtol=0)
    np.testing.assert_allclose(ranks[0][f"ep/{case}/aux"],
                               ref[f"ep/{case}/aux"], rtol=1e-4)
    dropped = np.stack([rec[f"ep/{case}/dropped"] for rec in ranks])
    np.testing.assert_array_equal(dropped, ref[f"ep/{case}/dropped"])
    assert dropped.any() == (case == "cf1.25")


def ep_case(inp, name, **overrides):
    """(the port's cfg, MoEParams, x) of an EP case."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import ffn
    E, cf, _ = EP_CASES[name]
    cfg = replace(get_config("qwen2-moe-a2.7b").reduced(
        n_experts=E, capacity_factor=cf, **MOE), **overrides)
    p = ffn.MoEParams(*(torch.from_numpy(inp[f"ep/{name}/{w}"].copy())
                        for w in ("router", "w_gate", "w_up", "w_down")),
                      None)
    return cfg, p, torch.from_numpy(inp[f"ep/{name}/x"].copy())


def test_moe_ep_pads_tokens_to_the_group(runs):
    """15 tokens on 8 ranks: padded with a zero token to 16, as the
    reference pads. The output equals the local dispatch within 2e-5 (no
    drops at capacity factor 8), every rank the same; aux is the Switch
    loss over the 16 tokens, the zero token's router probabilities among
    them, as the reference's ``pmean`` takes them."""
    import torch.nn.functional as F

    from repro_torch.models import ffn
    inp, _, _, ranks, _ = runs
    cfg, p, x = ep_case(inp, "ragged", moe_impl="gspmd")
    out, _ = ffn.moe_block(p, x, cfg)
    for rec in ranks:
        np.testing.assert_array_equal(rec["ep/ragged/out"],
                                      ranks[0]["ep/ragged/out"])
    np.testing.assert_allclose(ranks[0]["ep/ragged/out"], out.numpy(),
                               atol=2e-5, rtol=0)
    xt = torch.cat([x.reshape(-1, x.shape[-1]), x.new_zeros((1, x.shape[-1]))])
    probs, _, ids = ffn.route(p, xt[None], cfg)
    aux = cfg.n_experts * torch.sum(probs.mean(dim=(0, 1)) * F.one_hot(
        ids[..., 0], cfg.n_experts).float().mean(dim=(0, 1)))
    np.testing.assert_allclose(ranks[0]["ep/ragged/aux"], aux.item(),
                               rtol=1e-5)


def test_moe_ep_matches_grouped_dispatch(runs):
    """``tests/test_distributed.py::test_moe_ep_matches_gspmd`` on the
    port: at capacity factor 8 nothing drops, and EP equals the port's
    ``moe_block`` with 8 dispatch groups (and the reference's) within 2e-5,
    aux within 1e-4 relative."""
    from repro_torch.models import ffn
    inp, ref, _, ranks, _ = runs
    cfg, p, x = ep_case(inp, "cf8", moe_impl="gspmd", moe_groups=8)
    out, aux = ffn.moe_block(p, x, cfg)
    np.testing.assert_allclose(out.numpy(), ref["grouped/cf8/out"],
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(ranks[0]["ep/cf8/out"], out.numpy(),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(ranks[0]["ep/cf8/aux"], aux.item(), rtol=1e-4)


def test_moe_block_takes_ep_only_under_a_policy(runs):
    """With a policy installed ``moe_block`` runs ``moe_block_ep`` (once,
    the same bits); without one it takes the local dispatch."""
    *_, ranks, _ = runs
    for rec in ranks:
        assert rec["policy/ep_calls"] == 1 and rec["no_policy/ep_calls"] == 1
        np.testing.assert_array_equal(rec["policy/out"], rec["ep/cf8/out"])


def test_constrain_redistributes_only_dtensors_under_a_policy(runs):
    *_, ranks, _ = runs
    for rec in ranks:
        assert rec["logical/plain_is_same"] and rec["logical/active"]
        assert str(rec["logical/placements"]) == "(Shard(dim=0), Shard(dim=2))"
        assert rec["logical/cleared"]


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.logical import P, placements
    m = PortMesh({"pod": 2, "data": 4, "model": 2})
    assert placements(m, P(("pod", "data"), None, "model")) == \
        [Shard(0), Shard(0), Shard(2)]
    assert placements(m, P(None, "data")) == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError):
        placements(m, P(("data", "pod")))
