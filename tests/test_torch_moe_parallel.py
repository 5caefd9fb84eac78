"""The MoE family on a ("data", "model") mesh: expert parallelism over
every rank with a backward, inside the sharded train step and the serve
steps, the batch over several ranks, and attention, the shared experts and
the vocab tensor-parallel along "model" (``models/moe_ep.py``,
``distributed/tensor_parallel.py``'s ``Route.moe``).

The reference runs in one subprocess on 8 XLA host devices (as
``tests/test_torch_distributed.py`` runs it), its mesh's axes ``Auto``
(``jax.make_mesh`` makes them ``Explicit`` in this JAX, where the model's
``constrain`` calls raise); then the port in 8 gloo processes and in one
more alone for the one-rank case, side by side. Each runs under a limit of
its own (``torch_worlds``). The weights come from the
port's ``init`` (a seed), flattened by path for both; batches and prompts
are made with numpy from seeds.

A reduced qwen2-moe (2 layers, d 32, 4 heads on 2 KV heads of hd 8, 6
routed experts of width 16 padded to the 8 ranks, top 2, one shared
expert, vocab 256), ``moe_impl="ep"``:
  * (a) the sharded train step, 3 AdamW steps, against the reference's
    single-device step at capacity factor 8, where no pair drops (EP, the
    grouped dispatch and one group agree there): on (4, 2) at T 16
    (sequence-parallel, remat "block"), at T 15 (not sequence-parallel:
    the rows whole along "model"), and on (2, 4) at T 16 (the KV heads
    replicated); and 3 Adafactor steps on (4, 2) at T 16 against the
    reference's Adafactor (each stacked leaf updated a layer at a time,
    the RMS over each EP-sharded expert stack reduced across the ranks);
  * (b) at capacity factor 1.25, where pairs drop: the loss and every
    gradient of the port's sharded loss against ``jax.value_and_grad`` of
    the reference's ``MoELM.loss_fn`` under ``repro.distributed.logical.
    policy`` on the same mesh (``moe_block_ep`` in its ``shard_map``),
    with each layer's dropped (token, choice) pairs on each source rank
    (the reference's ``moe_ep.py`` lines, on its MoE inputs layer by layer)
    and the aux (its ``_trunk``'s) beside the port's; sequence-parallel at
    T 32, each data rank 2 rows, so a rank's EP block is not its residual
    slice;
  * (c) the served prefill (12 tokens) and 4 greedy decode steps at
    capacity factor 1.25 against the reference's ``prefill`` and
    ``decode`` under the same policy: 8 rows on (4, 2) and (2, 4), and 4
    rows on (4, 2), where a decode step's 4 tokens are padded to the 8
    ranks (the reference's blocks cross the data ranks there: the port
    pads each data rank's one token to the 2 ranks along "model");
  * (d) every rank reports the same loss, gradients and logits;
  * a padded block longer than the capacity raises on every rank;
  * the regression of ``moe_block_ep`` without a backward: its gradients
    under grad mode against ``moe_block``'s autograd where nothing drops,
    on one rank and on 8.
"""
import datetime
import json
import logging
import os
import sys
import textwrap
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist

from test_torch_tensor_parallel import counting_routes
from torch_worlds import World, run_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
           d_ff=16, vocab_size=256, n_experts=6, top_k=2, n_shared_experts=1)
PAD = 8                     # the experts padded to the 8 ranks
# name -> (mesh, capacity factor, T, remat)
TRAIN = {"sp_42": ((4, 2), 8.0, 16, "block"),
         "rows_whole_42": ((4, 2), 8.0, 15, "none"),
         "sp_24": ((2, 4), 8.0, 16, "none"),
         "adafactor_42": ((4, 2), 8.0, 16, "none")}
# a train case's optimizer (``OptimizerConfig``'s fields), AdamW unless
# named: Adafactor without momentum, as kimi-k2-1t-a32b trains, over the
# EP-sharded expert stacks (its update clipping's RMS over each whole leaf
# reduced across the ranks)
OPTS = {"adafactor_42": dict(name="adafactor", peak_lr=1e-3)}
ADAMW = dict(name="adamw", peak_lr=1e-3)
DROPS = {"drops_42": ((4, 2), 1.25, 32), "drops_24": ((2, 4), 1.25, 32)}
# name -> (mesh, rows served)
SERVE = {"serve_42": ((4, 2), 8), "serve_42_padded": ((4, 2), 4),
         "serve_24": ((2, 4), 8)}
SERVE_CF = 1.25
STEPS, BATCH = 3, 8
PROMPT, DECODES, MAX_LEN = 12, 4, 24
TOL = 1e-5
AUX_RTOL = 1e-4
# each process's limit from its own start (``torch_worlds``)
REF_LIMIT_S, RANK_LIMIT_S = 450, 300


def config(cf: float, remat: str = "none"):
    from repro_torch.configs import get_config
    return replace(get_config("qwen2-moe-a2.7b").reduced(**MOE),
                   moe_impl="ep", moe_pad_experts=PAD, capacity_factor=cf,
                   remat=remat)


def flatten(tree, prefix: str = "") -> dict:
    """A param tree's leaves by path, as the reference's
    ``tree_flatten_with_path`` names them."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in flatten(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, tuple):
        return {k: v for name, sub in zip(tree._fields, tree)
                for k, v in flatten(sub, f"{prefix}{name}/").items()}
    return {prefix[:-1]: tree.detach().numpy()}


def make_inputs(seed: int = 23) -> dict:
    from repro_torch.models.transformer import build_model
    params = build_model(config(8.0), device="cpu").init(
        torch.Generator().manual_seed(seed))
    out = {f"params/{k}": v for k, v in flatten(params).items()}
    rng = np.random.default_rng(seed)
    cases = {**{n: (t, STEPS) for n, (_, _, t, _) in TRAIN.items()},
             **{n: (t, 1) for n, (_, _, t) in DROPS.items()}}
    for name, (seq, steps) in cases.items():
        for i in range(steps):
            out[f"{name}/batch{i}/tokens"] = rng.integers(
                0, 256, (BATCH, seq), dtype=np.int32)
            out[f"{name}/batch{i}/labels"] = rng.integers(
                0, 256, (BATCH, seq), dtype=np.int32)
            lens = rng.integers(1, seq + 1, BATCH)
            out[f"{name}/batch{i}/loss_mask"] = (
                np.arange(seq)[None, :] < lens[:, None]).astype(np.int32)
    for name, (_, rows) in SERVE.items():
        out[f"{name}/prompt/tokens"] = rng.integers(0, 256, (rows, PROMPT),
                                                    dtype=np.int32)
    return out


# ---------------------------------------------------------------------------
# the reference, in one subprocess on 8 host devices
# ---------------------------------------------------------------------------
REF_CODE = textwrap.dedent("""
    import sys
    from dataclasses import replace
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.distributed import logical
    from repro.models import moe_ep
    from repro.models.attention import attention_block
    from repro.models.common import rmsnorm
    from repro.models.ffn import moe_block
    from repro.models.transformer import build_model
    from repro.train.optimizer import OptimizerConfig, build_optimizer
    from repro.train.train_step import build_train_step

    (MOE, PAD, TRAIN, OPTS, ADAMW, DROPS, SERVE, SERVE_CF, STEPS, PROMPT,
     DECODES, MAX_LEN) = {consts}
    inp = np.load(sys.argv[1])
    out = {{}}

    def config(cf, remat="none"):
        return replace(get_config("qwen2-moe-a2.7b").reduced(**MOE),
                       moe_impl="ep", moe_pad_experts=PAD,
                       capacity_factor=cf, remat=remat)

    def key(path):
        return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                        for k in path)

    def weights(model):
        return jax.tree_util.tree_map_with_path(
            lambda path, leaf: jnp.asarray(inp["params/" + key(path)],
                                           leaf.dtype),
            model.init(jax.random.key(0)))

    def part(prefix):
        return {{k[len(prefix):]: jnp.asarray(v) for k, v in inp.items()
                 if k.startswith(prefix)}}

    def mesh_of(shape):
        return jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)

    # (a) the single-device train step
    for name, (_, cf, _, remat) in TRAIN.items():
        model = build_model(config(cf, remat))
        params = weights(model)
        opt = build_optimizer(OptimizerConfig(**OPTS.get(name, ADAMW)))
        state = {{"params": params, "opt": opt.init(params)}}
        step = jax.jit(build_train_step(model, opt))
        for i in range(STEPS):
            state, m = step(state, part(f"{{name}}/batch{{i}}/"))
            out[f"{{name}}/loss{{i}}"] = np.asarray(m["loss"])
            out[f"{{name}}/grad_norm{{i}}"] = np.asarray(m["grad_norm"])
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                state["params"])[0]:
            out[f"{{name}}/final/{{key(path)}}"] = np.asarray(leaf)

    def dropped(x, p, cfg, ep):
        # moe_ep.py's own lines on each source rank's block of x
        n, d = x.shape[0] * x.shape[1], x.shape[2]
        n_loc = -(-n // ep)
        xt = jnp.concatenate([x.reshape(n, d),
                              jnp.zeros((n_loc * ep - n, d), x.dtype)])
        C = moe_ep._capacity(n_loc, cfg, PAD)
        rows = []
        for r in range(ep):
            probs = jax.nn.softmax(xt[r * n_loc:(r + 1) * n_loc]
                                   .astype(jnp.float32) @ p.router, axis=-1)
            _, ids = jax.lax.top_k(probs, cfg.top_k)
            flat_e = ids.reshape(-1)
            order = jnp.argsort(flat_e, stable=True)
            sorted_e = flat_e[order]
            first = jnp.searchsorted(sorted_e, jnp.arange(PAD), side="left")
            keep = (jnp.arange(n_loc * cfg.top_k) - first[sorted_e]) < C
            rows.append(jnp.zeros(n_loc * cfg.top_k, bool)
                        .at[order].set(~keep))
        return jnp.stack(rows)

    def layer_drops(model, ep):
        # each layer's dropped pairs, under one jit: op by op on the
        # 8-device mesh these lines took most of the reference's time
        cfg = model.cfg

        def fn(params, batch):
            h = model._embed(params, batch)
            drops = []
            for l in range(cfg.n_layers):
                lp = jax.tree_util.tree_map(lambda t: t[l], params["layers"])
                a, _ = attention_block(lp.attn, rmsnorm(
                    h, lp.norm1, cfg.norm_eps), cfg)
                h = h + a
                xn = rmsnorm(h, lp.norm2, cfg.norm_eps)
                drops.append(dropped(xn, lp.moe, cfg, ep))
                h = h + moe_block(lp.moe, xn, cfg)[0]
            return jnp.stack(drops)

        return jax.jit(fn)

    # (b) the loss and its gradients under the policy, where pairs drop
    for name, (shape, cf, _) in DROPS.items():
        cfg = config(cf)
        model = build_model(cfg)
        params = weights(model)
        batch = part(f"{{name}}/batch0/")
        mesh = mesh_of(shape)
        logical.install(mesh)
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(
                params, batch)
            _, aux = jax.jit(lambda p, b: model._trunk(
                p, model._embed(p, b)))(params, batch)
            drops = layer_drops(model, shape[0] * shape[1])(params, batch)
        logical.clear()
        out[f"{{name}}/loss"], out[f"{{name}}/aux"] = (np.asarray(loss),
                                                       np.asarray(aux))
        out[f"{{name}}/dropped"] = np.asarray(drops)
        for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
            out[f"{{name}}/grad/{{key(path)}}"] = np.asarray(leaf)

    # (c) prefill and greedy decode steps under the policy
    for name, (shape, rows) in SERVE.items():
        model = build_model(config(SERVE_CF))
        params = weights(model)
        mesh = mesh_of(shape)
        logical.install(mesh)
        with mesh:
            cache = model.init_cache(rows, MAX_LEN)
            logits, cache = jax.jit(model.prefill)(
                params, part(f"{{name}}/prompt/"), cache)
            out[f"{{name}}/logits0"] = np.asarray(logits)
            decode = jax.jit(model.decode)
            for j in range(DECODES):
                tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
                out[f"{{name}}/tokens{{j}}"] = np.asarray(tok)
                logits, cache = decode(params, tok[:, None], cache)
                out[f"{{name}}/logits{{j + 1}}"] = np.asarray(logits)
        logical.clear()
    np.savez(sys.argv[2], **out)
""")


def reference(inputs_path: str, out_path: str) -> None:
    consts = repr((MOE, PAD, TRAIN, OPTS, ADAMW, DROPS, SERVE, SERVE_CF,
                   STEPS, PROMPT, DECODES, MAX_LEN))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    run_reference("the reference on 8 host devices",
                  [sys.executable, "-c", REF_CODE.format(consts=consts),
                   inputs_path, out_path], env,
                  os.path.splitext(out_path)[0] + ".log", REF_LIMIT_S)


# ---------------------------------------------------------------------------
# the port, in gloo processes
# ---------------------------------------------------------------------------
def port_params(inp: dict, cfg):
    from repro_torch.weights import moe_params_from_flat
    return moe_params_from_flat({k[len("params/"):]: v for k, v in
                                 inp.items() if k.startswith("params/")},
                                cfg, "cpu")


def part(inp: dict, prefix: str) -> dict:
    return {k[len(prefix):]: torch.from_numpy(v.copy())
            for k, v in inp.items() if k.startswith(prefix)}


def train_run(inp, name, record) -> None:
    """(a) 3 sharded steps (AdamW, or ``OPTS``'s); the plans of the routes
    taken."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import sharding as shd
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import build_model
    from repro_torch.train.optimizer import OptimizerConfig, build_optimizer
    shape, cf, _, remat = TRAIN[name]
    cfg = config(cf, remat)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    model = build_model(cfg, device="cpu")
    params = port_params(inp, cfg)
    opt_cfg = OptimizerConfig(**OPTS.get(name, ADAMW))
    opt = build_optimizer(opt_cfg)
    state = {"params": params, "opt": opt.init(params)}
    pspecs = shd.fit_tree(mesh, shd.param_specs(cfg, mesh), params)
    state = shd.place(state, shd.to_named(
        mesh, shd.train_state_specs(state, opt_cfg.name, pspecs)))
    step = shd.shard_train_step(model, opt, mesh)
    plans = []
    undo = counting_routes(plans)
    try:
        for i in range(STEPS):
            state, m = step(state, part(inp, f"{name}/batch{i}/"))
            record[f"{name}/loss{i}"] = m["loss"].numpy()
            record[f"{name}/grad_norm{i}"] = m["grad_norm"].numpy()
    finally:
        undo()
    record[f"{name}/plans"] = np.array(json.dumps(plans))
    whole = tree_map(lambda t: t.full_tensor(), state["params"])
    for k, v in flatten(whole).items():
        record[f"{name}/final/{k}"] = v


def drops_run(inp, name, record) -> None:
    """(b) the sharded loss and its gradients (whole), each layer's dropped
    pairs on this rank and the aux of each layer."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as shd
    from repro_torch.models import moe_ep
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import build_model
    from repro_torch.train.train_step import value_and_grad
    shape, cf, _ = DROPS[name]
    cfg = config(cf)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    model = build_model(cfg, device="cpu")
    params = port_params(inp, cfg)
    placed = shd.place(params, shd.to_named(mesh, shd.fit_tree(
        mesh, shd.param_specs(cfg, mesh), params)))
    loss = shd._LocalLoss(model, mesh)
    drops, auxes = [], []
    plan, ep_block = moe_ep.local_plan, moe_ep.expert_parallel

    def planned(p, x, cfg, e_pad, C):
        out = plan(p, x, cfg, e_pad, C)
        drops.append((out[3][0] == e_pad * C).numpy())
        return out

    def block(*args, **kwargs):
        out, aux = ep_block(*args, **kwargs)
        auxes.append(aux.detach().numpy())
        return out, aux

    moe_ep.local_plan, moe_ep.expert_parallel = planned, block
    try:
        value, grads = value_and_grad(loss.loss_fn, placed,
                                      part(inp, f"{name}/batch0/"))
    finally:
        moe_ep.local_plan, moe_ep.expert_parallel = plan, ep_block
    record[f"{name}/loss"] = loss.batch_sum(value.detach()).numpy()
    record[f"{name}/dropped"] = np.stack(drops)
    record[f"{name}/aux"] = np.array(np.mean(auxes))
    whole = tree_map(lambda g: g.full_tensor() if isinstance(g, DTensor)
                     else g, grads)
    for k, v in flatten(whole).items():
        record[f"{name}/grad/{k}"] = v


def serve_run(inp, name, record) -> None:
    """(c) ``serve_step``'s prefill and greedy decode steps, the logits
    gathered over the batch and the vocab."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.build import serve_step
    from repro_torch.models.transformer import build_model
    shape, rows = SERVE[name]
    cfg = config(SERVE_CF)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    model = build_model(cfg, device="cpu")

    def placed(tree, specs):
        return shd.place(tree, shd.to_named(mesh, shd.fit_tree(mesh, specs,
                                                               tree)))

    ps = placed(port_params(inp, cfg), shd.param_specs(cfg, mesh))
    cache, cspecs = shd.tp_cache(cfg, mesh, model.init_cache(rows, MAX_LEN))
    cache = placed(cache, cspecs)
    prefill = serve_step(model, mesh, "prefill")
    decode = serve_step(model, mesh, "decode")

    def whole(logits):
        return DTensor.from_local(logits, mesh, [Shard(0), Shard(2)]
                                  ).full_tensor().numpy()

    prompt = part(inp, f"{name}/prompt/")
    plans = []
    undo = counting_routes(plans)
    try:
        with torch.no_grad():
            logits, cache = prefill(ps, placed(prompt, shd.batch_specs(
                cfg, mesh, prompt)), cache)
            record[f"{name}/logits0"] = whole(logits)
            for j in range(DECODES):
                tok = torch.from_numpy(record[f"{name}/logits{j}"][:, -1]
                                       .argmax(-1).astype(np.int32))
                record[f"{name}/tokens{j}"] = tok.numpy()
                feed = {"tokens": tok[:, None]}
                logits, cache = decode(ps, placed(feed, shd.batch_specs(
                    cfg, mesh, feed)), cache)
                record[f"{name}/logits{j + 1}"] = whole(logits)
    finally:
        undo()
    record[f"{name}/plans"] = np.array(json.dumps(plans))


def padded_run(record) -> None:
    """A prefill of 4 rows of 13 tokens on (4, 2): a data rank's 13 tokens
    padded to 14 over the 2 ranks along "model", 7 a rank, past the
    capacity of 4; the message of the ``ValueError`` each rank raises."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.build import serve_step
    from repro_torch.models.transformer import build_model
    cfg = config(SERVE_CF)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    model = build_model(cfg, device="cpu")

    def placed(tree, specs):
        return shd.place(tree, shd.to_named(mesh, shd.fit_tree(mesh, specs,
                                                               tree)))

    params = model.init(torch.Generator().manual_seed(3))
    cache, cspecs = shd.tp_cache(cfg, mesh, model.init_cache(4, MAX_LEN))
    prompt = {"tokens": torch.arange(4 * 13, dtype=torch.int32).reshape(
        4, 13)}
    try:
        with torch.no_grad():
            serve_step(model, mesh, "prefill")(
                placed(params, shd.param_specs(cfg, mesh)),
                placed(prompt, shd.batch_specs(cfg, mesh, prompt)),
                placed(cache, cspecs))
        record["padded/raised"] = np.array("")
    except ValueError as e:
        record["padded/raised"] = np.array(str(e))


GRAD_CF = 8.0
GRAD_SHAPE = (4, 8)             # (B, T) of the block's input: 32 tokens
SHARED_LEAVES = ("w_gate", "w_up", "w_down")


def block_inputs(seed: int = 5):
    """(cfg, MoEParams, x, the output's cotangent) of the regression case,
    made with numpy from a seed: capacity factor 8, nothing drops."""
    from repro_torch.models import ffn
    cfg = config(GRAD_CF)
    rng = np.random.default_rng(seed)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                / np.float32(np.sqrt(shape[-2])))

    p = ffn.MoEParams(draw(d, E), draw(PAD, d, ff), draw(PAD, d, ff),
                      draw(PAD, ff, d),
                      ffn.MLPParams(draw(d, ff), draw(d, ff), draw(ff, d)))
    x = torch.from_numpy(rng.standard_normal((*GRAD_SHAPE, d), np.float32))
    cot = torch.from_numpy(rng.standard_normal((*GRAD_SHAPE, d), np.float32))
    return cfg, p, x, cot


def block_grads(fn, p, x, cot) -> dict:
    """The output, the aux and the gradients of ``(out * cot).sum() + 0.3
    aux`` under grad mode, ``fn(p, x)`` giving (out, aux)."""
    from repro_torch.models.common import tree_leaves, tree_map
    p = tree_map(lambda t: t.clone().requires_grad_(True), p)
    x = x.clone().requires_grad_(True)
    with torch.enable_grad():
        out, aux = fn(p, x)
        leaves = [p.router, p.w_gate, p.w_up, p.w_down,
                  *tree_leaves(p.shared), x]
        grads = torch.autograd.grad((out * cot).sum() + 0.3 * aux, leaves)
    names = ["router", "w_gate", "w_up", "w_down",
             *(f"shared_{n}" for n in SHARED_LEAVES), "x"]
    return {"out": out.detach(), "aux": aux.detach(),
            **dict(zip(names, grads))}


def ep_grad_run(mesh_shape, record) -> None:
    """``moe_block_ep`` under grad mode on ``mesh_shape``: every rank
    passes the whole input; the router's and the expert stacks' gradients
    are each rank's share, summed here over the ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import moe_ep
    mesh = init_device_mesh("cpu", mesh_shape,
                            mesh_dim_names=("data", "model"))
    cfg, p, x, cot = block_inputs()
    got = block_grads(lambda p, x: moe_ep.moe_block_ep(p, x, cfg, mesh),
                      p, x, cot)
    for k in ("router", "w_gate", "w_up", "w_down"):
        dist.all_reduce(got[k])
    for k, v in got.items():
        record[f"ep_grad/{k}"] = v.numpy()


def _rank_main(rank: int, world: int, store: str, inputs: str,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        record = {}
        if world == 1:
            ep_grad_run((1, 1), record)
        else:
            inp = dict(np.load(inputs))
            ep_grad_run((4, 2), record)
            for name in TRAIN:
                train_run(inp, name, record)
            for name in DROPS:
                drops_run(inp, name, record)
            for name in SERVE:
                serve_run(inp, name, record)
            padded_run(record)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **record)
    finally:
        dist.destroy_process_group()


def spawn(world: int, tmp, inputs: str) -> World:
    out_dir = tmp / f"world{world}"
    out_dir.mkdir()
    return World(f"the port's world of {world}", _rank_main, world,
                 (world, str(tmp / f"store{world}"), inputs, str(out_dir)),
                 out_dir, RANK_LIMIT_S)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, the 8 ranks' records, the one rank's
    record): the reference first, alone, then both worlds side by side."""
    tmp = tmp_path_factory.mktemp("moe_parallel")
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **make_inputs())
    reference(inputs, str(tmp / "ref.npz"))
    eight, one = spawn(8, tmp, inputs), spawn(1, tmp, inputs)
    ranks = eight.join()
    alone = one.join()[0]
    return dict(np.load(tmp / "ref.npz")), ranks, alone


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(TRAIN))
def test_sharded_train_step_matches_reference(runs, name):
    """(a) 3 steps where no pair drops (AdamW; Adafactor in
    ``adafactor_42``, against the reference's Adafactor): losses and grad
    norms within 1e-5 relative of the reference's single-device step,
    every leaf within 1e-5."""
    ref, ranks, _ = runs
    rec = ranks[0]
    for i in range(STEPS):
        for m in ("loss", "grad_norm"):
            np.testing.assert_allclose(rec[f"{name}/{m}{i}"],
                                       ref[f"{name}/{m}{i}"], rtol=TOL)
    finals = sorted(k for k in ref if k.startswith(f"{name}/final/"))
    assert finals == sorted(k for k in rec if k.startswith(f"{name}/final/"))
    for k in finals:
        np.testing.assert_allclose(rec[k], ref[k], atol=TOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(DROPS))
def test_loss_and_gradients_with_drops_match_reference(runs, name):
    """(b) Where pairs drop (capacity factor 1.25; drops asserted present):
    each layer's dropped (token, choice) pairs on each source rank the
    reference's, the loss within 1e-5 relative, the aux within 1e-4
    relative, every gradient within 1e-5 of ``jax.value_and_grad`` of the
    reference's loss under its policy on the same mesh."""
    ref, ranks, _ = runs
    dropped = np.stack([rec[f"{name}/dropped"] for rec in ranks], axis=1)
    np.testing.assert_array_equal(dropped, ref[f"{name}/dropped"])
    assert dropped.any()
    np.testing.assert_allclose(ranks[0][f"{name}/loss"], ref[f"{name}/loss"],
                               rtol=TOL)
    np.testing.assert_allclose(ranks[0][f"{name}/aux"], ref[f"{name}/aux"],
                               rtol=AUX_RTOL)
    grads = sorted(k for k in ref if k.startswith(f"{name}/grad/"))
    assert grads == sorted(k for k in ranks[0]
                           if k.startswith(f"{name}/grad/"))
    for k in grads:
        np.testing.assert_allclose(ranks[0][k], ref[k], atol=TOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(SERVE))
def test_serve_steps_match_reference(runs, name):
    """(c) The prefill and 4 greedy decode steps of ``serve_step`` at
    capacity factor 1.25: the logits within 1e-5 of the reference's
    ``prefill``/``decode`` under its policy on the same mesh, the greedy
    tokens identical; 4 rows on (4, 2) pad each decode step's tokens."""
    ref, ranks, _ = runs
    rec = ranks[0]
    for j in range(DECODES + 1):
        np.testing.assert_allclose(rec[f"{name}/logits{j}"],
                                   ref[f"{name}/logits{j}"], atol=TOL,
                                   rtol=0, err_msg=f"step {j}")
    for j in range(DECODES):
        np.testing.assert_array_equal(rec[f"{name}/tokens{j}"],
                                      ref[f"{name}/tokens{j}"])


@pytest.mark.parametrize("name", sorted(TRAIN) + sorted(DROPS)
                         + sorted(SERVE))
def test_every_rank_reports_the_same(runs, name):
    """(d) The losses, grad norms, final leaves, gradients, aux and
    gathered logits are the same bits on every rank."""
    _, ranks, _ = runs
    keys = [k for k in ranks[0] if k.startswith(f"{name}/") and k.split(
        "/")[1].startswith(("loss", "grad", "final", "logits", "aux"))]
    assert keys
    for rec in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(rec[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("name", sorted(TRAIN) + sorted(SERVE))
def test_the_steps_take_the_moe_plan(runs, name):
    """Each step takes one route of the MoE plan: the EP group the 8
    ranks, one expert a rank (8 padded over 8), the capacity of a rank's
    block (its data rows' tokens over the ranks along "model"), the heads
    local on (4, 2) and replicated on (2, 4), the shared experts and the
    vocab local; training sequence-parallel where "model" divides T."""
    _, ranks, _ = runs
    if name in TRAIN:
        (data, m), cf, seq, _ = TRAIN[name]
        rows, kinds = BATCH // data, [("train", seq)] * STEPS
    else:
        (data, m), rows = SERVE[name]
        cf = SERVE_CF
        rows //= data
        kinds = [("prefill", PROMPT)] + [("decode", 1)] * DECODES
    from repro_torch.distributed.tensor_parallel import ep_capacity
    cfg = config(cf)
    heads = ("local", [2, 1]) if m == 2 else ("kv_replicated", [1, 1])
    for rank, rec in enumerate(ranks):
        want = [{"model": m, "heads": heads[0], "local_heads": heads[1],
                 "mlp": "local", "vocab": "local",
                 "seq_parallel": kind == "train" and seq % m == 0,
                 "ep": 8, "ep_experts": 1,
                 "capacity": ep_capacity(-(-rows * seq // m), cfg),
                 "model_rank": rank % m, "q_rows": None}
                for kind, seq in kinds]
        assert json.loads(str(rec[f"{name}/plans"])) == want


def test_padded_blocks_past_the_capacity_raise(runs):
    """Where a data rank's tokens are padded (13 on 2 ranks) and a block
    (7 tokens) is longer than the capacity (4), pairs may drop, and the
    dropped pairs would not be the reference's, whose blocks cross the
    data ranks: every rank raises, none waits on a collective."""
    _, ranks, _ = runs
    for rec in ranks:
        assert "7 tokens a rank, padded" in str(rec["padded/raised"])


@pytest.mark.parametrize("world", [1, 8])
def test_moe_block_ep_trains(runs, world):
    """``moe_block_ep`` under grad mode, every rank passing the whole input
    (the parent's raised here: its in-place collectives are not seen by
    autograd): the output, the aux and the gradients of the router, the
    expert stacks (summed over the ranks), the shared experts and the
    input equal ``moe_block``'s autograd on one process where nothing
    drops, within 1e-5 (the aux 1e-4 relative), on one rank and on 8."""
    from repro_torch.models import ffn
    _, ranks, alone = runs
    cfg, p, x, cot = block_inputs()
    want = block_grads(lambda p, x: ffn.moe_block(p, x, replace(
        cfg, moe_impl="gspmd")), p, x, cot)
    for rec in ([alone] if world == 1 else ranks):
        for k, v in want.items():
            got = rec[f"ep_grad/{k}"]
            if k == "aux":
                np.testing.assert_allclose(got, v.numpy(), rtol=AUX_RTOL)
            else:
                np.testing.assert_allclose(got, v.numpy(), atol=TOL, rtol=0,
                                           err_msg=k)


# ---------------------------------------------------------------------------
# in this process: a padded stack's block, the plan at m = 16
# ---------------------------------------------------------------------------
class _Mesh:
    """A stand-in (4, 2) mesh seen from rank ``r``."""

    def __init__(self, r: int) -> None:
        self.coord = (r // 2, r % 2)

    def size(self, j: int) -> int:
        return (4, 2)[j]

    def get_local_rank(self, j: int) -> int:
        return self.coord[j]


def test_padded_block_is_the_padded_leafs_block():
    """``Deferred.block``: each rank's block of a stack of 5 experts
    padded with zeros to 16, sharded over both axes of a (4, 2) mesh as the
    EP stacks are, equals ``local_shard`` of the padded whole drawn the
    same way (rank 2 holds the last real expert and a zero one, ranks 3 to
    7 zeros), drawing only the rank's experts."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed.sharding import local_shard
    from repro_torch.launch.build import _span
    from repro_torch.models.common import deferred_draws, dense_init
    with deferred_draws(7):
        leaf = dense_init(torch.Generator(), (2, 5, 3, 4), in_axis=1,
                          n_lead=1)
    shape = (2, 16, 3, 4)
    whole = leaf.block([[0, n] for n in shape])
    assert bool(whole[:, :5].all()) and not whole[:, 5:].any()
    placements = [Shard(1), Shard(1)]
    for r in range(8):
        got = leaf.block(_span(_Mesh(r), shape, placements))
        assert torch.equal(got, local_shard(_Mesh(r), whole, placements))
        assert bool(got.any()) == (r <= 2)


# arch -> (the attention's mode in train_4k, prefill_32k and decode_32k,
# its local heads, the shared experts' width, the experts a rank of 256,
# the capacity in train_4k (16 rows of 4096 a data rank: 4096 tokens a
# rank) and in decode_32k (8 rows: one token a rank))
MOE_AT_16 = {"qwen2-moe-a2.7b": ("local", [1, 1], 5632, 1, 344, 4),
             "kimi-k2-1t-a32b": ("kv_replicated", [4, 1], 2048, 2, 108, 4)}


@pytest.mark.parametrize("arch", sorted(MOE_AT_16))
def test_moe_plan_at_sixteen(arch):
    """(e) Both MoE configs at m = 16 on the (16, 16) mesh: the attention
    as the dense family's (16/16 heads local, 64/8 replicated KV heads),
    the shared experts (4 x 1408 and 2048 wide) and the vocab (151936,
    163840) local, the experts padded to the 256 ranks, and the EP
    capacity of a rank's block."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.tensor_parallel import (TP_FAMILIES,
                                                         computes_tp, plan)
    cfg = get_config(arch)
    assert cfg.family in TP_FAMILIES and computes_tp(cfg)
    assert not computes_tp(replace(cfg, moe_impl="gspmd"))
    heads, local, shared, experts, cap_train, cap_decode = MOE_AT_16[arch]
    assert shared == cfg.d_ff * cfg.n_shared_experts and shared % 16 == 0
    for shape, rows, cap in (("train_4k", 16, cap_train),
                             ("prefill_32k", 2, None),
                             ("decode_32k", 8, cap_decode)):
        cell = SHAPES[shape]
        seq = 1 if cell.kind == "decode" else cell.seq_len
        r = plan(cfg, 16, kind=cell.kind, seq_len=seq, ep=256,
                 rows=rows).record()
        assert (r["heads"], r["local_heads"], r["mlp"], r["vocab"]) == (
            heads, local, "local", "local")
        assert (r["ep"], r["ep_experts"]) == (256, experts)
        if cap is not None:
            assert r["capacity"] == cap
    with pytest.raises(ValueError):
        plan(cfg, 16, kind="train", seq_len=4096)
