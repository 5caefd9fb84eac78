"""The port's tensor-parallel compute along "model" (dense and vlm
families, ``repro_torch/distributed/tensor_parallel.py``) against the
reference's single-device steps.

The reference's own sharded step fails in this JAX (a
``ShardingTypeError`` at the vocab-sharded embedding gather), and GSPMD's
sharded program computes the single-device function, so the port's
sharded steps are held to the reference's single-device ones. As in
``tests/test_torch_distributed.py``, the reference runs once in a
subprocess and the port in 8 gloo processes, in a module fixture; the
weights come from the reference's ``init`` through the weight bridge, the
batches and prompts are made with numpy from seeds.

Cases (name -> (arch, reduced config, ("data", "model") mesh, training
sequence length)):
  * ``heads_local``: the reduced smollm of ``test_torch_distributed.py``
    (4 heads, 2 KV heads, hd 16, vocab 256, d_ff 128) on (4, 2), T 32:
    heads, d_ff and vocab local, sequence-parallel residuals in training;
  * ``not_seq_parallel``: the same at T 31, which 2 ranks do not divide:
    one all-reduce after each row-parallel product in training too;
  * ``kv_replicated``: the same with vocab 250 on (2, 4): one query head a
    rank on its KV head (2 KV heads on 4 ranks), the vocab whole, the MLP
    local;
  * ``kv_replicated_vocab_local``: vocab 256 on (2, 4): the same with the
    vocab local, the plan of llama-3.1-8b and llama-3.2-1b at 16 ranks
    along "model";
  * ``q_seq``: a reduced smollm with 3 heads on 1 KV head on (2, 4), T 32,
    prompt 12: each rank attends from its quarter of the query rows in
    training and prefill (the plan of minitron-4b, llava-next-34b and the
    smollms at 16 ranks); decode "kv_seq": the cache of ``MAX_LEN`` 32
    split over its positions, 8 a rank, so the prompt lands on ranks 0
    and 1, the decode steps cross from rank 1 to rank 2 at position 16
    and rank 3's block stays empty (its log-sum-exp -inf every step);
  * ``q_seq_not_divisible``: the same at T 30, which 4 ranks do not
    divide: training gathered, prefill q_seq, decode kv_seq;
  * ``vlm``: a reduced llava-next-34b (8 patch embeddings before the text)
    on (4, 2);
  * ``vlm_q_seq``: the reduced llava with 3 heads on 1 KV head on (4, 2):
    query rows after the patches, whose RoPE positions count them; decode
    kv_seq, 16 positions a rank (the patches and prompt, 20, cross into
    rank 1);
  * ``vlm_vocab_whole``: the reduced llava with 16 patches and vocab 250
    on (2, 4): the vocab whole in a sequence-parallel step, so each rank's
    loss is its own 12 positions' (``Plan.loss_rows``), rank 0's all
    patches (no labels), rank 1's 4 patches then 8 tokens; a decode step
    reads the embedding's rows by its tokens (``build._read_rows``);
  * ``remat_block``: ``heads_local`` under ``remat="block"``, against the
    reference's steps under its own: each layer gathers its leaves inside
    the checkpoint, and the backward's recompute gathers them again.
Each trains 3 AdamW steps, then serves a prefill and 8 greedy decode
steps from the initial weights. A fake world of 16 ranks on ``meta``
counts a reduced dense cell on (4, 4) under each attention mode, the
q_seq one on its last rank along "model". The plan table at m = 16 takes
the ssm and hybrid configs too; ``test_torch_tensor_parallel_ssm.py``
runs this harness over their cases.
"""
import datetime
import json
import logging
import os
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist

from torch_worlds import Reference, World
from torch_worlds import run_reference as run_limited

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOLLM = dict(n_layers=2, d_model=64, vocab_size=256, d_ff=128, n_heads=4,
              n_kv_heads=2, head_dim=16)
THREE = dict(SMOLLM, n_heads=3, n_kv_heads=1)     # neither divides 2 or 4
CASES = {"heads_local": ("smollm-135m", SMOLLM, (4, 2), 32),
         "not_seq_parallel": ("smollm-135m", SMOLLM, (4, 2), 31),
         "kv_replicated": ("smollm-135m", dict(SMOLLM, vocab_size=250),
                           (2, 4), 32),
         "kv_replicated_vocab_local": ("smollm-135m", SMOLLM, (2, 4), 32),
         "q_seq": ("smollm-135m", THREE, (2, 4), 32),
         "q_seq_not_divisible": ("smollm-135m", THREE, (2, 4), 30),
         "vlm": ("llava-next-34b", dict(SMOLLM, n_patches=8), (4, 2), 32),
         "vlm_q_seq": ("llava-next-34b", dict(THREE, n_patches=8), (4, 2),
                       32),
         "vlm_vocab_whole": ("llava-next-34b", dict(SMOLLM, n_patches=16,
                                                    vocab_size=250), (2, 4),
                             32),
         "remat_block": ("smollm-135m", dict(SMOLLM, remat="block"), (4, 2),
                         32)}
LOCAL = ("local", [2, 1])
KV_REPLICATED = ("kv_replicated", [1, 1])
Q_SEQ, GATHERED = ("q_seq", [3, 1]), ("gathered", [3, 1])
KV_SEQ = ("kv_seq", [3, 1])
# each case's plan: the "model" size and the vocab (the MLP is local in
# every case), then the attention's mode and local heads in training,
# whether training is sequence-parallel, and the modes of the prefill and
# of the decode steps
PLANS = {"heads_local": (2, "local", LOCAL, True, LOCAL, LOCAL),
         "not_seq_parallel": (2, "local", LOCAL, False, LOCAL, LOCAL),
         "kv_replicated": (4, "whole", KV_REPLICATED, True, KV_REPLICATED,
                           KV_REPLICATED),
         "kv_replicated_vocab_local": (4, "local", KV_REPLICATED, True,
                                       KV_REPLICATED, KV_REPLICATED),
         "q_seq": (4, "local", Q_SEQ, True, Q_SEQ, KV_SEQ),
         "q_seq_not_divisible": (4, "local", GATHERED, False, Q_SEQ,
                                 KV_SEQ),
         "vlm": (2, "local", LOCAL, True, LOCAL, LOCAL),
         "vlm_q_seq": (2, "local", Q_SEQ, True, Q_SEQ, KV_SEQ),
         "vlm_vocab_whole": (4, "whole", KV_REPLICATED, True, KV_REPLICATED,
                             KV_REPLICATED),
         "remat_block": (2, "local", LOCAL, True, LOCAL, LOCAL)}
STEPS, BATCH = 3, 8
PROMPT, DECODES, MAX_LEN = 12, 8, 32
TOL = 1e-5
# each process's limit from its own start (``torch_worlds``)
REF_LIMIT_S, RANK_LIMIT_S = 600, 450


def reduced(arch: str, over: dict):
    from repro_torch.configs import get_config
    return get_config(arch).reduced(**over)


# ---------------------------------------------------------------------------
# inputs, made with numpy from seeds
# ---------------------------------------------------------------------------
def make_inputs(cases: dict = CASES, seed: int = 17) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for name, (arch, over, _, seq) in cases.items():
        cfg = reduced(arch, over)
        vlm = cfg.family == "vlm"
        for i in range(STEPS):
            out[f"{name}/batch{i}/tokens"] = rng.integers(
                0, cfg.vocab_size, (BATCH, seq), dtype=np.int32)
            out[f"{name}/batch{i}/labels"] = rng.integers(
                0, cfg.vocab_size, (BATCH, seq), dtype=np.int32)
            lens = rng.integers(1, seq + 1, BATCH)
            out[f"{name}/batch{i}/loss_mask"] = (
                np.arange(seq)[None, :] < lens[:, None]).astype(np.int32)
            if vlm:
                out[f"{name}/batch{i}/patch_embeds"] = rng.standard_normal(
                    (BATCH, cfg.n_patches, cfg.d_model), np.float32)
            if cfg.family == "encdec":
                out[f"{name}/batch{i}/frames"] = rng.standard_normal(
                    (BATCH, cfg.enc_len, cfg.d_model), np.float32)
        out[f"{name}/prompt/tokens"] = rng.integers(
            0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)
        if vlm:
            out[f"{name}/prompt/patch_embeds"] = rng.standard_normal(
                (BATCH, cfg.n_patches, cfg.d_model), np.float32)
        if cfg.family == "encdec":
            out[f"{name}/prompt/frames"] = rng.standard_normal(
                (BATCH, cfg.enc_len, cfg.d_model), np.float32)
    return out


# ---------------------------------------------------------------------------
# the reference, in one subprocess
# ---------------------------------------------------------------------------
REF_CODE = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.models.transformer import build_model
    from repro.train.optimizer import OptimizerConfig, build_optimizer
    from repro.train.train_step import build_train_step

    CASES, STEPS, DECODES, MAX_LEN = {consts}
    inp = np.load(sys.argv[1])
    out = {{}}

    def part(prefix):
        return {{k[len(prefix):]: jnp.asarray(v) for k, v in inp.items()
                 if k.startswith(prefix)}}

    for name, (arch, over, *_) in CASES.items():
        model = build_model(get_config(arch).reduced(**over))
        params = model.init(jax.random.key(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                           for k in path)
            out[f"{{name}}/params/{{key}}"] = np.asarray(leaf)
        opt = build_optimizer(OptimizerConfig(peak_lr=1e-3))
        state = {{"params": params, "opt": opt.init(params)}}
        step = jax.jit(build_train_step(model, opt))
        for i in range(STEPS):
            state, m = step(state, part(f"{{name}}/batch{{i}}/"))
            out[f"{{name}}/loss{{i}}"] = np.asarray(m["loss"])
            out[f"{{name}}/grad_norm{{i}}"] = np.asarray(m["grad_norm"])
        for j, leaf in enumerate(jax.tree_util.tree_leaves(state["params"])):
            out[f"{{name}}/final{{j}}"] = np.asarray(leaf)
        prompt = part(f"{{name}}/prompt/")
        cache = model.init_cache(prompt["tokens"].shape[0], MAX_LEN)
        logits, cache = model.prefill(params, prompt, cache)
        out[f"{{name}}/logits0"] = np.asarray(logits)
        for j in range(DECODES):
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
            out[f"{{name}}/tokens{{j}}"] = np.asarray(tok)
            logits, cache = model.decode(params, tok[:, None], cache)
            out[f"{{name}}/logits{{j + 1}}"] = np.asarray(logits)
    np.savez(sys.argv[2], **out)
""")


def run_reference(inputs_path: str, out_path: str,
                  cases: dict = CASES) -> None:
    consts = repr((cases, STEPS, DECODES, MAX_LEN))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run_limited("the reference's single-device steps",
                [sys.executable, "-c", REF_CODE.format(consts=consts),
                 inputs_path, out_path], env,
                os.path.splitext(out_path)[0] + ".log", REF_LIMIT_S)


# ---------------------------------------------------------------------------
# the port, in gloo processes
# ---------------------------------------------------------------------------
def counting_routes(plans: list):
    """Patches ``tensor_parallel.route`` to append the plan of each route
    it returns, with the route's rank along "model" and its query rows;
    returns the function that undoes it."""
    from repro_torch.distributed import tensor_parallel
    route = tensor_parallel.route

    def counted(*args, **kwargs):
        r = route(*args, **kwargs)
        if r is not None:
            plans.append(r.plan.record(r.rank))
        return r

    tensor_parallel.route = counted
    return lambda: setattr(tensor_parallel, "route", route)


def case_run(inp: dict, name: str, record: dict, cases: dict = CASES
             ) -> None:
    """3 sharded AdamW steps and the served prefill and decode steps of
    one case of ``cases`` on its mesh, into ``record`` (with the shapes of
    a rank's SSM state and conv tail, or of its cross K, where the model
    has them). The state is placed by ``sharding.place_state`` and the
    final leaves read back whole through ``sharding.whole_state``, in the
    reference's order. Where the model has mamba2 blocks, also a rank's
    stored ``in_proj`` block's shape and the output bytes of every
    all-gather over the "model" group (``analysis.StepCounter``) in the
    first train step and in the prefill."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.analysis import StepCounter
    from repro_torch.launch.build import serve_step
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import build_model
    from repro_torch.train.optimizer import OptimizerConfig, build_optimizer
    from repro_torch.weights import (dense_params_from_flat,
                                     encdec_params_from_flat,
                                     hybrid_params_from_flat,
                                     ssm_params_from_flat)
    arch, over, shape, _ = cases[name]
    cfg = reduced(arch, over)
    bridge = {"ssm": ssm_params_from_flat,
              "hybrid": hybrid_params_from_flat,
              "encdec": encdec_params_from_flat}.get(cfg.family,
                                                     dense_params_from_flat)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    flat = {k[len(f"{name}/params/"):]: v for k, v in inp.items()
            if k.startswith(f"{name}/params/")}
    model = build_model(cfg, device="cpu")

    def part(prefix):
        return {k[len(prefix):]: torch.from_numpy(v.copy())
                for k, v in inp.items() if k.startswith(prefix)}

    def placed(tree, specs):
        return shd.place(tree, shd.to_named(mesh, shd.fit_tree(mesh, specs,
                                                               tree)))

    ssm = cfg.family in ("ssm", "hybrid")
    model_size = mesh.size(1)
    gathers = set()

    def counted(fn, *args):
        # the output bytes of each all-gather over the "model" group
        if not ssm:
            return fn(*args)
        with StepCounter() as counter:
            out = fn(*args)
        gathers.update(n for kind, n, size in counter.collectives
                       if kind == "all-gather" and size == model_size)
        return out

    params = bridge(flat, cfg, "cpu")
    opt = build_optimizer(OptimizerConfig(peak_lr=1e-3))
    state = {"params": params, "opt": opt.init(params)}
    pspecs = shd.fit_tree(mesh, shd.param_specs(cfg, mesh), params)
    state = shd.place_state(cfg, mesh, state, shd.to_named(
        mesh, shd.train_state_specs(state, "adamw", pspecs)))
    if ssm:
        record[f"{name}/in_proj_block"] = np.array(
            state["params"]["layers"].mamba.in_proj.to_local().shape)
    step = shd.shard_train_step(model, opt, mesh)
    plans = []
    undo = counting_routes(plans)
    try:
        for i in range(STEPS):
            batch = part(f"{name}/batch{i}/")
            state, m = (counted(step, state, batch) if i == 0
                        else step(state, batch))
            record[f"{name}/loss{i}"] = m["loss"].numpy()
            record[f"{name}/grad_norm{i}"] = m["grad_norm"].numpy()
        record[f"{name}/train_plans"] = np.array(json.dumps(plans))
        finals = shd.whole_state(cfg, mesh, state)["params"]
        for j, p in enumerate(tree_leaves(finals)):
            record[f"{name}/final{j}"] = p.numpy()

        vocab = [Shard(0) if n == "data" else
                 Shard(2) if cfg.vocab_size % mesh.size(1) == 0 else
                 Replicate() for n in mesh.mesh_dim_names]

        def whole(logits):
            return DTensor.from_local(logits, mesh, vocab).full_tensor()

        whole_params = bridge(flat, cfg, "cpu")
        ps = shd.place_state(cfg, mesh, whole_params, shd.to_named(
            mesh, shd.fit_tree(mesh, shd.param_specs(cfg, mesh),
                               whole_params)))
        prompt = part(f"{name}/prompt/")
        cache, cspecs = shd.tp_cache(cfg, mesh,
                                     model.init_cache(BATCH, MAX_LEN))
        cache = placed(cache, cspecs)
        prefill = serve_step(model, mesh, "prefill")
        decode = serve_step(model, mesh, "decode")
        plans.clear()
        with torch.no_grad():
            logits, cache = counted(prefill, ps, placed(
                prompt, shd.batch_specs(cfg, mesh, prompt)), cache)
            if ssm:
                record[f"{name}/model_gathers"] = np.array(sorted(gathers))
            record[f"{name}/local_logits"] = np.array(logits.shape)
            if "state" in cache:
                record[f"{name}/local_state"] = np.array(json.dumps(
                    [list(t.to_local().shape) for t in cache["state"]]))
            if "cross_k" in cache:
                record[f"{name}/local_cross_k"] = np.array(
                    cache["cross_k"].to_local().shape)
            record[f"{name}/logits0"] = whole(logits).numpy()
            for j in range(DECODES):
                tok = torch.from_numpy(record[f"{name}/logits{j}"][:, -1]
                                       .argmax(-1).astype(np.int32))
                record[f"{name}/tokens{j}"] = tok.numpy()
                feed = {"tokens": tok[:, None]}
                logits, cache = decode(ps, placed(feed, shd.batch_specs(
                    cfg, mesh, feed)), cache)
                record[f"{name}/logits{j + 1}"] = whole(logits).numpy()
        record[f"{name}/serve_plans"] = np.array(json.dumps(plans))
        if "k" in cache:
            # which positions of this rank's block of the K cache were
            # written
            k = cache["k"].to_local()
            record[f"{name}/kv_written"] = (k != 0).flatten(3).any(-1).any(
                1).any(0).numpy()
    finally:
        undo()


def _rank_main(rank: int, world: int, store: str, inputs: str,
               out_dir: str, cases: dict) -> None:
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
        for name in cases:
            case_run(inp, name, record, cases)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **record)
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, tmp, inputs: str, cases: dict = CASES
                ) -> list[dict]:
    """``_rank_main`` over ``cases`` on ``world`` gloo processes; a rank's
    exception fails the caller with its traceback, and a run past
    ``RANK_LIMIT_S`` from its start is killed and fails
    (``torch_worlds.World``)."""
    out_dir = tmp / f"world{world}"
    out_dir.mkdir()
    return World(f"the port's world of {world}", _rank_main, world,
                 (world, str(tmp / f"store{world}"), inputs, str(out_dir),
                  cases), out_dir, RANK_LIMIT_S).join()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, the 8 ranks' records)."""
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    np.savez(tmp / "inputs.npz", **make_inputs())
    run_reference(str(tmp / "inputs.npz"), str(tmp / "ref.npz"))
    ref = dict(np.load(tmp / "ref.npz"))
    inp = {**dict(np.load(tmp / "inputs.npz")),
           **{k: v for k, v in ref.items() if "/params/" in k}}
    np.savez(tmp / "port_inputs.npz", **inp)
    return ref, spawn_ranks(8, tmp, str(tmp / "port_inputs.npz"))


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
    sequence-parallel where "model" divides the residual length (32 text
    positions, and 8 patches; not 31 or 30); the prefill and each decode
    step one, not sequence-parallel, in their own attention modes. Under
    "q_seq" rank i along "model" attends from rows [i n, (i + 1) n), n the
    residual length over the ranks. Where the decode is "kv_seq" the
    prefill's and decode steps' plans carry the cache's ``MAX_LEN`` and
    rank i's positions [i c, (i + 1) c), c = ``MAX_LEN`` over the ranks,
    of which it wrote those below the patches, prompt and decode steps
    (rank 3 of the (2, 4) cases none). A rank's logits are its batch rows
    and, where the vocab is local, its vocab columns."""
    _, ranks = runs
    arch, over, (data, model), seq = CASES[name]
    m, vocab_mode, train, seq_parallel, prefill, decode = PLANS[name]
    cfg = reduced(arch, over)
    patches = cfg.n_patches if cfg.family == "vlm" else 0

    split = decode[0] == "kv_seq"
    per = MAX_LEN // model          # a rank's positions where split

    def want(heads, n, sp, rank, serve=True):
        plan = {"model": m, "heads": heads[0], "local_heads": heads[1],
                "mlp": "local", "vocab": vocab_mode, "seq_parallel": sp,
                "model_rank": rank % model, "q_rows": None}
        if heads[0] == "q_seq":
            rows = (n + patches) // model
            plan.update(q_rows=[rows * (rank % model),
                                rows * (rank % model + 1)],
                        q_seq_heaviest_over_mean=(2 * m - 1) / m)
        if serve and split:
            plan.update(cache_len=MAX_LEN,
                        kv_rows=[per * (rank % model),
                                 per * (rank % model + 1)])
        return plan

    assert m == model
    for rank, rec in enumerate(ranks):
        assert json.loads(str(rec[f"{name}/train_plans"])) == [
            want(train, seq, seq_parallel, rank, serve=False)] * STEPS
        assert json.loads(str(rec[f"{name}/serve_plans"])) == [
            want(prefill, PROMPT, False, rank)] + [
            want(decode, 1, False, rank)] * DECODES
        if split:
            filled = PROMPT + patches + DECODES - per * (rank % model)
            assert rec[f"{name}/kv_written"].tolist() == [
                i < filled for i in range(per)]
        vocab = cfg.vocab_size // (model if vocab_mode == "local" else 1)
        assert list(rec[f"{name}/local_logits"]) == [BATCH // data, 1, vocab]


# ---------------------------------------------------------------------------
# the plan and the pieces, in this process
# ---------------------------------------------------------------------------
# the attention's mode in train_4k, prefill_32k and decode_32k, its local
# (query, KV) heads in train_4k, the MLP, the vocab, and the SSM block's
# mode and heads a rank at m = 16 for every dense, vlm, ssm and hybrid
# config: heads local only where 16 divides both head counts, the KV heads
# replicated where 16 divides the query heads and the KV heads divide 16,
# else the query rows split where 16 divides the sequence (never in
# decode: there the cache's 32768 positions split, "kv_seq"); None where
# the model has no attention or MLP; SSM heads local where 16 divides them
# (mamba2's 64, zamba2's 80), stored by rank where 16 divides N too
# (mamba2's 128, zamba2's 64)
AT_16 = {"phi3-mini-3.8b": (("local",) * 3, [2, 2], "local", "local", None),
         "llama-3.1-8b": (("kv_replicated",) * 3, [2, 1], "local", "local",
                          None),
         "llama-3.2-1b": (("kv_replicated",) * 3, [2, 1], "local", "local",
                          None),
         "minitron-4b": (("q_seq", "q_seq", "kv_seq"), [24, 8], "local",
                         "local", None),
         "llava-next-34b": (("q_seq", "q_seq", "kv_seq"), [56, 8],
                            "local", "local", None),
         "smollm-135m": (("q_seq", "q_seq", "kv_seq"), [9, 3], "local",
                         "local", None),
         "smollm-360m": (("q_seq", "q_seq", "kv_seq"), [15, 5], "local",
                         "local", None),
         "mamba2-1.3b": ((None,) * 3, None, None, "whole",
                         ("local", 4, "by_rank")),
         "zamba2-2.7b": (("local",) * 3, [2, 2], "local", "local",
                         ("local", 5, "by_rank")),
         "whisper-tiny": (("q_seq", "q_seq", "kv_seq"), [6, 6], "local",
                          "whole", None)}
# the enc-dec encoder's attention in train_4k and prefill_32k (a decode
# step runs no encoder): 16 divides neither its 6 heads nor its 1500
# positions
ENCODER_AT_16 = {"whisper-tiny": ("gathered", "gathered", None)}


@pytest.mark.parametrize("arch", sorted(AT_16))
def test_plan_at_sixteen(arch):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.tensor_parallel import TP_FAMILIES, plan
    cfg = get_config(arch)
    assert cfg.family in TP_FAMILIES
    modes, local_heads, mlp, vocab, ssm = AT_16[arch]
    got = []
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        cell = SHAPES[shape]
        seq = 1 if cell.kind == "decode" else cell.seq_len
        got.append(plan(cfg, 16, kind=cell.kind, seq_len=seq,
                        cache_len=None if cell.kind == "train" else
                        cell.seq_len).record())
    assert tuple(p["heads"] for p in got) == modes
    p = got[0]
    assert (p["local_heads"], p["mlp"], p["vocab"]) == (local_heads, mlp,
                                                        vocab)
    for q in got:
        assert ((q["ssm"], q["ssm_heads"], q["ssm_layout"]) if "ssm" in q
                else None) == ssm
    assert tuple(q["encoder"]["heads"] if "encoder" in q else None
                 for q in got) == ENCODER_AT_16.get(arch, (None,) * 3)
    assert p["seq_parallel"] is True
    for kind, seq in (("train", 4095), ("prefill", 4096), ("decode", 1)):
        assert plan(cfg, 16, kind=kind, seq_len=seq).seq_parallel is False
    # T not divisible by 16: no query rows to split
    assert plan(cfg, 16, kind="train", seq_len=4095).heads == \
        ("gathered" if modes[0] == "q_seq" else modes[0])
    # at m = 1 every config takes the route of one rank
    one = plan(cfg, 1, kind="train", seq_len=4096)
    assert one.heads == ("local" if modes[0] else None)
    assert one.ssm == (ssm and "local")


@pytest.mark.parametrize("arch", ["minitron-4b", "llava-next-34b",
                                  "smollm-135m", "smollm-360m",
                                  "llama-3.1-8b", "zamba2-2.7b"])
def test_kv_seq_only_where_m_divides_the_cache(arch):
    """At m = 16 a decode step is "kv_seq" only for the dense and vlm
    configs whose heads do not split over 16 and only where 16 divides the
    cache's positions: at 32760 positions, or with no cache length, it
    stays "gathered" (a rule of the plan). A prefill of such a config
    keeps its own mode and carries the cache's positions (it writes that
    layout); a train step ignores them. The ranks' positions tile the
    cache in rank order."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.tensor_parallel import cache_split, plan
    cfg = get_config(arch)
    split = arch not in ("llama-3.1-8b", "zamba2-2.7b")
    dec = plan(cfg, 16, kind="decode", seq_len=1, cache_len=32768)
    assert (dec.heads == "kv_seq") == split == cache_split(cfg, 16, 32768)
    assert dec.cache_len == (32768 if split else None)
    for cache_len in (32760, None):
        other = plan(cfg, 16, kind="decode", seq_len=1, cache_len=cache_len)
        assert other.cache_len is None
        assert other.heads == ("gathered" if split else dec.heads)
    pre = plan(cfg, 16, kind="prefill", seq_len=32768, cache_len=32768)
    assert pre.heads == ("q_seq" if split else dec.heads)
    assert pre.cache_len == dec.cache_len
    train = plan(cfg, 16, kind="train", seq_len=4096, cache_len=32768)
    assert train.cache_len is None and train.heads != "kv_seq"
    if split:
        rows = [dec.kv_rows(r) for r in range(16)]
        assert rows[0] == (0, 2048) and rows[-1] == (30720, 32768)
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
        assert dec.record(15)["kv_rows"] == [30720, 32768]
        assert not cache_split(cfg, 1, 32768)
    else:
        assert dec.kv_rows(0) is None


def test_q_rows_tile_the_sequence():
    """Under "q_seq" the ranks' query rows are contiguous, in rank order,
    and cover the sequence; the record of the last rank carries them and
    (2m - 1)/m."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.tensor_parallel import plan
    p = plan(get_config("minitron-4b"), 16, kind="train", seq_len=4096)
    rows = [p.q_rows(r) for r in range(16)]
    assert rows[0] == (0, 256) and rows[-1] == (3840, 4096)
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    last = p.record(15)
    assert last["q_rows"] == [3840, 4096] and last["model_rank"] == 15
    assert last["q_seq_heaviest_over_mean"] == 31 / 16


class _Group:
    """A stand-in process group of ``size`` ranks, this one ``rank``."""
    group_name = "stand-in"

    def __init__(self, size: int = 1, rank: int = 0) -> None:
        self._size, self._rank = size, rank

    def size(self):
        return self._size

    def rank(self):
        return self._rank


def test_kv_slice_takes_the_ranks_kv_head():
    """Under "kv_replicated" (4 query heads on 2 KV heads, 4 ranks) ranks 0
    and 1 take KV head 0's columns of a whole ``wk``, ranks 2 and 3 head
    1's, and a slice's gradient is zero outside its columns."""
    from repro_torch.distributed.tensor_parallel import Route, plan
    cfg = reduced("smollm-135m", SMOLLM)
    p = plan(cfg, 4, kind="decode", seq_len=1)
    assert (p.heads, p.local_heads, p.kv_share) == ("kv_replicated", (1, 1),
                                                    2)
    hd = cfg.hd
    w = torch.arange(3 * 2 * hd, dtype=torch.float32).reshape(3, 2 * hd)
    for r in range(4):
        leaf = w.clone().requires_grad_(True)
        got = Route(p, _Group(4, r)).kv_slice(leaf)
        head = r // 2
        assert torch.equal(got, w[:, head * hd:(head + 1) * hd])
        got.sum().backward()
        want = torch.zeros_like(w)
        want[:, head * hd:(head + 1) * hd] = 1
        assert torch.equal(leaf.grad, want)


@pytest.mark.parametrize("cached", [False, True])
def test_attention_rows_are_rows_of_the_whole(cached):
    """``attention_block`` with ``q_rows=(a, b)``: rows [a, b) of the whole
    sublayer's output, without a cache (K/V over rows [0, b)) and into a
    cache (every row written, the cache the whole call's)."""
    from repro_torch.models.attention import attention_block, init_attn
    cfg = reduced("smollm-135m", THREE)
    gen = torch.Generator().manual_seed(3)
    p = init_attn(gen, cfg, "cpu")
    x = torch.randn((2, 12, cfg.d_model), generator=gen)

    def run(rows):
        cache = None
        if cached:
            cache = tuple(torch.zeros((2, 16, cfg.n_kv_heads, cfg.hd))
                          for _ in range(2))
        out, _ = attention_block(p, x, cfg, kv_cache=cache, q_rows=rows)
        return out, cache

    whole, whole_cache = run(None)
    for a, b in ((0, 4), (4, 8), (8, 12), (3, 11)):
        out, cache = run((a, b))
        assert out.shape == (2, b - a, cfg.d_model)
        torch.testing.assert_close(out, whole[:, a:b], rtol=1e-5, atol=1e-6)
        if cached:
            for c, w in zip(cache, whole_cache):
                assert torch.equal(c, w)


@pytest.mark.parametrize("kind", ["cross", "non_causal"])
def test_cross_and_encoder_rows_are_rows_of_the_whole(kind):
    """``attention_block`` with ``q_rows=(a, b)`` in the enc-dec family's
    two other modes: cross-attention (the encoder's K/V of 20 positions)
    returns (B, b - a, d), rows [a, b) of the whole; the encoder's
    non-causal self-attention takes K/V from every row, so its rows
    [a, b) read the keys after b too."""
    from repro_torch.models.attention import attention_block, init_attn
    cfg = reduced("smollm-135m", THREE)
    gen = torch.Generator().manual_seed(4)
    p = init_attn(gen, cfg, "cpu")
    x = torch.randn((2, 12, cfg.d_model), generator=gen)
    kw = dict(causal=False, use_rope=False)
    if kind == "cross":
        kw = dict(cross_kv=tuple(torch.randn((2, 20, cfg.n_kv_heads, cfg.hd),
                                             generator=gen)
                                 for _ in range(2)))
    whole, _ = attention_block(p, x, cfg, **kw)
    for a, b in ((0, 4), (4, 8), (8, 12), (3, 11)):
        out, _ = attention_block(p, x, cfg, q_rows=(a, b), **kw)
        assert out.shape == (2, b - a, cfg.d_model)
        torch.testing.assert_close(out, whole[:, a:b], rtol=1e-5, atol=1e-6)


class _RecordedMerge:
    """A ``KVSplit`` stand-in for rank ``rank`` of ``m``: ``merge``
    records the rank's partial and returns ``merged`` (the ranks' partials
    merged after a first pass), or zeros in the first pass."""

    def __init__(self, m, rank, cache_len, sink, merged=None):
        self.rows = cache_len // m
        self.start, self.cache_len = rank * self.rows, cache_len
        self.sink, self.merged = sink, merged

    def merge(self, out, lse):
        assert out.dtype == torch.float32 and lse.dtype == torch.float32
        self.sink.append((out.clone(), lse.clone()))
        return torch.zeros_like(out) if self.merged is None else self.merged


def _split_inputs(seed=3, S=32, B=4):
    from repro_torch.models.attention import init_attn
    cfg = reduced("smollm-135m", THREE)
    gen = torch.Generator().manual_seed(seed)
    p = init_attn(gen, cfg, "cpu")
    cache = [torch.randn((B, S, cfg.n_kv_heads, cfg.hd), generator=gen)
             for _ in range(2)]
    return cfg, p, cache, gen


def test_split_cache_decode_is_the_whole_decode():
    """``attention_block`` on 4 ranks' blocks of a cache of 32 positions
    ("kv_seq"): each rank writes the new token's row only where it owns
    the clamped index (slot 3's index 40 is past the end: the last row,
    rank 3's), attends over its block with its own lengths, and the
    ranks' partials merged in rank order (``merge_attention_partials``)
    give the whole decode step's output within 1e-6; the blocks equal the
    whole cache's after its write. A rank with no valid position for a
    slot (slot 0 at index 3 on ranks 1 to 3) returns zeros and -inf."""
    from repro_torch.kernels.ref import merge_attention_partials
    from repro_torch.models.attention import attention_block
    cfg, p, cache, gen = _split_inputs()
    m, S = 4, 32
    idx = torch.tensor([3, 12, 16, 40], dtype=torch.int32)
    x = torch.randn((4, 1, cfg.d_model), generator=gen)
    whole = [c.clone() for c in cache]
    want, _ = attention_block(p, x, cfg, kv_cache=tuple(whole),
                              cache_index=idx)
    blocks = [[c[:, r * 8:(r + 1) * 8].clone() for c in cache]
              for r in range(m)]
    parts = []
    for r in range(m):
        attention_block(p, x, cfg, kv_cache=tuple(
            c.clone() for c in blocks[r]), cache_index=idx,
            kv_split=_RecordedMerge(m, r, S, parts))
    outs = torch.stack([o for o, _ in parts])
    lses = torch.stack([lse for _, lse in parts])
    assert torch.all(lses[1:, 0] == -torch.inf)
    assert torch.all(outs[1:, 0] == 0)
    merged = merge_attention_partials(outs, lses)
    for r in range(m):
        got, _ = attention_block(p, x, cfg, kv_cache=tuple(blocks[r]),
                                 cache_index=idx,
                                 kv_split=_RecordedMerge(m, r, S, [],
                                                         merged))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        for blk, w in zip(blocks[r], whole):
            assert torch.equal(blk, w[:, r * 8:(r + 1) * 8])


@pytest.mark.parametrize("rows", [None, (4, 8)])
def test_split_cache_prefill_writes_the_ranks_rows(rows):
    """A prefill of 12 tokens into 4 ranks' blocks of 8 positions (every
    row, or a "q_seq" rank's rows 4 to 8): each rank writes the positions
    it owns, as the whole cache's prefill writes them, and attends over
    the fresh K/V, so its output is the whole prefill's rows within
    1e-6; a prefill from a nonzero index raises."""
    from repro_torch.models.attention import attention_block
    cfg, p, cache, gen = _split_inputs(S=32, B=2)
    cache = [c[:2].zero_() for c in cache]
    x = torch.randn((2, 12, cfg.d_model), generator=gen)
    whole = [c.clone() for c in cache]
    want, _ = attention_block(p, x, cfg, kv_cache=tuple(whole), q_rows=rows)
    for r in range(4):
        blk = [c[:, r * 8:(r + 1) * 8].clone() for c in cache]
        got, _ = attention_block(p, x, cfg, kv_cache=tuple(blk), q_rows=rows,
                                 kv_split=_RecordedMerge(4, r, 32, []))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        for b, w in zip(blk, whole):
            assert torch.equal(b, w[:, r * 8:(r + 1) * 8])
    with pytest.raises(ValueError, match="index 0"):
        attention_block(p, x, cfg, kv_cache=tuple(blk),
                        cache_index=torch.tensor([0, 2], dtype=torch.int32),
                        kv_split=_RecordedMerge(4, 3, 32, []))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-1.3b",
                                  "zamba2-2.7b", "whisper-tiny",
                                  "smollm-135m"])
def test_route_only_for_tp_families_under_a_policy(arch):
    """No policy: no route for any family. Under a policy on a mesh with
    a ``"model"`` axis, a route for the dense, vlm, ssm, hybrid and
    enc-dec families (whisper-tiny's with its encoder's plan) and the
    expert-parallel MoE configs (qwen2-moe-a2.7b; not a grouped-dispatch
    MoE)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.distributed import logical, tensor_parallel

    class Mesh:
        mesh_dim_names = ("data", "model")

        def get_group(self, name):
            return _Group()

        def size(self):
            return 1

    cfg = get_config(arch)
    assert tensor_parallel.route(cfg, kind="train", seq_len=8) is None
    with logical.policy(Mesh()):
        r = tensor_parallel.route(cfg, kind="train", seq_len=8, rows=2)
        assert (r is not None) == (cfg.family in ("dense", "vlm", "ssm",
                                                  "hybrid", "moe", "encdec"))
        if cfg.family == "encdec":
            assert r.plan.encoder.seq_len == cfg.enc_len
            assert r.encoder.plan is r.plan.encoder
        if cfg.family == "moe":
            assert r.plan.ep == 1 and r.plan.capacity is not None
            assert tensor_parallel.route(replace(cfg, moe_impl="gspmd"),
                                         kind="train", seq_len=8) is None
    assert logical.model_group() is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_vocab_parallel_loss_is_the_plain_loss_on_one_rank(dtype, masked):
    """Over one rank the vocab-parallel loss computes the plain loss's
    value and gradient op for op: the same bits."""
    from repro_torch.distributed.tensor_parallel import Route, plan
    from repro_torch.models.common import cross_entropy
    cfg = reduced("smollm-135m", SMOLLM)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 7, 256), np.float32) * 4)
    x = x.to(getattr(torch, dtype))
    labels = torch.from_numpy(rng.integers(0, 256, (3, 7), dtype=np.int32))
    mask = (torch.from_numpy(rng.integers(0, 2, (3, 7), dtype=np.int32))
            if masked else None)
    route = Route(plan(cfg, 1, kind="train", seq_len=7), None)
    out = []
    for tp in (None, route):
        logits = x.clone().requires_grad_(True)
        loss = cross_entropy(logits, labels, mask, tp=tp)
        loss.backward()
        out.append((loss.detach(), logits.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_vocab_parallel_embedding_sums_to_the_lookup():
    """Each rank's rows of the table: the lookups, summed over the ranks,
    are the whole lookup (each id is on one rank, the rest read 0)."""
    import torch.nn.functional as F

    from repro_torch.distributed.tensor_parallel import \
        vocab_parallel_embedding
    rng = np.random.default_rng(9)
    table = torch.from_numpy(rng.standard_normal((24, 5), np.float32))
    ids = torch.from_numpy(rng.integers(0, 24, (2, 9), dtype=np.int32))
    parts = [vocab_parallel_embedding(ids, chunk, 6 * r)
             for r, chunk in enumerate(table.chunk(4))]
    assert all(int((p != 0).any(-1).sum()) < ids.numel() for p in parts)
    assert torch.equal(sum(parts), F.embedding(ids.long(), table))


# ---------------------------------------------------------------------------
# the dry run of a reduced dense cell on a (4, 4) mesh
# ---------------------------------------------------------------------------
FAKE = """
import json, sys, torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world

# name -> (query heads, KV heads, T, kind): the decode cells' T is their
# cache's positions; the enc-dec cell's encoder has 100 positions
CELLS = {"local": (8, 4, 256, "train"), "kv_replicated": (8, 2, 256, "train"),
         "gathered": (6, 2, 250, "train"), "q_seq": (6, 2, 256, "train"),
         "kv_seq": (6, 2, 256, "decode"),
         "encdec_kv_seq": (6, 2, 256, "decode")}
rank, names = int(sys.argv[1]), sys.argv[2:]
out = {}
with fake_world(16, rank=rank):
    mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    for name in names:
        hq, kv, seq, kind = CELLS[name]
        over = dict(n_layers=2, d_model=256, n_heads=hq, n_kv_heads=kv,
                    head_dim=32, d_ff=1024, vocab_size=1024,
                    param_dtype=torch.float32, compute_dtype=torch.float32,
                    remat="none")
        arch = "smollm-135m"
        if name.startswith("encdec"):
            arch = "whisper-tiny"
            over.update(n_enc_layers=2, enc_len=100)
        out[name] = dryrun.count_cell(
            arch, ShapeCell(kind, kind, seq, 16), mesh, mesh_name="4x4",
            extra_cfg=over)
with open(f"records{rank}.json", "w") as f:
    json.dump(out, f)
"""
# the rank each process counts and its cells, the two processes side by
# side: rank 3 is the last along "model" of the (4, 4) mesh, whose query
# rows are the last quarter
FAKE_RANKS = {0: ("local", "kv_replicated", "gathered", "kv_seq"),
              3: ("q_seq", "encdec_kv_seq")}
FAKE_LIMIT_S = 360


@pytest.fixture(scope="module")
def fake_cells(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("tp_dryrun")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    procs = [Reference(f"the fake world's rank {rank}",
                       [sys.executable, "-c", FAKE, str(rank), *names], env,
                       cwd / f"rank{rank}.log", FAKE_LIMIT_S, cwd=cwd)
             for rank, names in FAKE_RANKS.items()]
    out = {}
    for rank, proc in zip(FAKE_RANKS, procs):
        proc.wait()
        with open(cwd / f"records{rank}.json") as f:
            out.update(json.load(f))
    return out


# name -> the plan's local heads, its query rows, whether sequence-parallel
FAKE_PLANS = {"local": ([2, 1], None, True),
              "kv_replicated": ([2, 1], None, True),
              "gathered": ([6, 2], None, False),
              "q_seq": ([6, 2], [192, 256], True),
              "kv_seq": ([6, 2], None, False)}


@pytest.mark.parametrize("name", ["local", "gathered", "kv_replicated",
                                  "q_seq", "kv_seq"])
def test_dry_run_divides_the_work(fake_cells, name):
    """A reduced dense train cell (16 x 256 tokens, d_ff 1024, vocab 1024)
    in a fake world of 16 on a (4, 4) mesh: ``"tp"`` is the plan of the
    counted rank (rank 3, the last along "model", for q_seq); with the
    heads local or the KV heads replicated (8 heads on 4 or 2 KV heads)
    rank 0 counts within 1.25x of the semantic FLOPs over 16; the heaviest
    q_seq rank (6 heads on 2) within (2m - 1)/m x 1.25 of it; with the
    attention gathered (T 250, which 4 ranks do not divide) it repeats
    attention along "model", and counts more than the local plan. A decode
    step of 16 rows against a cache of 256 positions, 6 heads on 2 KV
    heads ("kv_seq"): rank 0 holds positions 0 to 64 of its 4 rows, 1/4
    of its data rows' cache (1/16 of the whole), and the merge of the
    ranks' (4, 6, 33) fp32 partials a layer counts among the
    all-gathers."""
    r = fake_cells[name]
    assert r["status"] == "ok" and r["chips"] == 16
    local_heads, rows, sp = FAKE_PLANS[name]
    rank = 3 if name == "q_seq" else 0
    want = {"model": 4, "heads": name, "local_heads": local_heads,
            "mlp": "local", "vocab": "local", "seq_parallel": sp,
            "model_rank": rank, "q_rows": rows}
    if rows is not None:
        want["q_seq_heaviest_over_mean"] = 7 / 4
    if name == "kv_seq":
        want.update(cache_len=256, kv_rows=[0, 64])
    assert r["tp"] == want and r["rank"] == rank
    if name == "kv_seq":
        # K and V (layers x rows x positions x KV heads x hd, fp32) and
        # the rows' int32 index
        cache, kv = r["cache_bytes"], 2 * 2 * 16 * 256 * 2 * 32 * 4
        assert cache["whole"] == kv + 16 * 4
        assert cache["rank"] == kv / 16 + 4 * 4
        merge = 16 * 2 * 4 * 6 * 33 * 4       # chips x layers x partial
        assert r["coll_by_kind"]["all-gather"] >= merge
        return
    share = r["rank0"]["flops"] / (r["semantic"]["flops"] / 16)
    assert share >= 1.0
    if name in ("local", "kv_replicated"):
        assert share <= 1.25, share
    elif name == "q_seq":
        assert share <= 7 / 4 * 1.25, share
    else:
        assert share > fake_cells["local"]["rank0"]["flops"] / (
            fake_cells["local"]["semantic"]["flops"] / 16)


def test_dry_run_holds_the_cross_kv_whole(fake_cells):
    """A reduced enc-dec decode cell (16 rows against a cache of 256
    positions, 6 heads on 2 KV heads, an encoder of 100 positions) in the
    fake world of 16 on (4, 4), counted on rank 3: the decoder's decode
    plan is "kv_seq" (rank 3 holds positions 192 to 256), no encoder plan
    (a decode step runs none), and the rank's cache is 1/16 of the self
    K/V and its data rows' cross K/V whole along "model" (1/4 of them)."""
    r = fake_cells["encdec_kv_seq"]
    assert r["status"] == "ok" and r["rank"] == 3
    assert r["tp"] == {"model": 4, "heads": "kv_seq", "local_heads": [6, 2],
                       "mlp": "local", "vocab": "local",
                       "seq_parallel": False, "model_rank": 3,
                       "q_rows": None, "cache_len": 256,
                       "kv_rows": [192, 256]}
    # layers x rows x positions x KV heads x hd, fp32, K and V
    self_kv = 2 * 2 * 16 * 256 * 2 * 32 * 4
    cross_kv = 2 * 2 * 16 * 100 * 2 * 32 * 4
    cache = r["cache_bytes"]
    assert cache["whole"] == self_kv + cross_kv + 16 * 4
    assert cache["rank"] == self_kv / 16 + cross_kv / 4 + 4 * 4
