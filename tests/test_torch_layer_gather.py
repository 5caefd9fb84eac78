"""The sharded steps gather the params a layer at a time
(``repro_torch/distributed/sharding.py``: ``Placed``, ``gather_layer``),
as the reference's scan over its stacked layers holds each layer's
collectives in the loop body: a rank holds one layer's gathered copy at a
time, not the whole stack's.

A fake world of 16 ranks on a (4, 4) ("data", "model") mesh counts, on
the ``meta`` device, four reduced cells at two depths each (the pattern of
``tests/test_torch_tensor_parallel.py``'s dry runs, a subprocess with a
time limit of its own):
  * a dense train cell under ``remat="block"`` and a dense decode cell, 6
    heads on 2 KV heads, so the attention's four weights stay whole along
    "model" ("q_seq" in training, "kv_seq" in decode: llava-next-34b's
    plan at 16);
  * a mamba2 train cell under ``remat="block"``, its SSM heads local and
    its ``in_proj``, ``conv_w`` and ``conv_b`` stored by rank (each rank's
    block gathered along "data" alone);
  * an enc-dec (whisper) decode cell.
The widths make one layer's gathered leaves (the bytes its gather makes:
each leaf whose compute placements differ from its stored ones, in the
former) outweigh its activations, so the peak above the step's inputs
grows, per added layer, by less than one layer's gathered bytes where a
layer is gathered when it runs, and by at least that where the whole
stack is gathered for the step.
"""
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from torch_worlds import Reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAKE = """
import json, sys, torch
from dataclasses import replace
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard
from repro_torch.configs import ShapeCell, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel
from repro_torch.launch import dryrun
from repro_torch.launch.build import param_shapes
from repro_torch.launch.mesh import fake_world
from repro_torch.models.common import tree_leaves, tree_map

CELLS = json.loads(sys.argv[1])
out = {}
with fake_world(16):
    mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    for name, (arch, over, kind, seq, rows, depths) in CELLS.items():
        for depth in depths:
            extra = dict(over, n_layers=depth, param_dtype=torch.float32,
                         compute_dtype=torch.float32)
            r = dryrun.count_cell(arch, ShapeCell(kind, kind, seq, rows),
                                  mesh, mesh_name="4x4", extra_cfg=extra)
            # the bytes a layer's gather makes: each stacked leaf's layer
            # in its compute placements, where they differ from its stored
            cfg = replace(get_config(arch), **extra)
            plan = tensor_parallel.mesh_plan(
                cfg, mesh, kind=kind, seq_len=1 if kind == "decode" else seq,
                cache_len=None if kind == "train" else seq)
            shapes = param_shapes(cfg)
            stored = shd.to_named(mesh, shd.fit_tree(
                mesh, shd.param_specs(cfg, mesh), shapes))

            def gathered(t, lay, named):
                if all(a == b or mesh.size(j) == 1 for j, (a, b) in
                       enumerate(zip(named.placements, lay[0]))):
                    return 0
                n = t.numel() // depth * t.element_size()
                for j, p in enumerate(lay[0]):
                    if isinstance(p, Shard):
                        n //= mesh.size(j)
                return n
            key = "dec_layers" if cfg.family == "encdec" else "layers"
            sizes = tree_map(gathered, shapes[key],
                             shd.tp_layouts(cfg, mesh, plan)[key], stored[key])
            out[f"{name}/{depth}"] = {
                "status": r["status"], "tp": r["tp"],
                "peak": r["peak_by_kind"],
                "layer": sum(tree_leaves(sizes))}
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
"""

ATTN = dict(d_model=768, n_heads=6, n_kv_heads=2, head_dim=128, d_ff=2048,
            vocab_size=1024)
# name -> (arch, config fields, kind, T (a decode cell's cache), rows,
# depths): the dense cells' attention "q_seq" in training and "kv_seq" in
# decode, whole along "model"; the mamba2 block's 24 SSM heads local, its
# in_proj (768 x 3224) stored by rank, a layer's gather 768 x 806 of it;
# whisper's decoder "kv_seq"
CELLS = {"dense_train": ("smollm-135m", dict(ATTN, remat="block"), "train",
                         64, 16, (4, 8)),
         "dense_decode": ("smollm-135m", ATTN, "decode", 256, 16, (4, 8)),
         "ssm_train": ("mamba2-1.3b", dict(d_model=768, vocab_size=1024,
                                           ssm_state=64, ssm_head_dim=64,
                                           ssm_chunk=32, remat="block"),
                       "train", 64, 16, (4, 8)),
         "encdec_decode": ("whisper-tiny", dict(ATTN, n_enc_layers=2,
                                                enc_len=100),
                           "decode", 256, 16, (4, 8))}
# the cells split over two processes side by side
PROCS = (("dense_train", "dense_decode"), ("ssm_train", "encdec_decode"))
FAKE_LIMIT_S = 360


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("layer_gather")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    procs = []
    for i, names in enumerate(PROCS):
        cells = json.dumps({n: CELLS[n] for n in names})
        procs.append(Reference(
            f"the fake world's counts {names}",
            [sys.executable, "-c", FAKE, cells, str(cwd / f"out{i}.json")],
            env, cwd / f"proc{i}.log", FAKE_LIMIT_S, cwd=cwd))
    out = {}
    for i, proc in enumerate(procs):
        proc.wait()
        with open(cwd / f"out{i}.json") as f:
            out.update(json.load(f))
    return out


@pytest.mark.parametrize("name", sorted(CELLS))
def test_peak_grows_by_less_than_a_gathered_layer(counts, name):
    """Rank 0's peak above its inputs (params' and optimizer state's
    shards, batch, cache) grows from 4 to 8 layers by less than 4 layers'
    gathered leaves. A layer's gathered bytes are the same at both
    depths, and the plans are those the cells are chosen for."""
    lo, hi = CELLS[name][5]
    a, b = counts[f"{name}/{lo}"], counts[f"{name}/{hi}"]
    assert a["status"] == b["status"] == "ok"
    assert a["layer"] == b["layer"] > 0
    plan = a["tp"]
    if name.startswith("dense"):
        assert plan["heads"] == ("q_seq" if name == "dense_train"
                                 else "kv_seq")
    elif name == "ssm_train":
        assert (plan["ssm"], plan["ssm_heads"], plan["ssm_layout"]) == (
            "local", 6, "by_rank")
    else:
        assert plan["heads"] == "kv_seq"
    above = [c["peak"]["Total"] - c["peak"]["Inputs"] for c in (a, b)]
    per_layer = (above[1] - above[0]) / (hi - lo)
    assert per_layer < a["layer"], (per_layer, a["layer"], above)


def test_gather_layer_is_the_identity_on_plain_tensors():
    """One device, the engine and the CPU tests hand the model plain
    tensors: ``gather_layer`` returns each leaf itself, the tree's
    structure kept."""
    from repro_torch.distributed.sharding import gather_layer
    from repro_torch.models.attention import AttnParams
    ws = [torch.ones(2, 3) * i for i in range(4)]
    tree = {"attn": AttnParams(*ws), "norm": None}
    out = gather_layer(tree)
    assert isinstance(out["attn"], AttnParams) and out["norm"] is None
    assert all(x is w for x, w in zip(out["attn"], ws))


def test_a_stack_slice_drops_its_lead_axis():
    """A stacked leaf's layer keeps its layouts less the lead axis: a
    dim sharded along a mesh axis one lower, partial sums and replicas as
    they are; a stack sharded on its lead axis is refused."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.distributed.sharding import _drop_lead
    assert _drop_lead([Shard(2), Replicate()]) == (Shard(1), Replicate())
    assert _drop_lead((Partial(), Shard(1))) == (Partial(), Shard(0))
    assert _drop_lead(None) is None
    with pytest.raises(ValueError):
        _drop_lead([Shard(0), Replicate()])
