"""The port's shape tables and launch tooling against the reference's
(``repro/configs/__init__.py``, ``repro/launch/build.py``,
``repro/launch/dryrun.py``).

The 40-cell table, ``input_specs`` and ``cache_specs`` are compared entry
for entry (exact: shapes, dtypes and skip reasons are data). The dry run
itself runs in subprocesses, each with its own time limit: a fake world
of 16 ranks on an (8, 2) mesh counts reduced smollm-135m's train and
decode cells, the CLI writes the table's skip and counts an
expert-parallel MoE train cell over several batch ranks, and a fake world
of 16 on (4, 4) counts a reduced mamba2 decode cell's all-gathers a layer
in each ``in_proj`` layout.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import (ASSIGNED as REF_ASSIGNED, SHAPES as REF_SHAPES,
                           cache_specs as ref_cache_specs,
                           cell_runnable as ref_cell_runnable,
                           get_config as ref_get_config,
                           input_specs as ref_input_specs)
from repro_torch.configs import (_MODULES, ASSIGNED, SHAPES,
                                 SUBQUADRATIC_FAMILIES, cache_specs,
                                 cell_runnable, get_config, input_specs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.int32): torch.int32}
CELLS = [(a, s) for a in ASSIGNED for s in SHAPES]
DECODE_CELLS = [(a, s) for a, s in CELLS if SHAPES[s].kind == "decode"
                and cell_runnable(get_config(a), SHAPES[s])[0]]
SUBPROCESS_S = 120


def test_forty_cells_enumerate():
    assert ASSIGNED == REF_ASSIGNED
    assert list(SHAPES) == list(REF_SHAPES)
    assert len(CELLS) == 40
    runnable = [c for c in CELLS
                if cell_runnable(get_config(c[0]), SHAPES[c[1]])[0]]
    skipped = [c for c in CELLS if c not in runnable]
    assert len(runnable) == 32
    assert all(s == "long_500k" for _, s in skipped)
    assert {a for a, _ in skipped} == set(ASSIGNED) - {"mamba2-1.3b",
                                                       "zamba2-2.7b"}
    assert SUBQUADRATIC_FAMILIES == {"ssm", "hybrid"}
    for name, cell in SHAPES.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(
            REF_SHAPES[name])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_runnable_matches_reference(arch, shape):
    assert cell_runnable(get_config(arch), SHAPES[shape]) == \
        ref_cell_runnable(ref_get_config(arch), REF_SHAPES[shape])


def assert_same_specs(port: dict, ref: dict):
    assert list(port) == list(ref)
    for k, want in ref.items():
        got = port[k]
        assert isinstance(got, torch.Tensor) and got.device.type == "meta", k
        assert tuple(got.shape) == tuple(want.shape), k
        assert got.dtype == DTYPES[jnp.dtype(want.dtype)], k


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape, reduced):
    assert_same_specs(input_specs(arch, shape, reduced=reduced),
                      ref_input_specs(arch, shape, reduced=reduced))


def flat_by_path(tree, prefix=()):
    """{path: leaf} of a port tree: dict keys, NamedTuple field names."""
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in flat_by_path(v, prefix + (k,)).items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {p: x for f, v in zip(tree._fields, tree)
                for p, x in flat_by_path(v, prefix + (f,)).items()}
    return {prefix: tree}


def ref_flat_by_path(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(getattr(k, "key", getattr(k, "name", None))
                  for k in path)] = leaf
    return out


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_cache_specs_match_reference(arch, shape, reduced):
    got = flat_by_path(cache_specs(arch, shape, reduced=reduced))
    want = ref_flat_by_path(ref_cache_specs(arch, shape, reduced=reduced))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].device.type == "meta", path
        assert tuple(got[path].shape) == tuple(leaf.shape), path
        assert got[path].dtype == DTYPES[jnp.dtype(leaf.dtype)], path


@pytest.mark.parametrize("arch", list(_MODULES))
def test_build_models_match_reference(arch):
    """``active_params`` and, for every kind at two (B, S), the renamed
    ``vmem_kernel_bytes`` and ``min_step_bytes``: the same floats."""
    from repro.launch import build as ref_build
    from repro_torch.launch import build
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert build.active_params(cfg) == ref_build.active_params(ref)
    for kind in ("train", "prefill", "decode"):
        for B, S in ((4, 1024), (32, 32768)):
            assert build.shared_memory_kernel_bytes(cfg, kind, B, S) == \
                ref_build.vmem_kernel_bytes(ref, kind, B, S)
            kw = dict(param_bytes=2.0 * build.active_params(cfg),
                      cache_bytes=1e9 * B, tokens=B * S,
                      d_model=cfg.d_model,
                      n_layers=cfg.n_layers + cfg.n_enc_layers)
            assert build.min_step_bytes(kind, **kw) == \
                ref_build.min_step_bytes(kind, **kw)


def test_active_params_sane():
    from repro_torch.launch.build import active_params
    a = active_params(get_config("kimi-k2-1t-a32b"))
    assert 15e9 < a < 60e9
    assert 1e8 < active_params(get_config("smollm-135m")) < 3e8


def test_opt_for_arch_matches_reference():
    from repro.launch.build import OPT_FOR_ARCH as REF
    from repro_torch.launch.build import OPT_FOR_ARCH
    assert set(OPT_FOR_ARCH) == set(REF)
    for arch, want in REF.items():
        got = OPT_FOR_ARCH[arch]
        for f in dataclasses.fields(want):
            w = getattr(want, f.name)
            if f.name == "moment_dtype":
                w = DTYPES[jnp.dtype(w)]
            assert getattr(got, f.name) == w, (arch, f.name)


def run_python(code: str, cwd) -> None:
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=cwd,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")},
        capture_output=True, text=True, timeout=SUBPROCESS_S)
    assert out.returncode == 0, out.stderr[-4000:]


# the reduced smollm-135m's cells on an (8, 2) mesh: 16 rows, 8 a rank
DRYRUN = """
import dataclasses, json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ShapeCell, get_config
from repro_torch.launch import build, dryrun
from repro_torch.launch.mesh import fake_world

def reduced(arch):
    cfg = get_config(arch)
    red = cfg.reduced()
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(cfg)
            if f.name != "name" and getattr(red, f.name) != getattr(cfg, f.name)}

out = {}
with fake_world(16):
    mesh = init_device_mesh("cpu", (8, 2), mesh_dim_names=("data", "model"))
    over = reduced("smollm-135m")
    for name, kind in (("train", "train"), ("decode", "decode")):
        shape = ShapeCell(name, kind, 64, 16)
        out[name] = dryrun.count_cell("smollm-135m", shape, mesh,
                                      mesh_name="8x2", extra_cfg=over)
    # the extension of a 4-microbatch step from 2 and 3, against its count
    shape = ShapeCell("train", "train", 64, 32)
    make = lambda s, k: build.build_cell("smollm-135m", s, mesh,
                                         grad_accum=k, extra_cfg=over)
    out["extended"] = dryrun.cell_counts(make(shape, 4), shape, make)
    out["exact"] = dryrun._counts(make(shape, 4))
import torch.distributed as dist
from repro_torch.launch import mesh as meshes
out["meshes"] = {}
for n, multi in ((256, False), (512, True), (8, None)):
    with fake_world(n):
        m = (meshes.make_test_mesh() if multi is None else
             meshes.make_production_mesh(multi_pod=multi))
        out["meshes"][n] = [list(m.mesh_dim_names), list(m.shape),
                            list(meshes.data_axes(m)), meshes.n_chips(m),
                            m.device_type]
    out["meshes"][n].append(dist.is_initialized())
with open("records.json", "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def dryrun_records(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("dryrun")
    run_python(DRYRUN, cwd)
    with open(cwd / "records.json") as f:
        return json.load(f)


KEYS = {"arch", "shape", "mesh", "chips", "hlo_flops", "hlo_bytes",
        "coll_bytes", "coll_by_kind", "model_flops", "bytes_per_device",
        "compute_s", "memory_s", "collective_s", "min_bytes", "dominant",
        "useful_fraction", "roofline_fraction", "bound_s", "status", "tag",
        "shared_memory_kernel_bytes", "memory_kernel_s", "bound_kernel_s",
        "roofline_fraction_kernel", "semantic", "rank0", "peak_by_kind",
        "peak_held_by", "t_count_s", "grad_accum", "remat",
        "hbm_bytes_per_device", "fits_h100", "tp", "rank"}


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dryrun_record(dryrun_records, kind):
    r = dryrun_records[kind]
    assert set(r) == KEYS | ({"cache_bytes"} if kind == "decode" else set())
    assert r["status"] == "ok" and r["chips"] == 16 and r["mesh"] == "8x2"
    assert r["rank0"]["rows"] == 2
    assert r["bytes_per_device"] == r["peak_by_kind"]["Total"] > 0
    # the peak by what holds it adds up to the peak, the inputs among it
    held = r["peak_held_by"]
    assert sum(held.values()) == r["bytes_per_device"]
    assert held["inputs"] == r["peak_by_kind"]["Inputs"]
    assert r["fits_h100"] is True
    # every rank executes its rows, and the step is tensor-parallel along
    # "model" (the reduced smollm's heads, d_ff and vocab divide by 2), so
    # the cards' FLOPs are at least the semantic count (the gathers' copies
    # add the rest)
    assert r["tp"] == {"model": 2, "heads": "local", "local_heads": [2, 1],
                       "mlp": "local", "vocab": "local",
                       "seq_parallel": kind == "train", "model_rank": 0,
                       "q_rows": None}
    assert r["rank"] == 0
    assert r["rank0"]["flops"] * 16 >= r["semantic"]["flops"]
    assert r["hlo_flops"] == 16 * r["rank0"]["flops"]
    assert r["useful_fraction"] == r["model_flops"] / r["hlo_flops"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    # the step gathers every sharded leaf whole: all-gathers; training
    # reduce-scatters the gradients back
    assert r["coll_by_kind"]["all-gather"] > 0
    assert ("reduce-scatter" in r["coll_by_kind"]) == (kind == "train")
    if kind == "decode":
        # a serve cell's cache: K and V a 16th a rank (rows over "data",
        # KV heads over "model"), the 16 rows' int32 index 2 rows a rank
        cache = r["cache_bytes"]
        assert (cache["whole"] - 16 * 4) / 16 + 2 * 4 == cache["rank"] > 0


def test_meshes_over_a_fake_world(dryrun_records):
    """The production meshes over 256 and 512 fake ranks, the test mesh
    over 8; each world ends with its block."""
    assert dryrun_records["meshes"] == {
        "256": [["data", "model"], [16, 16], ["data"], 256, "cpu", False],
        "512": [["pod", "data", "model"], [2, 16, 16], ["pod", "data"], 512,
                "cpu", False],
        "8": [["data", "model"], [4, 2], ["data"], 8, "cpu", False]}


def test_dryrun_extends_microbatches_exactly(dryrun_records):
    got, want = dryrun_records["extended"], dryrun_records["exact"]
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-9, abs=1e-6), key


def test_dryrun_cli_skips_and_refuses(tmp_path):
    """A dense long_500k cell: ``skipped`` with the reference's reason. A
    reduced expert-parallel MoE train cell on 8 data ranks (the batch over
    all of them, which ``shard_train_step`` refused before it trained the
    MoE family by expert parallelism): counted, its plan recorded, and its
    all-to-all bytes those of the buffers ``moe_ep.expert_parallel``
    sends, E_pad x C x d each: the tokens out and the results back in the
    forward, their gradients in the backward, each layer."""
    run_python("""
        import sys
        from repro_torch.launch import dryrun
        sys.exit(dryrun.main(["--arch", "smollm-135m", "--shape",
                              "long_500k"]))
    """, tmp_path)
    with open(tmp_path / "experiments/dryrun_torch/"
              "smollm-135m__long_500k__pod16x16.json") as f:
        r = json.load(f)
    want = ref_cell_runnable(ref_get_config("smollm-135m"),
                             REF_SHAPES["long_500k"])[1]
    assert r == {"arch": "smollm-135m", "shape": "long_500k",
                 "mesh": "pod16x16", "status": "skipped", "reason": want}

    out = subprocess.run(
        [sys.executable, "-c", DRYRUN.split("out = {}")[0] + textwrap.dedent("""
            from repro_torch.launch.mesh import fake_world
            def small(arch, shape_id, *, multi_pod, **kw):
                with fake_world(8):
                    mesh = init_device_mesh("cpu", (8, 1),
                                            mesh_dim_names=("data", "model"))
                    over = reduced(arch)
                    del over["moe_impl"]          # expert-parallel
                    return dryrun.count_cell(
                        arch, ShapeCell(shape_id, "train", 64, 16), mesh,
                        mesh_name="8x1", extra_cfg=over)
            dryrun.run_cell = small
            sys.exit(dryrun.main(["--arch", "qwen2-moe-a2.7b", "--shape",
                                  "train_4k"]))
        """)], cwd=tmp_path, capture_output=True, text=True,
        timeout=SUBPROCESS_S,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode == 0, out.stderr[-4000:]
    with open(tmp_path / "experiments/dryrun_torch/"
              "qwen2-moe-a2.7b__train_4k__pod16x16.json") as f:
        r = json.load(f)
    from repro_torch.distributed.tensor_parallel import ep_capacity
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                              moe_impl="ep")
    rows, e_pad = 16 // 8, 8                 # 4 experts padded to 8 ranks
    capacity = ep_capacity(rows * 64, cfg)   # one rank along "model"
    assert r["status"] == "ok" and r["chips"] == 8
    assert (r["tp"]["ep"], r["tp"]["ep_experts"], r["tp"]["capacity"]) == (
        8, 1, capacity)
    buffer = e_pad * capacity * cfg.d_model * 4       # fp32
    assert r["coll_by_kind"]["all-to-all"] == 8 * cfg.n_layers * 4 * buffer


# a reduced mamba2 decode cell (d 128, d_inner 256, 8 SSM heads) on (4, 4)
# at two depths, its state width N 16 (m divides it: "by_rank") or 18
# (m does not: "whole")
SSM_GATHERS = """
import json
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world

out = {}
with fake_world(16):
    mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    for n in (16, 18):
        for depth in (2, 4):
            r = dryrun.count_cell(
                "mamba2-1.3b", ShapeCell("decode", "decode", 64, 16), mesh,
                mesh_name="4x4", extra_cfg=dict(
                    n_layers=depth, d_model=128, vocab_size=512,
                    ssm_state=n, ssm_head_dim=32))
            out[f"{n}/{depth}"] = [r["status"], r["tp"],
                                   r["coll_by_kind"]["all-gather"]]
with open("records.json", "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def ssm_gathers(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("ssm_gathers")
    run_python(SSM_GATHERS, cwd)
    with open(cwd / "records.json") as f:
        return json.load(f)


@pytest.mark.parametrize("n", [16, 18])
def test_dryrun_counts_in_proj_gathers_by_its_layout(ssm_gathers, n):
    """The dry run's all-gather operand bytes a layer of a reduced mamba2
    decode step (rank 0 of a fake world of 16 on (4, 4), its params bf16 as
    mamba2-1.3b's), from the
    count at 4 layers less the count at 2, against a count by hand. Each
    layer gathers ``in_proj``'s block (d/4 x d_proj/4) and ``out_proj``'s
    (d_inner/4 x d/4) along "data". Under "by_rank" (N 16) it gathers along
    "model" only the rank's B and C: N/4 columns each of ``in_proj`` (d
    rows), of ``conv_w`` (K rows) and of ``conv_b``. Under "whole" (N 18:
    4 ranks divide the heads, not N) it gathers along "model" the whole
    ``in_proj`` from its d/4 x d_proj/4 blocks gathered along "data"
    (d x d_proj / 4) and ``conv_w``'s and ``conv_b``'s channels."""
    d, din, h, k = 128, 256, 8, 4
    dp, ch = 2 * din + 2 * n + h, din + 2 * n
    lo, hi = ssm_gathers[f"{n}/2"], ssm_gathers[f"{n}/4"]
    assert lo[0] == hi[0] == "ok"
    layout = "by_rank" if n == 16 else "whole"
    assert (lo[1]["ssm"], lo[1]["ssm_heads"], lo[1]["ssm_layout"]) == (
        "local", 2, layout)
    per_layer = (hi[2] - lo[2]) / 16 / 2 / 2          # bf16 elements, rank 0
    data = d * dp // 16 + din * d // 16
    if layout == "by_rank":
        model = (d + k + 1) * 2 * n // 4
    else:
        model = d * dp // 4 + (k + 1) * ch // 4
    assert per_layer == data + model


# build_cell on the CPU as on the card, in fake worlds of 8 on (4, 2): a
# reduced expert-parallel kimi-k2 (6 experts padded to 8), ranks 0, 5 and 7
DEVICE_BUILD = """
import json
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from repro_torch.configs import ShapeCell
from repro_torch.distributed.sharding import local_shard
from repro_torch.launch import build
from repro_torch.launch.mesh import fake_world
from repro_torch.models.common import Deferred, tree_leaves

OVER = dict(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=32, vocab_size=256, n_experts=6, top_k=2,
            n_shared_experts=1, moe_impl="ep", param_dtype=torch.float32)
SSM = dict(n_layers=2, d_model=128, vocab_size=512, ssm_state=16,
           ssm_head_dim=32, param_dtype=torch.float32)

class Largest(TorchDispatchMode):
    # the largest tensor an op makes on the CPU
    def __init__(self):
        super().__init__()
        self.bytes, self.op = 0, None
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                n = t.untyped_storage().nbytes()
                if n > self.bytes:
                    self.bytes, self.op = n, str(func)
        return out

out = {}
for rank in (0, 5, 7):
    with fake_world(8, rank=rank):
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        with Largest() as largest:
            cell = build.build_cell("kimi-k2-1t-a32b",
                                    ShapeCell("train", "train", 8, 16), mesh,
                                    extra_cfg=OVER, device="cpu", seed=3)
        params = cell.args[0]["params"]
        shapes = build.param_shapes(cell.cfg)
        drawn = build.drawn_params(cell.cfg, "cpu", 3)
        rows = []
        for t, s, d in zip(tree_leaves(params), tree_leaves(shapes),
                           tree_leaves(drawn)):
            deferred = isinstance(d, Deferred)
            whole = d.block([[0, n] for n in s.shape]) if deferred else d
            want = local_shard(mesh, whole, t.placements)
            got = t.to_local()
            rows.append([list(s.shape), list(d.shape), deferred,
                         torch.equal(got, want), bool(got.any()),
                         got.numel()])
        out[rank] = {"rows": rows, "largest": largest.bytes,
                     "op": largest.op}
        # a reduced mamba2 (d 128, d_inner 256, 8 SSM heads, N 16), its
        # in_proj, conv_w and conv_b by rank over "model" (2 ranks): each
        # rank's block is the whole drawn leaf's columns of its heads' z,
        # x and dt and its halves of B and C
        cell = build.build_cell("mamba2-1.3b",
                                ShapeCell("train", "train", 8, 16), mesh,
                                extra_cfg=SSM, device="cpu", seed=3)
        mamba = cell.args[0]["params"]["layers"].mamba
        whole = build.drawn_params(cell.cfg, "cpu", 3)["layers"].mamba
        r = mesh.get_local_rank("model")
        span = lambda a, w: list(range(a + r * w, a + (r + 1) * w))
        proj = (span(0, 128) + span(256, 128) + span(512, 8)
                + span(528, 8) + span(544, 4))
        conv = span(0, 128) + span(256, 8) + span(272, 8)
        checks = {}
        for k, cols in (("in_proj", proj), ("conv_w", conv),
                        ("conv_b", conv)):
            t, d = getattr(mamba, k), getattr(whole, k)
            d = d.block([[0, n] for n in d.shape]) if isinstance(
                d, Deferred) else d
            block = d[..., cols]
            if k == "in_proj":         # its rows are cut along "data"
                block = block.chunk(4, -2)[mesh.get_local_rank("data")]
            checks[k] = [list(t.to_local().shape),
                         torch.equal(t.to_local(), block)]
        out[f"ssm{rank}"] = {"tp": cell.tp, "checks": checks}
with open("records.json", "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def device_builds(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("device_build")
    run_python(DEVICE_BUILD, cwd)
    with open(cwd / "records.json") as f:
        return json.load(f)


@pytest.mark.parametrize("rank", ["0", "5", "7"])
def test_device_build_draws_no_whole_leaf(device_builds, rank):
    """``build_cell`` on a device (the CPU here, in a fake world of 8 on
    (4, 2)): each leaf's local block is the block of the whole leaf drawn
    the same way (``model.init`` under ``deferred_draws``, its matrices'
    whole ``Deferred.block``), the routed experts padded with zeros from 6
    to 8 (ranks 6 and 7 hold padding alone), and no tensor larger than one
    layer's slice of a leaf (fp32) is made: the whole expert stacks (3 x 6
    x 64 x 32, 147 KB) never are."""
    r = device_builds[rank]
    assert r["rows"] and all(row[3] for row in r["rows"]), \
        [row for row in r["rows"] if not row[3]]
    # every matrix and embedding deferred: all but the three norms' ones
    assert [row[0] for row in r["rows"] if not row[2]] == [
        [64], [3, 64], [3, 64]]
    experts = [row for row in r["rows"] if len(row[0]) == 4]
    assert len(experts) == 3
    for shape, drawn, deferred, _, nonzero, n in experts:
        assert deferred and shape[1] == 8 and drawn[1] == 6
        assert n == shape[0] * 64 * 32
        assert nonzero == (int(rank) < 6)
    layer = max(4 * (math.prod(shape) // shape[0] if len(shape) >= 3
                     else math.prod(shape)) for shape, *_ in r["rows"])
    stack = min(4 * math.prod(drawn) for _, drawn, *_ in experts)
    assert layer < stack
    assert 0 < r["largest"] <= layer, r


@pytest.mark.parametrize("rank", ["0", "5", "7"])
def test_device_build_draws_the_by_rank_blocks(device_builds, rank):
    """``build_cell`` on a device (the CPU, a fake world of 8 on (4, 2))
    of a reduced mamba2 whose blocks are stored by rank: each rank's
    stored ``in_proj`` (its data rows), ``conv_w`` and ``conv_b`` are the
    whole drawn leaves' columns of its heads' z, x and dt and its halves
    of B and C, as ``place_state`` lays them out."""
    r = device_builds[f"ssm{rank}"]
    assert (r["tp"]["ssm"], r["tp"]["ssm_layout"]) == ("local", "by_rank")
    assert r["checks"] == {"in_proj": [[2, 32, 276], True],
                           "conv_w": [[2, 4, 144], True],
                           "conv_b": [[2, 144], True]}


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "zamba2-2.7b",
                                  "whisper-tiny", "llava-next-34b"])
def test_deferred_draws_follow_model_init(arch):
    """``model.init`` under ``deferred_draws`` (its reduced config, in
    fp32) against ``model.init``: the same leaves, shapes and dtypes; the
    constant leaves (norms, ``D``, ``conv_b``, ``A_log``) equal, the
    random ones (``dt_bias``, ``conv_w``, the matrices and embeddings,
    drawn whole by ``Deferred.block``) with their mean and deviation
    within five standard errors."""
    from repro_torch.launch import build
    from repro_torch.models.common import Deferred, tree_leaves
    from repro_torch.models.transformer import build_model
    cfg = get_config(arch).reduced()
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    drawn = tree_leaves(build.drawn_params(cfg, "cpu", 0))
    assert len(drawn) == len(tree_leaves(params))
    assert any(isinstance(d, Deferred) for d in drawn)
    for i, (d, p) in enumerate(zip(drawn, tree_leaves(params))):
        got = (d.block([[0, n] for n in d.shape])
               if isinstance(d, Deferred) else d)
        assert got.shape == p.shape and got.dtype == p.dtype, i
        if p.std() == 0 or torch.equal(got, p):
            assert torch.equal(got, p), i
            continue
        # five standard errors of the mean and of the deviation
        x, y = got.double(), p.double()
        sd, n = float(y.std()), y.numel()
        assert abs(float(x.mean() - y.mean())) <= 5 * sd / n ** 0.5, i
        assert abs(float(x.std()) / sd - 1) <= 5 / (2 * n) ** 0.5, i
