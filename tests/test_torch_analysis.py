"""The port's step accounting (``launch/analysis.py``) and roofline
(``launch/roofline.py``) against the reference's (``tests/test_analysis.py``
for the JAX package).

FLOPs are exact counts (products at 2*m*n*k*batch), so they compare
exactly. The products of each family's reduced loss, forward and backward
at B 2, T 64, are held to the reference's jaxpr of ``jax.value_and_grad``
walked for ``dot_general`` only; collectives are recorded from DTensor
redistributions in a fake world of 4 ranks in a subprocess with its own
time limit. The peak bytes held are exact too: held to sequences whose
peak is worked out by hand, and to ``MemTracker`` on reduced cells.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as ref_get_config
from repro.launch.analysis import _dot_flops
from repro.models.transformer import build_model as ref_build_model
from repro_torch.configs import cell_inputs, get_config
from repro_torch.launch.analysis import StepCounter, step_cost
from repro_torch.launch.build import param_shapes
from repro_torch.launch.roofline import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                         Roofline, collective_bytes)
from repro_torch.models.transformer import build_model
from repro_torch.train.train_step import value_and_grad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
meta = lambda *shape: torch.empty(shape, device="meta")


def test_step_cost_counts_matmul_exactly():
    m, k, n = 32, 64, 128
    flops, byts = step_cost(lambda a, b: a @ b, meta(m, k), meta(k, n))
    assert flops == 2 * m * k * n
    assert byts == 4 * (m * k + k * n + m * n)     # operands and result


def test_step_cost_counts_every_layer():
    """The counterpart of the reference's scan trip count: a Python loop
    over L layers runs, and is counted, L times."""
    L, d = 7, 16

    def f(ws, x):
        for w in ws.unbind(0):
            x = torch.tanh(x @ w)
        return x

    one, _ = step_cost(f, meta(1, d, d), meta(4, d))
    seven, _ = step_cost(f, meta(L, d, d), meta(4, d))
    assert one == 2 * 4 * d * d + 4 * d          # the product and the tanh
    assert seven == L * one


def test_step_cost_sees_checkpoint_recompute():
    d = 32
    w = torch.randn(d, d, requires_grad=True)
    x = torch.randn(8, d)
    layer = lambda w, x: torch.tanh(x @ w) @ w

    def grad(remat):
        def run():
            y = (checkpoint(layer, w, x, use_reentrant=False) if remat
                 else layer(w, x))
            return torch.autograd.grad(y.sum(), w)
        return step_cost(run)[0]

    plain, remat = grad(False), grad(True)
    assert remat - plain == 2 * 8 * d * d + 8 * d   # x @ w and tanh again


def test_roofline_dataclass_terms():
    r = Roofline(arch="a", shape="s", mesh="m", chips=256,
                 hlo_flops=256 * PEAK_FLOPS,          # exactly 1 s of compute
                 hlo_bytes=256 * HBM_BW * 0.5,       # 0.5 s of memory
                 coll_bytes=256 * LINK_BW * 0.25,    # 0.25 s of collectives
                 coll_by_kind={}, model_flops=256 * PEAK_FLOPS * 0.5,
                 bytes_per_device=0.0).finalize()
    assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (989.4e12, 3.35e12, 50e9)
    assert r.dominant == "compute"
    assert r.bound_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(0.5)
    assert r.collective_s == pytest.approx(0.25)
    assert r.useful_fraction == pytest.approx(0.5)
    assert r.roofline_fraction == pytest.approx(0.5)
    assert set(r.to_json()) >= {"dominant", "useful_fraction",
                                "roofline_fraction", "bound_s"}


def test_collective_bytes_operand_rule():
    records = [("all-gather", 4096, 4), ("reduce-scatter", 256, 4),
               ("all-reduce", 1024, 4), ("all-to-all", 512, 8)]
    total, by_kind = collective_bytes(records)
    assert by_kind == {"all-gather": 1024, "reduce-scatter": 1024,
                       "all-reduce": 1024, "all-to-all": 512}
    assert total == 3584


DTENSOR_COLLECTIVES = """
import json, torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.launch.analysis import StepCounter
from repro_torch.launch.mesh import fake_world
from repro_torch.launch.roofline import collective_bytes
out = {}
with fake_world(4):
    mesh = init_device_mesh("cpu", (4,))
    local = torch.empty((16, 8), device="meta")
    for name, src, dst in (("gather", Shard(0), Replicate()),
                           ("scatter", Partial(), Shard(0)),
                           ("reduce", Partial(), Replicate())):
        t = DTensor.from_local(local, mesh, [src], run_check=False)
        with StepCounter() as c:
            t.redistribute(mesh, [dst])
        out[name] = [c.collectives, collective_bytes(c.collectives)]
with open("collectives.json", "w") as f:
    json.dump(out, f)
"""


def test_collective_bytes_of_dtensor_redistributes(tmp_path):
    subprocess.run([sys.executable, "-c", DTENSOR_COLLECTIVES], cwd=tmp_path,
                   check=True, timeout=120, capture_output=True,
                   env={**os.environ,
                        "PYTHONPATH": os.path.join(REPO, "src")})
    with open(tmp_path / "collectives.json") as f:
        out = json.load(f)
    block = 16 * 8 * 4                           # a rank's fp32 block
    # an all-gather's output is the 4 blocks, its operand one
    assert out["gather"] == [[["all-gather", 4 * block, 4]],
                             [block, {"all-gather": block}]]
    # a reduce-scatter's output is a quarter of the block, its operand all
    assert out["scatter"] == [[["reduce-scatter", block // 4, 4]],
                              [block, {"reduce-scatter": block}]]
    assert out["reduce"] == [[["all-reduce", block, 4]],
                             [block, {"all-reduce": block}]]


# ---------------------------------------------------------------------------
# the peak bytes held (``StepCounter.peak``, the dry run's bytes per device)
# ---------------------------------------------------------------------------
def test_step_counter_peak_frees_and_allocates_again():
    n = 1024
    x = meta(n)
    with StepCounter(track=(x,)) as c:
        a = x * 2                  # 4n bytes, freed before the next
        del a
        b = torch.cat([x, x])      # 8n bytes
        del b
        y = x + 1                  # 4n bytes, kept
    assert c.inputs == 4 * n
    assert c.peak == 4 * n + 8 * n       # x and the cat, never a and b
    assert c.live == 4 * n + 4 * n and y.shape == (n,)


@pytest.mark.parametrize("L", [1, 2, 4])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "checkpoint"])
def test_step_counter_peak_of_layers(L, remat):
    """L layers h -> sum_j sin(h_i w_j), forward and backward, each under
    ``checkpoint`` or not. A layer's product (n x n, N bytes) is saved for
    sin's backward; the peak is at the last layer's backward, where that
    product, cos of it and the incoming gradient times it are held (3N).
    Without checkpoint the forward has saved every layer's product, (L + 2)
    N in all, and ``h`` holds the last output (v bytes). With it only the
    recomputed product is held, 3N, beside the layers' outputs, each
    saved as the next checkpoint's input or held by ``h`` (L v). Add x and
    w (2 v) and the loss and its gradient (4 bytes each). ``MemTracker``
    reads the same."""
    from torch.distributed._tools.mem_tracker import MemTracker
    n = 256
    N, v = 4 * n * n, 4 * n

    def run(x, w):
        layer = lambda h: (h.unsqueeze(1) * w).sin().sum(1)
        h = x
        for _ in range(L):
            h = (checkpoint(layer, h, use_reentrant=False) if remat
                 else layer(h))
        h.sum().backward()

    x, w = meta(n).requires_grad_(True), meta(1, n)
    with StepCounter(track=(x, w)) as c:
        run(x, w)
    held = 3 * N + L * v if remat else (L + 2) * N + v
    assert c.inputs == 2 * v
    assert c.peak == 2 * v + held + 8
    x = meta(n).requires_grad_(True)
    tracker = MemTracker()
    tracker.track_external(x, w)
    with tracker:
        run(x, w)
    [snap] = tracker.get_tracker_snapshot("peak").values()
    assert snap["Total"] == c.peak


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "checkpoint"])
def test_step_counter_breaks_the_peak_down(remat):
    """``peak_held`` is the peak by what made each storage: it adds up to
    the peak; at ``test_step_counter_peak_of_layers``'s peak (the last
    layer's backward) the inputs hold their 2v, the backward cos of the
    layer's product and the gradient times it (2N; with checkpoint the
    recomputed product too, 3N), and the forward the rest: without
    checkpoint every layer's saved product and the last output, with it
    the layers' outputs, and the loss and the gradient ``backward`` starts
    from (4 bytes each). An op run without grad mode is
    ``"no-grad"``."""
    n, L = 256, 3
    N, v = 4 * n * n, 4 * n
    x, w = meta(n).requires_grad_(True), meta(1, n)
    with StepCounter(track=(x, w)) as c:
        layer = lambda h: (h.unsqueeze(1) * w).sin().sum(1)
        h = x
        for _ in range(L):
            h = (checkpoint(layer, h, use_reentrant=False) if remat
                 else layer(h))
        h.sum().backward()
        with torch.no_grad():
            y = x * 2
    held = {k: v for k, v in c.peak_held.items() if v}
    assert sum(held.values()) == c.peak
    assert held["inputs"] == 2 * v
    backward = sum(b for k, b in held.items() if k.startswith("backward"))
    forward = sum(b for k, b in held.items() if k.startswith("forward"))
    assert backward == (3 if remat else 2) * N
    assert forward == (L * v if remat else L * N + v) + 8
    assert c.held["no-grad mul"] == v and y.shape == (n,)


# reduced cells built by ``build_cell`` on the meta device, each step run
# under StepCounter and, built again, under MemTracker (torch's own tracker
# of the bytes held, by storage), in fake worlds of 1 and 4 ranks
PEAK_CELLS = [((1, 1), "smollm-135m", "train", 2, "none"),
              ((1, 1), "smollm-135m", "train", 2, "block"),
              ((1, 1), "smollm-135m", "prefill", 1, None),
              ((1, 1), "smollm-135m", "decode", 1, None),
              ((1, 1), "mamba2-1.3b", "train", 1, "block"),
              ((1, 1), "zamba2-2.7b", "decode", 1, None),
              ((1, 1), "qwen2-moe-a2.7b", "train", 1, None),
              ((1, 1), "qwen2-moe-a2.7b", "decode", 1, None),
              ((2, 2), "smollm-135m", "train", 2, "block"),
              ((2, 2), "smollm-135m", "decode", 1, None),
              ((2, 2), "qwen2-moe-a2.7b", "decode", 1, None)]
PEAK_IDS = ["{}x{}-{}-{}-ga{}-{}".format(*mesh, arch, kind, k, remat)
            for mesh, arch, kind, k, remat in PEAK_CELLS]

PEAKS = """
import dataclasses, json, math, sys
import torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.device_mesh import init_device_mesh
from torch.utils._pytree import tree_flatten
from repro_torch.configs import ShapeCell, get_config
from repro_torch.launch.build import build_cell
from repro_torch.launch.analysis import StepCounter
from repro_torch.launch.mesh import fake_world

def reduced(arch):
    cfg = get_config(arch)
    red = cfg.reduced()
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(cfg)
            if f.name != "name" and getattr(red, f.name) != getattr(cfg, f.name)}

out = []
for mesh_shape, arch, kind, k, remat in json.loads(sys.argv[1]):
    with fake_world(math.prod(mesh_shape)):
        mesh = init_device_mesh("cpu", tuple(mesh_shape),
                                mesh_dim_names=("data", "model"))
        make = lambda: build_cell(arch, ShapeCell(kind, kind, 4, 128), mesh,
                                  grad_accum=k, remat=remat,
                                  extra_cfg=reduced(arch))
        cell = make()
        with StepCounter(track=cell.args) as counter:
            cell.step(*cell.args)
        cell = make()
        tracker = MemTracker()
        tracker.track_external(*(t for t in tree_flatten(cell.args)[0]
                                 if isinstance(t, torch.Tensor)))
        with tracker:
            cell.step(*cell.args)
        [snap] = tracker.get_tracker_snapshot("peak").values()
        out.append([counter.peak, counter.inputs, snap["Total"]])
with open("peaks.json", "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def cell_peaks(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("peaks")
    subprocess.run([sys.executable, "-c", PEAKS, json.dumps(PEAK_CELLS)],
                   cwd=cwd, check=True, timeout=180, capture_output=True,
                   env={**os.environ,
                        "PYTHONPATH": os.path.join(REPO, "src")})
    with open(cwd / "peaks.json") as f:
        return json.load(f)


@pytest.mark.parametrize("i", range(len(PEAK_CELLS)), ids=PEAK_IDS)
def test_step_counter_peak_matches_memtracker(cell_peaks, i):
    """The dry run's bytes per device equal MemTracker's peak exactly."""
    peak, inputs, tracked = cell_peaks[i]
    assert peak == tracked
    assert peak > inputs > 0


# ---------------------------------------------------------------------------
# product FLOPs of each family's loss, forward and backward, against the
# reference's jaxpr
# ---------------------------------------------------------------------------
FAMILIES = {"dense": "smollm-135m", "moe": "qwen2-moe-a2.7b",
            "ssm": "mamba2-1.3b", "hybrid": "zamba2-2.7b",
            "encdec": "whisper-tiny", "vlm": "llava-next-34b"}
B, T = 2, 64


def jaxpr_dot_flops(jaxpr) -> float:
    """Products of a jaxpr at 2*m*n*k*batch (the reference's
    ``_dot_flops``), scan bodies times their length, the larger branch of
    a cond."""
    total = 0.0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            total += _dot_flops(eqn)
            continue
        subs = []
        for value in eqn.params.values():
            for v in (value if isinstance(value, (tuple, list)) else
                      (value,)):
                v = getattr(v, "jaxpr", v)          # a ClosedJaxpr's
                if hasattr(v, "eqns"):
                    subs.append(v)
        if not subs:
            continue
        inner = [jaxpr_dot_flops(s) for s in subs]
        if eqn.primitive.name == "cond":
            total += max(inner)
        else:
            total += eqn.params.get("length", 1) * sum(inner)
    return total


def ref_product_flops(arch: str) -> float:
    cfg = ref_get_config(arch).reduced()
    model = ref_build_model(cfg)
    params = jax.eval_shape(model.init, jax.random.key(0))
    batch = {k: jax.ShapeDtypeStruct(tuple(v.shape), {
        torch.int32: jnp.int32, torch.float32: jnp.float32}[v.dtype])
        for k, v in cell_inputs(get_config(arch).reduced(), "train", B,
                                T).items()}
    jaxpr = jax.make_jaxpr(jax.value_and_grad(model.loss_fn))(params, batch)
    return jaxpr_dot_flops(jaxpr.jaxpr)


def port_product_flops(arch: str) -> float:
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="meta")
    with FlopCounterMode(display=False) as counter:
        value_and_grad(model.loss_fn, param_shapes(cfg),
                       cell_inputs(cfg, "train", B, T))
    return counter.get_total_flops()


# the SSD chunked scan's three-operand einsums (``repro/models/mamba2.py:
# ssd_chunked``, ``repro_torch/kernels/ref.py:ssd_scan_ref``: the same
# formulas): jnp.einsum contracts three operands in opt_einsum's order,
# torch.einsum in its own, so their products differ in shape and count
SSD_EINSUMS = ("bcqk,bchqk,bckhp->bcqhp",        # y_intra: CB, L, u
               "bckn,bckh,bckhp->bchnp",         # chunk states: B, decay, u
               "bcqn,bchnp,bcqh->bcqhp")         # y_inter: C, h_in, exp(cum)


def ssd_einsum_shapes(cfg):
    nc, Q, H, N, P = (T // cfg.ssm_chunk, cfg.ssm_chunk, cfg.ssm_heads,
                      cfg.ssm_state, cfg.ssm_head_dim)
    return (((B, nc, Q, Q), (B, nc, H, Q, Q), (B, nc, Q, H, P)),
            ((B, nc, Q, N), (B, nc, Q, H), (B, nc, Q, H, P)),
            ((B, nc, Q, N), (B, nc, H, N, P), (B, nc, Q, H)))


def ssd_einsum_flops(arch: str) -> tuple[float, float]:
    """(reference, port) product FLOPs of one SSM layer's three einsums,
    forward and the gradients of all three operands."""
    ref = port = 0.0
    for eq, shapes in zip(SSD_EINSUMS,
                          ssd_einsum_shapes(get_config(arch).reduced())):
        f = lambda *xs: jnp.einsum(eq, *xs).sum()
        jaxpr = jax.make_jaxpr(jax.value_and_grad(f, argnums=(0, 1, 2)))(
            *(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes))
        ref += jaxpr_dot_flops(jaxpr.jaxpr)
        xs = [torch.empty(s, device="meta", requires_grad=True)
              for s in shapes]
        with FlopCounterMode(display=False) as counter:
            torch.autograd.grad(torch.einsum(eq, *xs).sum(), xs)
        port += counter.get_total_flops()
    return ref, port


@pytest.mark.parametrize("family", list(FAMILIES))
def test_product_flops_match_the_jaxpr(family):
    """Equal, but for the SSD einsums' contraction order in the ssm and
    hybrid families (every layer is an SSM layer), held apart."""
    arch = FAMILIES[family]
    want, got = ref_product_flops(arch), port_product_flops(arch)
    if family in ("ssm", "hybrid"):
        ref_e, port_e = ssd_einsum_flops(arch)
        assert ref_e != port_e
        layers = get_config(arch).reduced().n_layers
        want -= layers * ref_e
        got -= layers * port_e
    assert got == want
