"""Multi-node dry run (counterpart of ``repro/launch/dryrun.py``): build
every (architecture x input-shape x mesh) cell for a world of 256 or 512
H100s, count rank 0's step on the ``meta`` device, check that its memory
fits the card, and write its roofline terms.

The world is a ``"fake"`` process group (``mesh.fake_world``): this
process is rank 0 of 256 or 512 (or ``--rank``), and every collective
returns at once. No environment is set at import and no process group is
started: ``run_cell`` starts the world and ends it.

For each cell it records
  * the semantic FLOPs and bytes of the unsharded step at the global shape
    (the reference's jaxpr count), on the meta device;
  * the counted rank's sharded step (under ``"rank0"``, whichever rank
    ``"rank"`` says): its FLOPs and bytes, its collectives by kind,
    and its peak bytes (``analysis.StepCounter``: the params' and optimizer
    state's shards, the leaves a layer gathers, activations and
    temporaries), broken down by what made them (``peak_held_by``);
  * the roofline terms, the kernel-adjusted memory term and ``fits_h100``;
  * a serve cell's ``cache_bytes``: the whole cache's and the counted
    rank's block of it.

Every family computes tensor-parallel along "model" (the MoE family where
expert-parallel; ``distributed/tensor_parallel.py``); the record's
``"tp"`` is the plan (the attention's mode, "local",
"kv_replicated", "q_seq", "kv_seq" or "gathered", and its local heads,
None without attention, the counted rank's index along "model" and its
query rows, with
``q_seq_heaviest_over_mean`` under "q_seq", the MLP (the MoE's shared
experts) local, gathered or None, the vocab local or whole, the residuals
sequence-parallel or not, for the ssm and hybrid families the mamba2
block's mode, "local" or "gathered", its SSM heads a rank and
``ssm_layout``, "by_rank" (``in_proj``, ``conv_w`` and ``conv_b`` stored
as each rank's block, B and C all-gathered along "model") or "whole"
(gathered whole along "model"), and for the
MoE family the expert-parallel group ``ep``, the experts a rank
``ep_experts`` and a rank's ``capacity``; the EP all-to-alls count as
``coll_by_kind["all-to-all"]``; under "kv_seq" the rank's ``kv_rows``
and the cache's ``cache_len``, the decode partials' merge counting as an
all-gather; for the enc-dec family's train and prefill steps the
encoder's plan under ``"encoder"``), None for a grouped-dispatch MoE,
whose step gathers each leaf whole, so the FLOPs the cards execute (the
counted rank's times the chips, ``hlo_flops``) repeat its work along
"model"; ``useful_fraction`` shows it, and the semantic count is kept
beside it.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --arch minitron-4b --shape train_4k \
      --rank 15                                        # the last "model" rank
  python -m repro_torch.launch.dryrun --all            # all 40 cells
  python -m repro_torch.launch.dryrun --all --multi-pod
Each cell writes experiments/dryrun_torch/<arch>__<shape>__<mesh>.json
(``__rank<r>`` before ``.json`` for a rank other than 0).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from dataclasses import replace

from repro_torch.configs import ASSIGNED, SHAPES, cell_runnable, get_config

OUT_DIR = "experiments/dryrun_torch"


def peak_and_cost(step, args) -> dict:
    """Runs ``step(*args)`` once under ``StepCounter``: rank 0's FLOPs and
    bytes, its collective bytes by kind (``coll:<kind>``) and its peak
    bytes (``peak:Total``; ``peak:Inputs``, the args' tensors, held from
    the start; ``held:<what>``, the peak by what made it), as one flat
    dict."""
    from .analysis import StepCounter
    from .roofline import collective_bytes
    with StepCounter(track=args) as counter:
        step(*args)
    out = {"flops": counter.flops, "bytes": counter.bytes,
           "peak:Total": float(counter.peak),
           "peak:Inputs": float(counter.inputs)}
    out.update({f"held:{k}": float(v) for k, v in counter.peak_held.items()
                if v})
    for kind, n in collective_bytes(counter.collectives)[1].items():
        out[f"coll:{kind}"] = float(n)
    return out


def _counts(cell) -> dict:
    """The semantic (unsharded, global) count and rank 0's, flat. On a
    mesh of one rank the sharded step is the whole step, so its count is
    the semantic one too."""
    from .analysis import step_cost
    out = peak_and_cost(cell.step, cell.args)
    if cell.chips == 1:
        out["sem_flops"], out["sem_bytes"] = out["flops"], out["bytes"]
    else:
        fn, args = cell.semantic()
        out["sem_flops"], out["sem_bytes"] = step_cost(fn, *args)
    return out


def cell_counts(cell, shape, build) -> dict:
    """The flat counts of ``cell``, built as ``build(shape, grad_accum)``.

    A train step of k > 3 microbatches is counted from the same cell at 2
    and 3 microbatches of its microbatch size, extended to k: eager
    PyTorch runs each microbatch's ops again at the same shapes, so every
    count (FLOPs, bytes, collectives, the peak, which grows by the inputs'
    rows alone) is affine in k, while the meta device spends the same time
    on every microbatch (``tests/test_torch_launch.py`` holds the
    extension to the count at k = 4)."""
    grad_accum = cell.grad_accum
    if cell.kind != "train" or grad_accum <= 3:
        return _counts(cell)
    micro = shape.global_batch // grad_accum
    two, three = (_counts(build(replace(shape, global_batch=m * micro), m))
                  for m in (2, 3))
    return {key: two.get(key, 0.0) + (grad_accum - 2) * (
        three.get(key, 0.0) - two.get(key, 0.0))
        for key in two.keys() | three.keys()}


def count_cell(arch: str, shape_id, mesh, *, mesh_name: str,
               grad_accum: int = 1, remat: str | None = None,
               extra_cfg: dict | None = None, tag: str = "") -> dict:
    """The dry run of one cell on any mesh of the current process group,
    counted on this process's rank (``shape_id`` may be a ``ShapeCell`` of
    its own); returns the JSON record."""
    import torch.distributed as dist

    from .build import build_cell, resolve_shape, shared_memory_kernel_bytes
    from .roofline import (HBM_BW, HBM_BYTES, PEAK_FLOPS, Roofline,
                           model_flops_estimate)
    chips = mesh.size()
    shape = resolve_shape(shape_id)
    build = lambda s, k: build_cell(arch, s, mesh, grad_accum=k,
                                    remat=remat, extra_cfg=extra_cfg)
    t0 = time.time()
    cell = build(shape, grad_accum)
    rank_cache = cell.rank_cache_bytes()
    c = cell_counts(cell, shape, build)
    t_count = time.time() - t0
    by_kind = {k[5:]: v * chips for k, v in c.items()
               if k.startswith("coll:")}
    peak = {k[5:]: v for k, v in c.items() if k.startswith("peak:")}
    held = dict(sorted(((k[5:], v) for k, v in c.items()
                        if k.startswith("held:")), key=lambda kv: -kv[1]))
    coll_rank = sum(v for k, v in c.items() if k.startswith("coll:"))
    bytes_per_device = peak["Total"]

    r = Roofline(
        arch=arch, shape=cell.shape, mesh=mesh_name, chips=chips,
        hlo_flops=c["flops"] * chips,
        hlo_bytes=c["bytes"] * chips,
        coll_bytes=coll_rank * chips,
        coll_by_kind=by_kind,
        model_flops=model_flops_estimate(
            cell.n_active, cell.tokens_processed,
            "train" if cell.kind == "train" else "inference"),
        bytes_per_device=bytes_per_device,
        min_bytes=cell.min_bytes,
    ).finalize()

    result = r.to_json()
    # kernel-adjusted memory term: the flash/SSD kernels keep these bytes
    # in shared memory on the card (the meta device's plain route writes
    # them out); rank 0's rows, every rank alike
    kadj = shared_memory_kernel_bytes(cell.cfg, cell.kind, cell.rows,
                                      shape.seq_len) * chips
    mem_kernel_s = max(r.hlo_bytes - kadj, cell.min_bytes) / (chips * HBM_BW)
    bound_kernel = max(r.compute_s, mem_kernel_s, r.collective_s)
    ideal = max(r.model_flops / (chips * PEAK_FLOPS),
                cell.min_bytes / (chips * HBM_BW))
    result.update(
        status="ok", tag=tag,
        shared_memory_kernel_bytes=kadj,
        memory_kernel_s=mem_kernel_s,
        bound_kernel_s=bound_kernel,
        roofline_fraction_kernel=(ideal / bound_kernel) if bound_kernel else 0,
        min_bytes=cell.min_bytes,
        semantic={"flops": c["sem_flops"], "bytes_proxy": c["sem_bytes"]},
        rank0={"flops": c["flops"], "bytes": c["bytes"],
               "collective_bytes": coll_rank, "rows": cell.rows},
        peak_by_kind=peak, peak_held_by=held,
        t_count_s=round(t_count, 1),
        grad_accum=grad_accum, remat=remat or cell.cfg.remat,
        hbm_bytes_per_device=HBM_BYTES,
        fits_h100=bool(bytes_per_device <= HBM_BYTES),
        tp=cell.tp, rank=dist.get_rank(),
    )
    if cell.kind != "train":
        result["cache_bytes"] = {"whole": cell.cache_bytes,
                                 "rank": rank_cache}
    print(f"[dryrun] {arch} x {cell.shape} x {mesh_name}: "
          f"{bytes_per_device / 1e9:.2f} GB/device "
          f"(fits_h100={result['fits_h100']}); dominant={r.dominant}; "
          f"bound={r.bound_s * 1e3:.2f} ms; "
          f"useful={r.useful_fraction:.3f}; frac={r.roofline_fraction:.3f}; "
          f"kernel-adj bound={bound_kernel * 1e3:.2f} ms "
          f"frac={result['roofline_fraction_kernel']:.3f} "
          f"({t_count:.1f} s)", flush=True)
    print(f"  tp: {json.dumps(cell.tp)}", flush=True)
    print("  held at the peak (GB): " + ", ".join(
        f"{k} {v / 1e9:.2f}" for k, v in list(held.items())[:8]), flush=True)
    print(f"  semantic: flops={c['sem_flops']:.3e} "
          f"bytes={c['sem_bytes']:.3e}; rank {result['rank']}: "
          f"flops={c['flops']:.3e} "
          f"bytes={c['bytes']:.3e} collective={coll_rank:.3e}B", flush=True)
    return result


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_cell(arch: str, shape_id: str, *, multi_pod: bool,
             grad_accum: int = 1, remat: str | None = None,
             tag: str = "", rank: int = 0) -> dict:
    """``count_cell`` on a production mesh, in a fake world of 256 (or
    512) ranks, counted on ``rank``."""
    from .mesh import fake_world, make_production_mesh
    with fake_world(512 if multi_pod else 256, rank=rank):
        mesh = make_production_mesh(multi_pod=multi_pod)
        return count_cell(arch, shape_id, mesh,
                          mesh_name=mesh_name(multi_pod),
                          grad_accum=grad_accum, remat=remat, tag=tag)


def _outfile(arch, shape_id, multi_pod, tag="", rank=0):
    suffix = (f"__rank{rank}" if rank else "") + (f"__{tag}" if tag else "")
    safe = arch.replace("/", "_")
    return f"{OUT_DIR}/{safe}__{shape_id}__{mesh_name(multi_pod)}{suffix}.json"


def _skip(out, arch, shape_id, multi_pod, why) -> None:
    with open(out, "w") as f:
        json.dump({"arch": arch, "shape": shape_id,
                   "mesh": mesh_name(multi_pod), "status": "skipped",
                   "reason": why}, f, indent=1)
    print(f"[dryrun] SKIP {arch} x {shape_id}: {why}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the fake world whose step is counted")
    args = ap.parse_args(argv)
    os.makedirs(OUT_DIR, exist_ok=True)

    if args.all:
        failures = []
        for arch in ASSIGNED:
            cfg = get_config(arch)
            for shape_id, shape in SHAPES.items():
                out = _outfile(arch, shape_id, args.multi_pod, args.tag)
                ok, why = cell_runnable(cfg, shape)
                if not ok:
                    _skip(out, arch, shape_id, args.multi_pod, why)
                    continue
                if os.path.exists(out) and not args.force:
                    print(f"[dryrun] cached {out}")
                    continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape_id]
                if args.multi_pod:
                    cmd.append("--multi-pod")
                if args.tag:
                    cmd += ["--tag", args.tag]
                rc = subprocess.run(cmd).returncode
                if rc != 0:
                    failures.append((arch, shape_id))
        if failures:
            print(f"[dryrun] FAILURES: {failures}")
            return 1
        print("[dryrun] all cells counted")
        return 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    out = _outfile(args.arch, args.shape, args.multi_pod, args.tag,
                   args.rank)
    ok, why = cell_runnable(get_config(args.arch), SHAPES[args.shape])
    if not ok:
        _skip(out, args.arch, args.shape, args.multi_pod, why)
        return 0
    try:
        result = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                          grad_accum=args.grad_accum, remat=args.remat,
                          tag=args.tag, rank=args.rank)
    except Exception as e:
        traceback.print_exc()
        result = {"arch": args.arch, "shape": args.shape,
                  "mesh": mesh_name(args.multi_pod),
                  "status": "error", "error": f"{type(e).__name__}: {e}"}
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
        return 1
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
