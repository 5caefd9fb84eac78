"""GPipe-style pipeline parallelism over a "stage" mesh axis (counterpart
of ``repro/distributed/pipeline.py``).

Stages hold contiguous layer slices; microbatches stream through the GPipe
schedule (n_micro + n_stages - 1 ticks); activations hop to the next
stage by point-to-point sends. Bubble fraction = (S-1)/(S-1+M).

Family-agnostic: it pipelines any ``stage_fn(stage_params, x) -> x`` over
stacked per-stage params, so tests hold it to the sequential model.
Forward only, as every caller of the reference uses it.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models.common import tree_map


def pipeline(stage_fn: Callable, mesh, *, axis: str = "stage",
             n_microbatches: int) -> Callable:
    """Returns f(stage_params, x) -> y running the GPipe schedule.

    stage_params: tree whose leaves lead with n_stages, each either a
    DTensor sharded over ``axis`` on dim 0 (the rank holds its stage's
    slice) or a whole tensor (the rank takes its stage's slice); x:
    (n_microbatches, mb, ...), the same on every rank. Every rank gets the
    (n_microbatches, mb, ...) output of the LAST stage.
    """
    dim = mesh.mesh_dim_names.index(axis)
    S = mesh.size(dim)
    M = n_microbatches

    def run(stage_params, x: torch.Tensor) -> torch.Tensor:
        group = mesh.get_group(dim)
        i = mesh.get_local_rank(dim)
        peer = lambda s: dist.get_global_rank(group, s)
        local = tree_map(lambda p: p.to_local()[0] if isinstance(p, DTensor)
                         else p[i], stage_params)
        outputs = torch.empty_like(x)
        inflight = None
        # stage s works at ticks s .. s + M - 1: stage 0 on microbatch t,
        # the others on what arrived last tick. A stage idle in a bubble
        # computes nothing, and the last stage sends nothing back round
        # the ring (the reference's wraparound value is unused).
        for t in range(M + S - 1):
            if i <= t < i + M:
                y = stage_fn(local, x[t] if i == 0 else inflight)
                if i == S - 1:
                    outputs[t - (S - 1)] = y
            ops = []
            if i < S - 1 and i <= t < i + M:
                ops.append(dist.P2POp(dist.isend, y.contiguous(), peer(i + 1),
                                      group))
            if i > 0 and i - 1 <= t < i - 1 + M:
                inflight = torch.empty_like(x[0])
                ops.append(dist.P2POp(dist.irecv, inflight, peer(i - 1),
                                      group))
            for req in dist.batch_isend_irecv(ops) if ops else ():
                req.wait()
        # only the last stage's outputs are real: every rank gets its bits
        dist.broadcast(outputs, src=peer(S - 1), group=group)
        return outputs

    return run


def split_stages(layer_params, n_stages: int):
    """Reshape stacked (L, ...) layer params into (n_stages, L/S, ...)."""
    def r(p):
        L = p.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers not divisible by {n_stages}")
        return p.reshape((n_stages, L // n_stages) + tuple(p.shape[1:]))
    return tree_map(r, layer_params)
