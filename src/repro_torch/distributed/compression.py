"""Int8 error-feedback gradient compression (counterpart of
``repro/distributed/compression.py``).

Quantizing gradients to int8 with one scale a tensor cuts the traffic of
the gradient all-reduce 4x against fp32; error feedback adds each step's
quantization error back into the next step's gradient, so the compression
is unbiased over time (Seide et al. 2014; Karimireddy et al. 2019).

Pass ``make_error_feedback_compressor()`` as the ``compress=`` hook of
``train_step.build_train_step`` or ``sharding.shard_train_step``. On a
sharded gradient (a ``DTensor``) the same code runs on the shards and the
scale is the max over the whole leaf: DTensor all-reduces the max over
the mesh, as the reference's scale is over the whole array.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import tree_leaves, tree_map


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    x32 = x.float()
    scale = torch.clamp_min(torch.max(torch.abs(x32)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def make_error_feedback_compressor():
    """(grads, residual) -> (compressed_grads, new_residual) hook; the
    residual is fp32 in the grads' structure (and placements)."""

    def compress(grads, residual):
        if residual is None:
            residual = tree_map(
                lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

        def one(g, r):
            corrected = g.float() + r
            deq = dequantize_int8(*quantize_int8(corrected))
            return deq.to(g.dtype), corrected - deq      # error feedback

        outs = [one(g, r) for g, r in zip(tree_leaves(grads),
                                          tree_leaves(residual))]
        new_g, new_r = iter(o[0] for o in outs), iter(o[1] for o in outs)
        return (tree_map(lambda _: next(new_g), grads),
                tree_map(lambda _: next(new_r), grads))

    return compress
