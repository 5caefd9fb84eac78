"""Feed-forward layers: dense SwiGLU (``repro/models/ffn.py:21-37``).
Mixture-of-Experts comes with the MoE slice."""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import dense_init


class MLPParams(NamedTuple):
    w_gate: torch.Tensor   # (d, ff)
    w_up: torch.Tensor     # (d, ff)
    w_down: torch.Tensor   # (ff, d)


def init_mlp(generator: torch.Generator, d: int, ff: int, dtype,
             device=None, lead: tuple[int, ...] = ()) -> MLPParams:
    """``lead``: leading axes the matrices are stacked on (the layers)."""
    return MLPParams(*(dense_init(generator, (*lead, *s), in_axis=len(lead),
                                  dtype=dtype, device=device)
                       for s in ((d, ff), (d, ff), (ff, d))))


def swiglu(p: MLPParams, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    g = x @ p.w_gate.to(compute_dtype)
    u = x @ p.w_up.to(compute_dtype)
    return (F.silu(g) * u) @ p.w_down.to(compute_dtype)
