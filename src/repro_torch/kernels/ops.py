"""The seam the model calls (counterpart of ``repro/kernels/ops.py``).

The device of the tensors decides: a CPU tensor goes to the plain PyTorch
version, a CUDA tensor to the hand-written kernel, which raises when it
cannot build or launch. There is no fallback and no backend switch.
"""
from __future__ import annotations

import torch

from . import ref
from .decode_attention import decode_attention as _decode_cuda


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, lengths)
    return _decode_cuda(q, k, v, lengths)
