"""The seam the model calls (counterpart of ``repro/kernels/ops.py``).

The device of the tensors decides: a CPU tensor goes to the plain PyTorch
version, a CUDA tensor to the hand-written kernel, which raises when it
cannot build or launch. There is no fallback and no backend switch.
"""
from __future__ import annotations

import torch

from . import ref
from .decode_attention import decode_attention as _decode_cuda
from .flash_attention import flash_attention as _flash_cuda
from .ssd_scan import ssd_scan as _ssd_cuda


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """On the CPU the reference's XLA route: ``chunked_attention`` from
    1024 query positions on (no S^2 scores), the plain version below."""
    if q.device.type == "cpu":
        if q.shape[1] >= 1024:
            from repro_torch.models.attention import chunked_attention
            return chunked_attention(q, k, v, causal=causal)
        return ref.flash_attention_ref(q, k, v, causal=causal)
    return _flash_cuda(q, k, v, causal=causal)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, lengths)
    return _decode_cuda(q, k, v, lengths)


def ssd_scan(u: torch.Tensor, loga: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int, h0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """On the CPU the chunked scan the reference's model runs
    (``ssd_chunked``), written on (u, loga)."""
    if u.device.type == "cpu":
        return ref.ssd_scan_ref(u, loga, Bm, Cm, chunk=chunk, h0=h0)
    return _ssd_cuda(u, loga, Bm, Cm, chunk=chunk, h0=h0)
