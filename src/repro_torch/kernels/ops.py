"""The seam the model calls (counterpart of ``repro/kernels/ops.py``).

The device of the tensors decides: a CPU tensor goes to the plain PyTorch
version, a CUDA tensor to the hand-written kernel, which raises when it
cannot build or launch. There is no fallback and no backend switch. A
``meta`` tensor, which holds no data and runs nothing, takes the CPU's
route: the dry run (``launch/dryrun.py``) counts a step's operations and
memory on it.
"""
from __future__ import annotations

import torch

from . import ref
from .decode_attention import decode_attention as _decode_cuda
from .flash_attention import flash_attention as _flash_cuda
from .ssd_scan import ssd_scan as _ssd_cuda

#: devices whose tensors take the plain versions
PLAIN = ("cpu", "meta")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """On the CPU the reference's XLA route: ``chunked_attention`` from
    1024 query positions on (no S^2 scores), the plain version below.
    ``q_offset``: query row i is position ``q_offset + i`` of the causal
    mask (``ref.check_q_offset`` says which offsets either route takes)."""
    if q.device.type in PLAIN:
        ref.check_q_offset(q.shape[1], k.shape[1], causal, q_offset)
        if q.shape[1] >= 1024:
            from repro_torch.models.attention import chunked_attention
            return chunked_attention(q, k, v, causal=causal,
                                     q_offset=q_offset)
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       q_offset=q_offset)
    return _flash_cuda(q, k, v, causal=causal, q_offset=q_offset)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, return_lse: bool = False):
    """``return_lse``: (the output in fp32, its (B, Hq) log-sum-exp), a
    partial that ``ref.merge_attention_partials`` merges."""
    if q.device.type in PLAIN:
        return ref.decode_attention_ref(q, k, v, lengths,
                                        return_lse=return_lse)
    return _decode_cuda(q, k, v, lengths, return_lse=return_lse)


def ssd_scan(u: torch.Tensor, loga: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int, h0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """On the CPU the chunked scan the reference's model runs
    (``ssd_chunked``), written on (u, loga)."""
    if u.device.type in PLAIN:
        return ref.ssd_scan_ref(u, loga, Bm, Cm, chunk=chunk, h0=h0)
    return _ssd_cuda(u, loga, Bm, Cm, chunk=chunk, h0=h0)
