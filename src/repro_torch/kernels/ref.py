"""Plain PyTorch versions of the hand-written kernels. The CPU runs these;
``chip_smoke.py`` holds each kernel against them on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Single-token GQA decode. q: (B, Hq, hd); k/v: (B, S, Hkv, hd);
    lengths: (B,) valid KV prefix, where ``length > S`` means S.
    Returns (B, Hq, hd) in q's dtype.

    A row with ``length == 0`` gives zeros, as the Pallas kernel does
    (``repro.kernels.ref.decode_attention_ref`` gives the mean of V there;
    served calls always have ``length >= 1``)."""
    B, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, hd).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] < lengths[:, None]                     # (B, S)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    out = torch.where((lengths > 0)[:, None, None, None], out, 0.0)
    return out.reshape(B, Hq, hd).to(q.dtype)
