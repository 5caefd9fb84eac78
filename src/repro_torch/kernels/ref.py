"""Plain PyTorch versions of the hand-written kernels. The CPU runs these;
``chip_smoke.py`` holds each kernel against them on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q: (B, T, Hq, hd); k/v: (B, S, Hkv, hd); GQA by head broadcast.
    Scores in fp32, the causal mask ``qpos >= kpos`` aligned at 0 (also
    when T != S), masked scores ``NEG_INF``; returns (B, T, Hq, hd) in q's
    dtype. Autograd through it is the plain backward."""
    B, T, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    g = Hq // Hkv
    qg = q.reshape(B, T, Hkv, g, hd).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) / math.sqrt(hd)
    if causal:
        mask = torch.arange(T, device=q.device)[:, None] >= \
            torch.arange(S, device=q.device)[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    return out.reshape(B, T, Hq, hd).to(q.dtype)


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
