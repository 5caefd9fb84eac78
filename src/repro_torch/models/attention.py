"""GQA attention for serving: decode and prefill into the slot cache.

Counterpart of ``repro/models/attention.py``. Shapes follow the
(B, T, H, hd) convention; KV caches are slot-contiguous (B, L_max, H_kv, hd)
with per-sequence valid lengths. Decode goes through the kernel seam
(``kernels/ops.py``); prefill into the cache is plain PyTorch, as it is XLA
in the reference. The branch without a cache (flash attention, training)
and cross-attention come with later slices.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import ops as kops

from .common import ArchConfig, apply_rope, dense_init, rope_angles

NEG_INF = -1e30


class AttnParams(NamedTuple):
    wq: torch.Tensor     # (d, Hq*hd)
    wk: torch.Tensor     # (d, Hkv*hd)
    wv: torch.Tensor     # (d, Hkv*hd)
    wo: torch.Tensor     # (Hq*hd, d)


def init_attn(generator: torch.Generator, cfg: ArchConfig,
              device=None) -> AttnParams:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    shapes = ((d, hq * hd), (d, hkv * hd), (d, hkv * hd), (hq * hd, d))
    return AttnParams(*(dense_init(generator, s, dtype=cfg.param_dtype,
                                   device=device) for s in shapes))


def _kv_mask(Tq: int, Tk: int, causal: bool, q_offset: int,
             kv_len: torch.Tensor | None, device) -> torch.Tensor | None:
    """Boolean mask broadcastable to (B, Hkv, g, Tq, Tk)."""
    mask = None
    kpos = torch.arange(Tk, device=device)
    if causal:
        qpos = torch.arange(Tq, device=device) + q_offset
        mask = (qpos[:, None] >= kpos[None, :])[None, None, None]
    if kv_len is not None:
        valid = (kpos[None, :] < kv_len[:, None])[:, None, None, None, :]
        mask = valid if mask is None else mask & valid
    return mask


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, kv_len: torch.Tensor | None = None,
                      blk: int = 512) -> torch.Tensor:
    """Flash-style attention in plain PyTorch: a loop over KV blocks with
    online softmax, so the (T, S) score tensor never exists whole.
    q: (B,T,Hq,hd); k/v: (B,S,Hkv,hd)."""
    B, T, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    g = Hq // Hkv
    blk = min(blk, S)
    if S % blk:
        blk = S  # fallback: single block
    qg = q.reshape(B, T, Hkv, g, hd).float() / math.sqrt(hd)
    m = torch.full((B, Hkv, g, T), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, g, T), device=q.device)
    acc = torch.zeros((B, Hkv, g, T, hd), device=q.device)
    mask = _kv_mask(T, S, causal, 0, kv_len, q.device)
    for start in range(0, S, blk):
        k_b = k[:, start:start + blk].float()
        v_b = v[:, start:start + blk].float()
        s = torch.einsum("bthgd,bkhd->bhgtk", qg, k_b)
        if mask is not None:
            s = torch.where(mask[..., start:start + blk], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgtk,bkhd->bhgtd", p, v_b)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.movedim(3, 1).reshape(B, T, Hq, hd).to(q.dtype)


def gqa_scores_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, q_offset: int = 0,
                         kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """Plain attention. q: (B, Tq, Hq, hd), k/v: (B, Tk, Hkv, hd).
    ``q_offset``: absolute position of q[0]; ``kv_len``: per-batch valid KV
    prefix length (B,) for slot caches."""
    B, Tq, Hq, hd = q.shape
    _, Tk, Hkv, _ = k.shape
    g = Hq // Hkv
    qg = q.reshape(B, Tq, Hkv, g, hd).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(hd)
    mask = _kv_mask(Tq, Tk, causal, q_offset, kv_len, q.device)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Tq, Hq, hd).to(q.dtype)


def attention_block(p: AttnParams, x: torch.Tensor, cfg: ArchConfig, *,
                    kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
                    cache_index: torch.Tensor | None = None,
                    cross_kv=None,
                    decode_attention: Callable = kops.decode_attention,
                    ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One attention sublayer (no residual/norm) over a slot cache:
      * decode (T == 1): write K/V at ``cache_index``, then attend with
        ``lengths = cache_index + 1`` through ``decode_attention``;
      * prefill into the cache (T > 1): write, then plain attention,
        chunked from 1024 tokens on.

    K/V are written into the cache tensors IN PLACE (the reference returns
    new buffers). As ``jax.lax.dynamic_update_slice`` does, the write
    position is clamped to ``max_len - T``, so an idle slot whose index ran
    past the end overwrites its last row. Returns (out, (K, V)).
    """
    if cross_kv is not None:
        raise NotImplementedError("cross-attention comes with the enc-dec "
                                  "slice of the port")
    if kv_cache is None:
        raise NotImplementedError("attention without a cache (flash "
                                  "attention) comes with the training slice "
                                  "of the port")
    B, T, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cd = cfg.compute_dtype
    q = (x @ p.wq.to(cd)).reshape(B, T, hq, hd)
    k = (x @ p.wk.to(cd)).reshape(B, T, hkv, hd)
    v = (x @ p.wv.to(cd)).reshape(B, T, hkv, hd)

    ck, cv = kv_cache                     # (B, L_max, Hkv, hd)
    S = ck.shape[1]
    idx = cache_index if cache_index is not None else torch.zeros(
        (B,), dtype=torch.int32, device=x.device)
    steps = torch.arange(T, device=x.device)
    sin, cos = rope_angles(idx[:, None] + steps[None, :], hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)

    rows = idx.clamp(0, S - T)[:, None] + steps[None, :]       # (B, T)
    batch = torch.arange(B, device=x.device)[:, None]
    ck[batch, rows] = k
    cv[batch, rows] = v
    if T == 1:
        # every valid cached position is <= the current one, so the
        # length mask alone is exact (no causal matrix needed)
        out = decode_attention(q[:, 0], ck, cv, idx + 1)[:, None]
    elif T >= 1024:
        out = chunked_attention(q, ck, cv, causal=True, kv_len=idx + T)
    else:
        # prefill-into-cache (idx == 0 per slot-allocation contract)
        out = gqa_scores_attention(q, ck, cv, causal=True, q_offset=0,
                                   kv_len=idx + T)
    out = out.reshape(B, T, hq * hd) @ p.wo.to(cd)
    return out, (ck, cv)
