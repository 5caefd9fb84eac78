"""GQA attention: training and prefill without a cache, decode and
prefill into the slot cache.

Counterpart of ``repro/models/attention.py``. Shapes follow the
(B, T, H, hd) convention; KV caches are slot-contiguous (B, L_max, H_kv, hd)
with per-sequence valid lengths. Causal self-attention without a cache
(the training loss) and decode go through the kernel seam
(``kernels/ops.py``); prefill into the cache, non-causal self-attention
(the encoder's) and cross-attention are plain PyTorch, as they are XLA in
the reference.
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


def init_attn(generator: torch.Generator, cfg: ArchConfig, device=None,
              lead: tuple[int, ...] = ()) -> AttnParams:
    """``lead``: leading axes the matrices are stacked on (the layers),
    drawn one leading index at a time."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    shapes = ((d, hq * hd), (d, hkv * hd), (d, hkv * hd), (hq * hd, d))
    return AttnParams(*(dense_init(generator, (*lead, *s),
                                   dtype=cfg.param_dtype, device=device,
                                   n_lead=len(lead))
                        for s in shapes))


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
                    causal: bool = True,
                    positions: torch.Tensor | None = None,
                    kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
                    cache_index: torch.Tensor | None = None,
                    cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
                    use_rope: bool = True,
                    decode_attention: Callable = kops.decode_attention,
                    flash_attention: Callable = kops.flash_attention,
                    ) -> tuple[torch.Tensor,
                               tuple[torch.Tensor, torch.Tensor] | None]:
    """One attention sublayer (no residual/norm). Modes:
      * train/prefill (no cache): self-attention over x, causal with
        ``Tq == Tk`` through ``flash_attention``, else plain attention;
      * decode (T == 1): write K/V at ``cache_index``, then attend with
        ``lengths = cache_index + 1`` through ``decode_attention``;
      * prefill into the cache (T > 1): write, then plain attention,
        chunked from 1024 tokens on;
      * cross-attention (``cross_kv=(K, V)``, the encoder's, (B, S, Hkv,
        hd)): only q is projected, with no RoPE, and attends to every
        position through plain attention; no cache is touched.

    K/V are written into the cache tensors IN PLACE (the reference returns
    new buffers). As ``jax.lax.dynamic_update_slice`` does, the write
    position is clamped to ``max_len - T``, so an idle slot whose index ran
    past the end overwrites its last row. Returns (out, (K, V) or None).
    """
    B, T, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cd = cfg.compute_dtype
    q = (x @ p.wq.to(cd)).reshape(B, T, hq, hd)
    if cross_kv is not None:
        out = gqa_scores_attention(q, *cross_kv, causal=False)
        return out.reshape(B, T, hq * hd) @ p.wo.to(cd), None
    k = (x @ p.wk.to(cd)).reshape(B, T, hkv, hd)
    v = (x @ p.wv.to(cd)).reshape(B, T, hkv, hd)

    steps = torch.arange(T, device=x.device)
    idx = None
    if kv_cache is not None:
        idx = cache_index if cache_index is not None else torch.zeros(
            (B,), dtype=torch.int32, device=x.device)
    if positions is None:
        positions = steps[None, :] if idx is None else \
            idx[:, None] + steps[None, :]
    if use_rope:
        sin, cos = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)

    new_cache = None
    if kv_cache is None:
        if causal and q.shape[1] == k.shape[1]:
            # the training hot path: the flash kernel on the card
            out = flash_attention(q, k, v, causal=True)
        else:
            out = gqa_scores_attention(q, k, v, causal=causal)
    else:
        ck, cv = kv_cache                     # (B, L_max, Hkv, hd)
        S = ck.shape[1]
        rows = idx.clamp(0, S - T)[:, None] + steps[None, :]     # (B, T)
        batch = torch.arange(B, device=x.device)[:, None]
        ck[batch, rows] = k
        cv[batch, rows] = v
        new_cache = (ck, cv)
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
    return out, new_cache
