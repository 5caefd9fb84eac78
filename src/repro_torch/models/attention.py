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
                      blk: int = 512, q_offset: int = 0) -> torch.Tensor:
    """Flash-style attention in plain PyTorch: a loop over KV blocks with
    online softmax, so the (T, S) score tensor never exists whole.
    q: (B,T,Hq,hd); k/v: (B,S,Hkv,hd); ``q_offset``: the causal mask's
    position of q[0], as ``gqa_scores_attention``'s."""
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
    mask = _kv_mask(T, S, causal, q_offset, kv_len, q.device)
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
                    q_rows: tuple[int, int] | None = None,
                    kv_split=None,
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

    ``q_rows=(a, b)`` (T > 1; a rank's rows under the tensor-parallel
    "q_seq" plan): the output is rows [a, b) alone. Q, its RoPE positions
    and the attention run on those rows; K/V of causal self-attention on
    rows [0, b) without a cache, on every row where the cache is written
    or the attention is not causal (the encoder's); the causal mask puts
    query row i at position a + i (flash's ``q_offset``). Under
    cross-attention the rows attend to every encoder position.

    ``kv_split`` (a ``tensor_parallel.KVSplit``; the tensor-parallel
    "kv_seq" layout): ``kv_cache`` is this rank's block of the cache's
    positions, ``[start, start + rows)`` of ``cache_len``. A decode step
    writes the clamped row ``idx.clamp(0, cache_len - 1)`` where the rank
    owns it (elsewhere the block's row is written back as it was, so no
    host synchronisation: the step can be captured), attends over the
    block with lengths ``(idx + 1 - start).clamp(0, rows)`` through
    ``decode_attention(..., return_lse=True)`` and merges the ranks'
    partials (``kv_split.merge``). A prefill, which starts at index 0 (the
    engine's contract; a nonzero index raises ``ValueError``), writes the
    rows it owns and attends over the fresh K/V, rows [0, b).
    """
    B, T, d = x.shape
    a, b = (0, T) if q_rows is None else q_rows
    # the head counts of the weights given: under tensor parallelism a
    # rank's own heads (``cfg.hd`` is the same on every rank)
    hd = cfg.hd
    hq = p.wq.shape[-1] // hd
    cd = cfg.compute_dtype
    xq = x if q_rows is None else x[:, a:b]
    q = (xq @ p.wq.to(cd)).reshape(B, b - a, hq, hd)
    if cross_kv is not None:      # ``p.wk``/``p.wv`` are not read
        out = gqa_scores_attention(q, *cross_kv, causal=False)
        return out.reshape(B, b - a, hq * hd) @ p.wo.to(cd), None
    hkv = p.wk.shape[-1] // hd
    # K/V rows: [0, b) where causal attention without a cache reads no more
    xkv = x if kv_cache is not None or q_rows is None or not causal \
        else x[:, :b]
    tk = xkv.shape[1]
    k = (xkv @ p.wk.to(cd)).reshape(B, tk, hkv, hd)
    v = (xkv @ p.wv.to(cd)).reshape(B, tk, hkv, hd)

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
        q = apply_rope(q, sin[:, a:b], cos[:, a:b])
        k = apply_rope(k, sin[:, :tk], cos[:, :tk])

    new_cache = None
    if kv_split is not None:
        out = _split_cache_attention(q, k, v, kv_cache, idx, kv_split, a,
                                     decode_attention)
        new_cache = kv_cache
    elif kv_cache is None:
        if causal and (q_rows is not None or q.shape[1] == k.shape[1]):
            # the training hot path: the flash kernel on the card
            out = flash_attention(q, k, v, causal=True, q_offset=a)
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
            out = chunked_attention(q, ck, cv, causal=True, kv_len=idx + T,
                                    q_offset=a)
        else:
            # prefill-into-cache (idx == 0 per slot-allocation contract)
            out = gqa_scores_attention(q, ck, cv, causal=True, q_offset=a,
                                       kv_len=idx + T)
    out = out.reshape(B, b - a, hq * hd) @ p.wo.to(cd)
    return out, new_cache


def _split_cache_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_cache: tuple[torch.Tensor, torch.Tensor],
                           idx: torch.Tensor, split, a: int,
                           decode_attention: Callable) -> torch.Tensor:
    """``attention_block``'s cache write and attention where the cache is
    this rank's block of positions (``split``, a ``KVSplit``): q (B, Tq,
    Hq, hd) the rows from ``a`` on, k/v (B, T, Hkv, hd) the new positions'
    from index ``idx`` (B,). Returns the attention (B, Tq, Hq, hd)."""
    ck, cv = kv_cache                       # (B, rows, Hkv, hd)
    B, T = k.shape[:2]
    n, start = split.rows, split.start
    if T == 1:
        row = idx.clamp(0, split.cache_len - 1).long() - start
        own = ((row >= 0) & (row < n))[:, None, None]
        row = row.clamp(0, n - 1)
        batch = torch.arange(B, device=k.device)
        ck[batch, row] = torch.where(own, k[:, 0], ck[batch, row])
        cv[batch, row] = torch.where(own, v[:, 0], cv[batch, row])
        lengths = (idx + 1 - start).clamp(0, n).to(torch.int32)
        out, lse = decode_attention(q[:, 0], ck, cv, lengths,
                                    return_lse=True)
        return split.merge(out, lse).to(q.dtype)[:, None]
    if idx.device.type != "meta" and bool((idx != 0).any()):
        raise ValueError("a prefill into a cache split over its positions "
                         "starts at index 0")
    lo, hi = min(max(start, 0), T), min(start + n, T)
    if hi > lo:
        ck[:, lo - start:hi - start] = k[:, lo:hi]
        cv[:, lo - start:hi - start] = v[:, lo:hi]
    b = a + q.shape[1]
    if T >= 1024:
        return chunked_attention(q, k[:, :b], v[:, :b], causal=True,
                                 q_offset=a)
    return gqa_scores_attention(q, k[:, :b], v[:, :b], causal=True,
                                q_offset=a)
