"""Plain PyTorch versions of the hand-written kernels, and the sequential
SSD recurrence as the oracle of the chunked scan. The CPU runs these;
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


def decode_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, lengths: torch.Tensor,
                               splits: int, tile: int) -> torch.Tensor:
    """``decode_attention_ref`` computed as the split-KV kernel computes it:
    split s takes keys [s * tile, (s + 1) * tile) (``tile`` is the kernel's
    tiles per split times 64; ``splits * tile >= S``) and gives a partial
    (m, l, acc) of its valid keys; the partials are then merged in split
    order 0, 1, 2, ..., an empty split (l = 0) adding nothing, so that
    ``length == 0`` gives exact zeros. Shapes and result as
    ``decode_attention_ref``."""
    B, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    if splits * tile < S:
        raise ValueError(f"{splits} splits of {tile} keys do not cover S={S}")
    g = Hq // Hkv
    n = splits * tile
    pad = (0, 0, 0, 0, 0, n - S)                # keys past S, masked below
    kf = torch.nn.functional.pad(k.float(), pad)
    vf = torch.nn.functional.pad(v.float(), pad)
    qg = q.reshape(B, Hkv, g, hd).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, kf) / math.sqrt(hd)
    valid = torch.arange(n, device=q.device)[None, :] < \
        lengths.clamp(0, S)[:, None]                            # (B, n)
    valid = valid.reshape(B, 1, 1, splits, tile)
    scores = scores.reshape(B, Hkv, g, splits, tile)
    m = torch.where(valid, scores, NEG_INF).amax(dim=-1)        # (B,H,g,sp)
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgst,bsthd->bhgsd", p,
                       vf.reshape(B, splits, tile, Hkv, hd))
    m_all = torch.where(l > 0, m, NEG_INF).amax(dim=-1)        # (B, H, g)
    num = torch.zeros((B, Hkv, g, hd), dtype=torch.float32, device=q.device)
    den = torch.zeros((B, Hkv, g), dtype=torch.float32, device=q.device)
    for s in range(splits):                      # the kernel's merge order
        c = torch.where(l[..., s] > 0, torch.exp(m[..., s] - m_all), 0.0)
        num = num + acc[..., s, :] * c[..., None]
        den = den + l[..., s] * c
    out = torch.where(den[..., None] > 0,
                      num / den.clamp_min(1e-30)[..., None], 0.0)
    return out.reshape(B, Hq, hd).to(q.dtype)


def ssd_ref(u: torch.Tensor, loga: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, h0: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SEQUENTIAL SSD recurrence, one token at a time: the independent
    oracle of the chunked scan (``repro/kernels/ref.py:ssd_ref``).
    u: (B, T, H, P) dt-weighted inputs; loga: (B, T, H) log decay;
    Bm/Cm: (B, T, N); h0: (B, H, N, P) or None for zeros.
    Returns (y (B, T, H, P) in u's dtype, final state (B, H, N, P) fp32)."""
    Bsz, T, H, P = u.shape
    N = Bm.shape[-1]
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=u.device) \
        if h0 is None else h0.float()
    uf, lf, bf, cf = u.float(), loga.float(), Bm.float(), Cm.float()
    ys = []
    for t in range(T):
        a = torch.exp(lf[:, t])                                   # (B, H)
        h = h * a[..., None, None] + torch.einsum("bn,bhp->bhnp", bf[:, t],
                                                  uf[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], h))
    return torch.stack(ys, dim=1).to(u.dtype), h


def ssd_scan_ref(u: torch.Tensor, loga: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, *, chunk: int,
                 h0: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan of ``repro/models/mamba2.py:ssd_chunked``
    written on (u, loga), the plain version of the ``ssd_scan`` kernel:
    per chunk of ``chunk`` tokens the segsum decay matrix L, the intra-chunk
    product (C B^T * L) u, the chunk summaries B^T (u * decay to the end),
    the inter-chunk recurrence from h0 and C h * exp(cum). Shapes as
    ``ssd_ref``; ``T % chunk == 0``. Returns (y in u's dtype, final state
    fp32). Differentiable through autograd."""
    Bsz, T, H, P = u.shape
    N = Bm.shape[-1]
    if chunk <= 0 or T % chunk:
        raise ValueError(f"T={T} not divisible by chunk={chunk}")
    nc, Q = T // chunk, chunk
    ur = u.float().reshape(Bsz, nc, Q, H, P)
    la = loga.float().reshape(Bsz, nc, Q, H)
    Br = Bm.float().reshape(Bsz, nc, Q, N)
    Cr = Cm.float().reshape(Bsz, nc, Q, N)
    cum = torch.cumsum(la, dim=2)                              # (B,nc,Q,H)

    # intra-chunk: L[i, j] = exp(sum_{j<m<=i} loga[m]) for i >= j, else 0
    CB = torch.einsum("bcqn,bckn->bcqk", Cr, Br)
    cum_h = torch.cumsum(la.movedim(-1, 2), dim=-1)            # (B,nc,H,Q)
    seg = cum_h[..., :, None] - cum_h[..., None, :]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=u.device).tril()
    L = torch.exp(torch.where(causal, seg, -torch.inf))       # (B,nc,H,Q,Q)
    y_intra = torch.einsum("bcqk,bchqk,bckhp->bcqhp", CB, L, ur)

    h_in, h = ssd_chunk_states(u, loga, Bm, chunk=chunk, h0=h0)
    y_inter = torch.einsum("bcqn,bchnp,bcqh->bcqhp", Cr, h_in,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(Bsz, T, H, P)
    return y.to(u.dtype), h


def ssd_chunk_states(u: torch.Tensor, loga: torch.Tensor, Bm: torch.Tensor,
                     *, chunk: int, h0: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunk summaries B^T (u * decay to the chunk's end) and the
    sequential recurrence over chunks from h0, as ``ssd_scan_ref`` runs
    them (the kernel's passes 2 and 3): (the state entering each chunk
    (B, nc, H, N, P), the final state (B, H, N, P)), fp32."""
    Bsz, T, H, P = u.shape
    N = Bm.shape[-1]
    nc, Q = T // chunk, chunk
    ur = u.float().reshape(Bsz, nc, Q, H, P)
    cum = torch.cumsum(loga.float().reshape(Bsz, nc, Q, H), dim=2)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    S = torch.einsum("bckn,bckh,bckhp->bchnp",
                     Bm.float().reshape(Bsz, nc, Q, N), decay_to_end, ur)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (B,nc,H)
    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=u.device) \
        if h0 is None else h0.float()
    h_in = []
    for c in range(nc):
        h_in.append(h)                       # the state entering chunk c
        h = h * chunk_decay[:, c, :, None, None] + S[:, c]
    return torch.stack(h_in, dim=1), h
