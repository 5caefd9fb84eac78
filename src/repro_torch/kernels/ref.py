"""Plain PyTorch versions of the hand-written kernels, and the sequential
SSD recurrence as the oracle of the chunked scan. The CPU runs these;
``chip_smoke.py`` holds each kernel against them on the card."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def check_q_offset(T: int, S: int, causal: bool, q_offset: int) -> None:
    """Raises ``ValueError`` unless ``q_offset`` places T query rows inside
    a causal attention over S keys: ``q_offset >= 0``, and where it is
    positive, causal with ``q_offset + T <= S`` (at 0 any T and S, as
    before the offset)."""
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} is negative")
    if q_offset and not causal:
        raise ValueError(f"q_offset {q_offset} needs causal attention")
    if q_offset and q_offset + T > S:
        raise ValueError(f"q_offset {q_offset} + T {T} is past S {S}")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0
                        ) -> torch.Tensor:
    """q: (B, T, Hq, hd); k/v: (B, S, Hkv, hd); GQA by head broadcast.
    Scores in fp32, the causal mask ``q_offset + qpos >= kpos`` (aligned at
    0 by default, also when T != S), masked scores ``NEG_INF``; returns (B,
    T, Hq, hd) in q's dtype. Autograd through it is the plain backward.
    ``q_offset`` is checked as the kernel checks it (``check_q_offset``)."""
    B, T, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    if q_offset:
        check_q_offset(T, S, causal, q_offset)
    g = Hq // Hkv
    qg = q.reshape(B, T, Hkv, g, hd).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) / math.sqrt(hd)
    if causal:
        mask = torch.arange(T, device=q.device)[:, None] + q_offset >= \
            torch.arange(S, device=q.device)[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", p, v.float())
    return out.reshape(B, T, Hq, hd).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, *, return_lse: bool = False
                         ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Single-token GQA decode. q: (B, Hq, hd); k/v: (B, S, Hkv, hd);
    lengths: (B,) valid KV prefix, where ``length > S`` means S.
    Returns (B, Hq, hd) in q's dtype; with ``return_lse``, (that output in
    fp32, the (B, Hq) fp32 natural log of sum_j exp(q.k_j / sqrt(hd)) over
    the valid keys, -inf at length 0), a partial for
    ``merge_attention_partials``.

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
    if not return_lse:
        return out.reshape(B, Hq, hd).to(q.dtype)
    lse = torch.where((lengths > 0)[:, None, None],
                      torch.logsumexp(scores, dim=-1), -math.inf)
    return out.reshape(B, Hq, hd), lse.reshape(B, Hq)


def merge_attention_partials(outs: torch.Tensor, lses: torch.Tensor
                             ) -> torch.Tensor:
    """One query's attention from m partials over disjoint blocks of its
    keys: ``outs`` (m, ..., hd) each block's normalised output, ``lses``
    (m, ...) each block's log-sum-exp (``decode_attention_ref(...,
    return_lse=True)``'s, the kernel's). Weighted by exp(lse_r - max_r
    lse_r) and summed in block order 0, 1, ..., m - 1; a block at -inf
    (no valid key) adds nothing, and where every block is at -inf the
    result is zeros, as one call at length 0 gives. Returns (..., hd) in
    fp32."""
    outs, lses = outs.float(), lses.float()
    top = lses.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, 0.0)
    num = torch.zeros(outs.shape[1:], dtype=torch.float32,
                      device=outs.device)
    den = torch.zeros(lses.shape[1:], dtype=torch.float32,
                      device=outs.device)
    for out, lse in zip(outs, lses):                # in block order
        w = torch.where(torch.isfinite(lse), torch.exp(lse - top), 0.0)
        num = num + out * w[..., None]
        den = den + w
    return torch.where(den[..., None] > 0,
                       num / den.clamp_min(1e-30)[..., None], 0.0)


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


def ssd_scan_bwd_ref(u: torch.Tensor, loga: torch.Tensor, Bm: torch.Tensor,
                     Cm: torch.Tensor, h0: torch.Tensor | None,
                     dy: torch.Tensor, dstate: torch.Tensor | None, *,
                     chunk: int) -> tuple[torch.Tensor, ...]:
    """The backward of ``ssd_scan_ref``, the plain version of the
    ``ssd_scan`` backward kernel: the chunked formulas written out pass by
    pass as the kernel runs them, not autograd. dy: (B, T, H, P); dstate:
    (B, H, N, P) or None for zeros (the final state unused). Returns (du,
    dloga, dBm, dCm, dh0), fp32; dh0 is the gradient of the state entering
    chunk 0, also where h0 is None.

    Per chunk and head, with cum the within-chunk prefix sum of loga,
    e_i = exp(cum_i), d_j = exp(cum_last - cum_j), L_ij = exp(cum_i -
    cum_j) for i >= j, M = (C B^T) * L, h the state entering the chunk
    and g the gradient of the state leaving it:
      g_in = sum_i e_i C_i (x) dy_i + e_last g     (reverse over chunks)
      du_j = sum_{i>=j} M_ij dy_i + d_j (g^T B_j)
      dC_i = sum_h [sum_{j<=i} L_ij (dy_i . u_j) B_j + e_i (h dy_i)]
      dB_j = sum_h [sum_{i>=j} L_ij (dy_i . u_j) C_i + d_j (g u_j)]
      dcum_k = sum_j R_kj - sum_i R_ik + e_k (dy_k . C_k h)
               - d_k (u_k . g^T B_k),  R_ij = M_ij (dy_i . u_j),
      plus e_last <g, h> + sum_j d_j (u_j . g^T B_j) at the last k;
      dloga_m = sum_{k >= m in the chunk} dcum_k."""
    Bsz, T, H, P = u.shape
    N = Bm.shape[-1]
    if chunk <= 0 or T % chunk:
        raise ValueError(f"T={T} not divisible by chunk={chunk}")
    nc, Q = T // chunk, chunk
    ur = u.float().reshape(Bsz, nc, Q, H, P)
    dyr = dy.float().reshape(Bsz, nc, Q, H, P)
    Br = Bm.float().reshape(Bsz, nc, Q, N)
    Cr = Cm.float().reshape(Bsz, nc, Q, N)
    cum = torch.cumsum(loga.float().reshape(Bsz, nc, Q, H), dim=2)
    e = torch.exp(cum)                                        # (B,nc,Q,H)
    d = torch.exp(cum[:, :, -1:, :] - cum)
    last = torch.exp(cum[:, :, -1, :])                        # (B,nc,H)

    # the forward's chunk states (its passes 2 and 3)
    h_in, _ = ssd_chunk_states(u, loga, Bm, chunk=chunk, h0=h0)
    # (a) each chunk's sum_i e_i C_i (x) dy_i
    Z = torch.einsum("bcqn,bcqh,bcqhp->bchnp", Cr, e, dyr)
    # (b) the reverse state pass from dstate: g leaving each chunk, dh0
    g = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=u.device) \
        if dstate is None else dstate.float()
    g_out = [None] * nc
    for c in reversed(range(nc)):
        g_out[c] = g
        g = g * last[:, c, :, None, None] + Z[:, c]
    dh0, g = g, torch.stack(g_out, dim=1)                    # (B,nc,H,N,P)

    # (c) du and each head's dcum rows
    CB = torch.einsum("bcin,bcjn->bcij", Cr, Br)
    cum_h = cum.movedim(-1, 2)                                # (B,nc,H,Q)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=u.device).tril()
    L = torch.exp(torch.where(causal, cum_h[..., :, None]
                              - cum_h[..., None, :], -torch.inf))
    LP = L * torch.einsum("bcihp,bcjhp->bchij", dyr, ur)      # L * dy u^T
    R = CB[:, :, None] * LP
    gB = torch.einsum("bcjn,bchnp->bcjhp", Br, g)             # g^T B_j
    du = torch.einsum("bcij,bchij,bcihp->bcjhp", CB, L, dyr) \
        + d[..., None] * gB
    Ch = torch.einsum("bcin,bchnp->bcihp", Cr, h_in)          # C_i h
    dcum = (R.sum(-1) - R.sum(-2)).movedim(2, -1) \
        + e * (dyr * Ch).sum(-1) - d * (ur * gB).sum(-1)
    dcum[:, :, -1] += last * (g * h_in).sum((-2, -1)) \
        + (d * (ur * gB).sum(-1)).sum(2)
    dloga = dcum.flip(2).cumsum(2).flip(2)

    # (d) dB and dC, the panel summed over the heads first
    W = LP.sum(2)                                             # (B,nc,Q,Q)
    dC = torch.einsum("bcij,bcjn->bcin", W, Br) \
        + torch.einsum("bcih,bcihp,bchnp->bcin", e, dyr, h_in)
    dB = torch.einsum("bcij,bcin->bcjn", W, Cr) \
        + torch.einsum("bcjh,bcjhp,bchnp->bcjn", d, ur, g)
    return (du.reshape(Bsz, T, H, P), dloga.reshape(Bsz, T, H),
            dB.reshape(Bsz, T, N), dC.reshape(Bsz, T, N), dh0)
