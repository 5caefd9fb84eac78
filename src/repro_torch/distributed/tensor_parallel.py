"""Tensor-parallel compute along ``"model"`` for every family (dense,
vlm, ssm, hybrid, MoE and enc-dec): the port's counterpart of GSPMD's
partitioning of the reference's ``DenseLM``, ``MambaLM``, ``HybridLM``,
``MoELM`` and ``EncDecLM`` under ``param_specs`` and their ``constrain``
sites (``repro/models/transformer.py``, ``repro/models/mamba2.py``,
``repro/models/moe_ep.py``, ``repro/distributed/logical.py``).

``plan`` derives, from the config and the ``"model"`` axis size m, what a
rank computes locally:
  * attention, in one of five modes (``Plan.heads``):
    - ``"local"``, where m divides both head counts: ``wq``/``wk``/``wv``
      column-parallel, ``wo`` row-parallel, the rank's KV cache heads
      local;
    - ``"kv_replicated"``, where m divides the query heads and the KV heads
      divide m (llama-3.1-8b and llama-3.2-1b at m = 16): rank r attends
      with query heads ``[r Hq/m, (r+1) Hq/m)`` and the one KV head they
      share, ``r // (m / Hkv)``. ``wq`` and ``wo`` as under "local";
      ``wk``/``wv`` are whole along ``"model"`` and each rank takes its KV
      head's columns (``Route.kv_slice``), so their gradient is a partial
      sum along ``"model"`` (the ranks of one KV head add into its
      columns, zeros elsewhere). A serve cell's rank holds its KV head's
      cache whole (``sharding.tp_cache``);
    - ``"q_seq"``, where neither holds and m divides the sequence (T > 1;
      the reference's ``"q_seq"`` rule, which pins the score tensor's
      query dimension to ``"model"``): every rank holds the four weights
      whole (their gradient a partial sum) and attends from its own rows
      ``[a, b) = [r T/m, (r+1) T/m)`` against keys ``[0, b)`` with all
      heads (flash's ``q_offset = a``). In training the sequence-parallel
      residual is gathered, K/V computed over ``[0, b)``, Q, attention and
      ``wo`` over ``[a, b)``, which is the rank's residual slice, so no
      reduce follows. In prefill the residual is whole: K/V over every row
      into the cache (gathered along ``"model"``), Q to ``wo`` over
      ``[a, b)``, then the rows all-gathered (forward only). The rows are
      contiguous, so the last rank does (2m - 1)/m times the mean rank's
      attention work (1.94 at m = 16);
    - ``"kv_seq"``, a decode step of the dense, vlm and enc-dec families
      where neither of the first two holds and m divides the cache's
      positions S: rank r holds positions ``[r S/m, (r+1) S/m)`` of every
      KV head, whole in ``head_dim`` (``Plan.kv_rows``;
      ``sharding.tp_cache``).
      Every rank computes q, k and v of the new token from whole weights,
      the rank that owns the written row writes it, each rank runs
      ``decode_attention`` with every query head over its positions and
      returns its log-sum-exp, the ranks' (output, lse) partials are
      all-gathered along ``"model"`` and merged in rank order on every
      rank (``KVSplit.merge``), and ``wo`` runs whole on the merged
      output. The cache's layout follows this decode plan for the same S
      whatever step writes it: a "q_seq" or "gathered" prefill of such a
      config computes K/V over every row, writes the rows the rank owns
      and attends over the fresh K/V (``Plan.cache_len``);
    - ``"gathered"`` otherwise (decode where none of the first three
      holds, T not divisible by m): every rank computes the sublayer whole
      and keeps its slice;
  * the MLP, when m divides ``d_ff``: ``w_gate``/``w_up`` column-parallel,
    ``w_down`` row-parallel; otherwise gathered. In the MoE family the MLP
    is the shared experts, ``n_shared_experts * d_ff`` wide;
  * the MoE family's routed experts (``Route.moe``; expert-parallel
    configs, ``moe_impl="ep"``, alone): expert parallelism over every mesh
    axis, the reference's ``moe_block_ep``. Each rank holds ``E_pad / ep``
    whole experts (``ep`` the world, experts padded to a multiple of it);
    its tokens are the m contiguous blocks of its data rows' flattened
    (rows x T) tokens, block r on rank r along ``"model"`` (the rows whole:
    gathered along ``"model"`` first where the residual is
    sequence-parallel). Where m divides the rows' tokens these are the
    reference's blocks of the global tokens (its ``shard_map`` cuts them
    into ``ep`` blocks in mesh order). Where it does not, each data rank
    pads its tokens with zero rows to a multiple of m: the same number of
    tokens a rank and of zero rows as the reference's padding at the end,
    so the same capacity and the aux's statistics over the same tokens;
    the blocks then differ from the reference's, which cross the data
    ranks, and a token's output is the reference's wherever no pair can
    drop, a block no longer than the capacity (every decode step: one
    token a rank). A padded block longer than the capacity raises. Two
    all-to-alls over the world a layer (tokens to their experts and back),
    an all-reduce of the aux's statistics; the output all-gathered along
    ``"model"`` into the residual's layout;
  * the mamba2 block (``Plan.ssm``), "local" where m divides the SSM
    heads H: rank r computes heads ``[r H/m, (r+1) H/m)``, reading its
    heads' z, x and dt columns of ``in_proj`` and x channels of ``conv_w``
    and ``conv_b``, and B and C whole (one group: every head reads them;
    ``Route.ssm_slice``). How ``in_proj``, ``conv_w`` and ``conv_b`` are
    stored is the plan's ``ssm_layout``:
    - ``"by_rank"``, where m divides N too: in the by-rank column order
      (``sharding.ssm_rank_columns``: rank r's block ``[z_r, x_r, B_r, C_r,
      dt_r]``, B_r and C_r its N/m of B's and C's columns), sharded on
      their columns along ``"model"`` as the reference's spec shards them,
      so a rank computes from its own block and all-gathers B and C along
      ``"model"`` (the gather's backward sums each rank's share of their
      gradient into the rank that holds them); their gradient is the
      block's own along ``"model"``;
    - ``"whole"``, where m does not divide N: in the reference's column
      order, whole along ``"model"``, each rank taking its columns, so
      their gradient is a partial sum along ``"model"``.
    ``dt_bias``, ``A_log``, ``D``, ``norm_w`` and ``out_proj``'s rows are
    the rank's; the scan and the decode recurrence run on H/m heads, the
    state is the rank's heads. The gated RMSNorm normalises over the whole
    ``d_inner``: the rank's fp32 sum of squares is all-reduced before the
    rsqrt (``norm_sum``), and, since that sum feeds every rank's own math,
    its backward all-reduces the gradient too. Otherwise "gathered": every
    rank computes the block whole (``ssm_layout`` "whole"). A family
    without attention or an MLP has no mode for them (``Plan.heads`` and
    ``Plan.mlp_local`` None);
  * the vocab, when m divides it: the embedding lookup and the logits are
    this rank's rows and columns, and the loss is
    ``vocab_parallel_cross_entropy``; otherwise whole, and in a
    sequence-parallel train step (``Plan.loss_rows``) each rank computes
    the whole-vocab logits and NLL of its own positions alone, their
    masked sum all-reduced along ``"model"`` (whisper-tiny's 51865 at m =
    16: a rank's logits are 1/m of its rows', not every row's);
  * sequence-parallel residuals in training where m divides the residual
    sequence (the reference's ``"seq_res"``): RMSNorm on the rank's slice,
    an all-gather before each sublayer and a reduce-scatter after its
    row-parallel product. Otherwise (serving, or T not divisible) the
    residual is whole on every rank and each row-parallel product ends in
    one all-reduce;
  * the enc-dec family (whisper) has two plans. The decoder's is the one
    above, for its text of T positions against its self-attention cache
    of S. The encoder's (``Plan.encoder``; a train or prefill step) is the
    same rules at T = ``enc_len``, non-causal: its attention "local" or
    "kv_replicated" by the heads, else "q_seq" where m divides
    ``enc_len`` (a rank's query rows against every key, and, in
    training, the encoder's residual sequence-parallel), else "gathered".
    The cross-attention (``Route.cross_attention``) follows the decoder's
    mode: where its heads split, ``wq``/``wk``/``wv`` column-parallel (the
    rank's KV head's columns under "kv_replicated"), ``wo`` row-parallel,
    and the cross K/V the rank's heads; under "q_seq" the rank's query
    rows against every encoder position, ``wk``/``wv`` whole (their
    gradient a partial sum), with no reduce in training; otherwise
    ("kv_seq", "gathered") whole on every rank, against cross K/V held
    whole along ``"model"`` (``sharding.tp_cache``). The encoder's output
    is made whole on every rank for the cross K/V (``Route.memory``).

A ``Route`` is a plan and the process group it runs over. The model code
computes on plain local tensors and calls the route at the sublayer
boundaries; the collectives are ``torch.autograd.Function`` pairs over the
functional collectives (Megatron's f and g, and the all-gather and
reduce-scatter along the sequence; EP's all-to-all, whose backward is the
same all-to-all, and the aux's all-reduce), and the forward-only
all-gather of the "kv_seq" decode partials. Over a group of one rank, or
with no route, each of the first four is the identity. Nothing here
imports the models.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import merge_attention_partials

from . import logical

#: the families whose layers compute tensor-parallel along "model" (MoE:
#: its expert-parallel configs)
TP_FAMILIES = ("dense", "vlm", "ssm", "hybrid", "moe", "encdec")

_c10d = torch.ops._c10d_functional


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Plan:
    """What one rank of a ``"model"`` axis of size ``model`` holds and
    computes for a step whose residual stream is ``seq_len`` long;
    ``heads`` is the attention's mode ("local", "kv_replicated", "q_seq",
    "kv_seq" or "gathered", the module's docstring says which; None
    without attention), ``local_heads`` the (query, KV) heads a rank
    attends with, ``kv_share`` the ranks that share one KV head
    ("kv_replicated"; 1 else), ``cache_len`` the cache's positions S where
    the KV cache is split over its positions along ``"model"`` (the decode
    plan for S is "kv_seq"; a prefill's plan carries it too, since it
    writes that layout), else None, ``mlp_local`` None without an MLP;
    ``ssm`` the mamba2 block's
    mode ("local" or "gathered"; None without one), ``ssm_heads`` the
    SSM heads a rank computes and ``ssm_layout`` how its ``in_proj``,
    ``conv_w`` and ``conv_b`` are stored ("by_rank" or "whole", the
    module's docstring says which); for the MoE family ``ep`` the expert-
    parallel group's size (the world), ``ep_experts`` the experts a rank
    holds and ``capacity`` a source rank's slots an expert (None where the
    rows are not known), else None; for an enc-dec train or prefill step
    ``encoder`` the encoder's plan (``seq_len`` its ``enc_len``), else
    None."""
    model: int
    heads: str | None
    mlp_local: bool | None
    vocab_local: bool
    seq_parallel: bool
    local_heads: tuple[int, int] | None
    seq_len: int
    kv_share: int
    ssm: str | None = None
    ssm_heads: int | None = None
    ssm_layout: str | None = None
    cache_len: int | None = None
    ep: int | None = None
    ep_experts: int | None = None
    capacity: int | None = None
    encoder: Plan | None = None

    @property
    def loss_rows(self) -> bool:
        """Whether a train step's logits and NLL are each rank's own
        positions' alone, over the whole vocab (sequence-parallel, the
        vocab whole)."""
        return self.seq_parallel and not self.vocab_local and self.model > 1

    @property
    def heads_local(self) -> bool:
        """Whether the attention's products are column- then row-parallel
        (its heads split over the ranks)."""
        return self.heads in ("local", "kv_replicated")

    def q_rows(self, rank: int) -> tuple[int, int] | None:
        """The query rows [a, b) the ``"model"`` rank ``rank`` attends
        from under "q_seq", else None (every row)."""
        if self.heads != "q_seq":
            return None
        n = self.seq_len // self.model
        return rank * n, (rank + 1) * n

    def kv_rows(self, rank: int) -> tuple[int, int] | None:
        """The cache positions [r S/m, (r+1) S/m) that the ``"model"``
        rank ``rank`` holds where the cache is split over its positions
        (``cache_len`` set), else None (the cache's every position)."""
        if self.cache_len is None:
            return None
        n = self.cache_len // self.model
        return rank * n, (rank + 1) * n

    def record(self, model_rank: int | None = None) -> dict:
        """The plan as the dry run writes it; with ``model_rank``, that
        rank's query rows too, and under "q_seq" the last rank's attention
        work over the mean rank's. Where the cache is split over its
        positions, its ``cache_len`` and, with ``model_rank``, the rank's
        ``kv_rows``. An enc-dec step's encoder plan under ``"encoder"``
        (its attention's mode, local heads, MLP, whether
        sequence-parallel and, with ``model_rank``, the rank's query
        rows). A mamba2 block's mode, heads a rank and layout."""
        mlp = (None if self.mlp_local is None else
               "local" if self.mlp_local else "gathered")
        out = {"model": self.model, "heads": self.heads,
               "local_heads": (None if self.local_heads is None
                               else list(self.local_heads)),
               "mlp": mlp, "vocab": "local" if self.vocab_local else "whole",
               "seq_parallel": self.seq_parallel}
        if self.ssm is not None:
            out.update(ssm=self.ssm, ssm_heads=self.ssm_heads,
                       ssm_layout=self.ssm_layout)
        if self.ep is not None:
            out.update(ep=self.ep, ep_experts=self.ep_experts,
                       capacity=self.capacity)
        if self.cache_len is not None:
            out["cache_len"] = self.cache_len
        if model_rank is not None:
            rows = self.q_rows(model_rank)
            out.update(model_rank=model_rank,
                       q_rows=None if rows is None else list(rows))
            if rows is not None:
                out["q_seq_heaviest_over_mean"] = \
                    (2 * self.model - 1) / self.model
            if self.cache_len is not None:
                out["kv_rows"] = list(self.kv_rows(model_rank))
        if self.encoder is not None:
            enc = self.encoder.record(model_rank)
            out["encoder"] = {k: enc[k] for k in (
                "heads", "local_heads", "mlp", "seq_parallel", "q_rows")
                if k in enc}
        return out


def ep_capacity(n_loc: int, cfg) -> int:
    """A source rank's slots an expert under expert parallelism for its
    ``n_loc`` tokens: rounded up to 4, at least 4 (the reference's EP
    capacity, not the grouped dispatch's 8)."""
    cap = int(cfg.capacity_factor * n_loc * cfg.top_k / cfg.n_experts)
    return max(4, -(-cap // 4) * 4)


def _heads_local(cfg, m: int) -> bool:
    """Whether the attention's heads split over m ranks ("local" or
    "kv_replicated"), whatever the step."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    return hq % m == 0 and (hkv % m == 0 or m % hkv == 0)


def cache_split(cfg, m: int, cache_len: int | None) -> bool:
    """Whether a serve cell's KV cache of ``cache_len`` positions is
    split over its positions along a ``"model"`` axis of m ranks: the
    decode plan is "kv_seq" (the dense, vlm and enc-dec families, the
    latter's decoder self-attention cache; heads that do not split over m,
    m dividing the positions). A rule of the plan, not a fallback: where m
    does not divide S the cache is gathered."""
    return (cache_len is not None and m > 1
            and cfg.family in ("dense", "vlm", "encdec")
            and bool(cfg.n_heads)
            and not _heads_local(cfg, m) and cache_len % m == 0)


def ssm_by_rank(cfg, m: int) -> bool:
    """Whether a mamba2 block's ``in_proj``, ``conv_w`` and ``conv_b`` are
    stored in the by-rank column order along a ``"model"`` axis of m ranks
    (``Plan.ssm_layout`` "by_rank"): the ssm and hybrid families, m
    dividing the SSM heads and the state width N (one group of B and C).
    A rule of the layout, not a fallback: elsewhere they are stored
    whole. It reads the config and m alone, so every step of a cell
    (train, prefill, decode) takes the layout its state is stored in; at
    m = 1 the order is the reference's."""
    return (cfg.family in ("ssm", "hybrid") and cfg.ssm_heads % m == 0
            and cfg.ssm_state % m == 0)


def plan(cfg, m: int, *, kind: str, seq_len: int, ep: int | None = None,
         rows: int | None = None, cache_len: int | None = None) -> Plan:
    """The plan of a ``kind`` step ("train", "prefill" or "decode") whose
    residual stream is ``seq_len`` positions long (a vlm's patches
    included), for a ``"model"`` axis of ``m`` ranks. At m = 1 every
    config is "local". The MoE family needs ``ep``, the world's size, and
    takes ``rows``, a data rank's rows, for its capacity. A prefill or
    decode step takes ``cache_len``, the KV cache's positions S (None: a
    cache whole on every rank along ``"model"``): where ``cache_split``
    holds, a decode step is "kv_seq" and either step's ``cache_len`` is
    S. An enc-dec train or prefill step's plan carries the encoder's
    (``Plan.encoder``)."""
    p = _plan(cfg, m, kind=kind, seq_len=seq_len, ep=ep, rows=rows,
              cache_len=cache_len)
    if cfg.family == "encdec" and kind != "decode":
        p = replace(p, encoder=_plan(cfg, m, kind=kind,
                                     seq_len=cfg.enc_len))
    return p


def _plan(cfg, m: int, *, kind: str, seq_len: int, ep: int | None = None,
          rows: int | None = None, cache_len: int | None = None) -> Plan:
    """``plan`` of one stack of layers (an enc-dec model's decoder, or its
    encoder at ``enc_len``)."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    share = 1
    split = kind != "train" and cache_split(cfg, m, cache_len)
    if not hq:
        heads, local = None, None
    elif hq % m == 0 and hkv % m == 0:
        heads, local = "local", (hq // m, hkv // m)
    elif hq % m == 0 and m % hkv == 0:
        heads, local, share = "kv_replicated", (hq // m, 1), m // hkv
    elif seq_len > 1 and seq_len % m == 0:
        heads, local = "q_seq", (hq, hkv)
    elif kind == "decode" and split:
        heads, local = "kv_seq", (hq, hkv)
    else:
        heads, local = "gathered", (hq, hkv)
    ssm = ssm_heads = layout = None
    if cfg.family in ("ssm", "hybrid"):
        h = cfg.ssm_heads
        ssm, ssm_heads = ("local", h // m) if h % m == 0 else ("gathered", h)
        layout = "by_rank" if ssm_by_rank(cfg, m) else "whole"
    ff = cfg.d_ff
    moe = {}
    if cfg.family == "moe":
        if ep is None:
            raise ValueError("an MoE plan needs the expert-parallel group")
        ff = cfg.d_ff * cfg.n_shared_experts       # the shared experts
        moe = dict(ep=ep, ep_experts=-(-cfg.n_experts // ep),
                   capacity=None if rows is None else ep_capacity(
                       -(-rows * seq_len // m), cfg))
    return Plan(model=m, heads=heads,
                mlp_local=ff % m == 0 if ff else None,
                vocab_local=cfg.vocab_size % m == 0,
                seq_parallel=kind == "train" and seq_len % m == 0,
                local_heads=local, seq_len=seq_len, kv_share=share,
                ssm=ssm, ssm_heads=ssm_heads, ssm_layout=layout,
                cache_len=cache_len if split else None, **moe)


def computes_tp(cfg) -> bool:
    """Whether ``cfg``'s layers compute tensor-parallel along "model" under
    a mesh: the families of ``TP_FAMILIES``, an MoE model only where it is
    expert-parallel (``moe_impl="ep"``; a grouped-dispatch MoE gathers
    every leaf and computes whole)."""
    return cfg.family in TP_FAMILIES and (cfg.family != "moe"
                                          or cfg.moe_impl == "ep")


def mesh_plan(cfg, mesh, *, kind: str, seq_len: int,
              rows: int | None = None, cache_len: int | None = None
              ) -> Plan | None:
    """``plan`` on ``mesh``'s ``"model"`` axis (the EP group its every
    rank), or None: a family that computes whole, or a mesh without that
    axis."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if not computes_tp(cfg) or "model" not in sizes:
        return None
    return plan(cfg, sizes["model"], kind=kind, seq_len=seq_len,
                ep=mesh.size() if cfg.family == "moe" else None, rows=rows,
                cache_len=cache_len)


def residual_len(cfg, batch: dict) -> int:
    """The residual stream's length of a training batch: the text, after
    the patches where the family is vlm."""
    n = batch["tokens"].shape[1]
    if cfg.family == "vlm" and "patch_embeds" in batch:
        n += batch["patch_embeds"].shape[1]
    return n


# ---------------------------------------------------------------------------
# collectives over the "model" group (the identity over one rank)
# ---------------------------------------------------------------------------
def _all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    out = _c10d.all_reduce(x.contiguous(), op, group.group_name)
    return _c10d.wait_tensor(out)


def _all_gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' (B, T/m, ...) slices as (B, T, ...), rank-major."""
    m = group.size()
    out = _c10d.wait_tensor(_c10d.all_gather_into_tensor(
        x.contiguous(), m, group.group_name))
    return torch.cat(out.chunk(m, 0), 1)


def _reduce_scatter_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of (B, T, ...), this rank's T/m slice."""
    m = group.size()
    return _c10d.wait_tensor(_c10d.reduce_scatter_tensor(
        torch.cat(x.chunk(m, 1), 0).contiguous(), "sum", m,
        group.group_name))


class _CopyIn(torch.autograd.Function):
    """f: the identity forward, an all-reduce of the gradient (a
    column-parallel product's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.group), None


class _SumOverRanks(torch.autograd.Function):
    """An all-reduce whose sum feeds rank-local math on every rank (the
    gated RMSNorm's statistic): each rank's gradient is its own math's
    share, so the backward all-reduces the gradient too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """g: an all-reduce forward, the identity backward (a row-parallel
    product's partial sums)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    """An all-gather along the sequence; backward a reduce-scatter (the
    consumers' gradients are partial sums) or, with ``reduce_grad``
    False, the rank's slice (they are equal on every rank)."""

    @staticmethod
    def forward(ctx, x, group, reduce_grad):
        ctx.group, ctx.reduce_grad = group, reduce_grad
        return _all_gather_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            return _reduce_scatter_seq(g, ctx.group), None, None
        m, r = ctx.group.size(), ctx.group.rank()
        return g.chunk(m, 1)[r].contiguous(), None, None


class _ReduceScatterSeq(torch.autograd.Function):
    """A reduce-scatter along the sequence; backward an all-gather."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_seq(g, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block j of ``x``'s equal blocks along axis 0 to rank j; block i of
    the result from rank i."""
    n = group.size()
    split = [x.shape[0] // n] * n
    return _c10d.wait_tensor(_c10d.all_to_all_single(
        x.contiguous(), split, split, group.group_name))


class _AllToAll(torch.autograd.Function):
    """An all-to-all over equal blocks; its backward is the same
    all-to-all (each block goes back to the rank it came from, to the
    place it left)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _StatSum(torch.autograd.Function):
    """The sum over the ranks of a statistic that every rank's loss reads
    (EP's aux statistics). Ranks that repeat one loss (the ranks along
    ``"model"``, or every rank where each computes the whole) would each
    send the same gradient, so only the rank whose ``counts`` is set sends
    its own: the backward sums ``g`` over the ranks that count, zeros over
    the others, and the statistic's gradient counts each distinct loss
    once."""

    @staticmethod
    def forward(ctx, x, group, counts):
        ctx.group, ctx.counts = group, counts
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        g = g if ctx.counts else torch.zeros_like(g)
        return _all_reduce(g, "sum", ctx.group), None, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``_AllToAll`` over ``group`` (any size: over one rank a copy)."""
    return _AllToAll.apply(x, group)


def stat_sum(x: torch.Tensor, group, counts: bool) -> torch.Tensor:
    """``_StatSum`` over ``group``; ``counts``: this rank's loss is one
    whose gradient the sum takes."""
    return _StatSum.apply(x, group, counts)


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f over ``group``: the identity, the gradient summed over
    the ranks (each rank's use of ``x`` is its own share)."""
    return _CopyIn.apply(x, group) if group.size() > 1 else x


def gather_blocks(x: torch.Tensor, group, reduce_grad: bool) -> torch.Tensor:
    """The ranks' (n, ...) blocks as one (ranks x n, ...), rank-major;
    backward each rank's block of the gradient, summed over the ranks with
    ``reduce_grad`` (each rank's gradient is its own share), else this
    rank's (the gradients are equal on every rank)."""
    if group.size() == 1:
        return x
    return _GatherSeq.apply(x[None], group, reduce_grad)[0]


@dataclass(frozen=True)
class KVSplit:
    """A rank's block of a KV cache split over its positions along
    ``"model"`` (the "kv_seq" layout): positions ``[start, start + rows)``
    of the whole cache's ``cache_len``, every KV head whole in
    ``head_dim``; ``group`` the ``"model"`` group. The attention block
    (``models/attention.py``) writes the rows it owns and attends over
    them; ``merge`` makes the whole decode attention of the ranks'
    partials."""
    start: int
    rows: int
    cache_len: int
    group: object

    def merge(self, out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
        """The ranks' decode partials, this rank's ``out`` (B, Hq, hd)
        fp32 and ``lse`` (B, Hq), all-gathered along ``"model"`` as one
        (B, Hq, hd + 1) tensor a rank and merged in rank order 0, 1, ...,
        m - 1 (``merge_attention_partials``), so every rank holds the same
        bits. Forward only (a decode step). Returns (B, Hq, hd) fp32."""
        m = self.group.size()
        part = torch.cat([out.float(), lse.float()[..., None]], dim=-1)
        every = _c10d.wait_tensor(_c10d.all_gather_into_tensor(
            part.contiguous(), m, self.group.group_name))
        every = every.reshape(m, *part.shape)
        return merge_attention_partials(every[..., :-1], every[..., -1])


# ---------------------------------------------------------------------------
# the vocab-parallel embedding and loss
# ---------------------------------------------------------------------------
def vocab_parallel_embedding(tokens: torch.Tensor, table: torch.Tensor,
                             start: int) -> torch.Tensor:
    """This rank's share of the lookup: rows ``start`` to ``start +
    len(table)`` of the whole table; ids outside them read zeros, so the
    sum over the ranks is the whole lookup."""
    local = tokens.long() - start
    outside = (local < 0) | (local >= table.shape[0])
    h = F.embedding(local.masked_fill(outside, 0), table)
    return h.masked_fill(outside[..., None], 0)


class _VocabParallelNLL(torch.autograd.Function):
    """Each token's NLL from this rank's vocab columns of the fp32 logits:
    the max, the sum of exponentials and the gold logit all-reduced over
    the group; the gradient is local. It never builds the whole logits.

    Over one rank it computes ``torch.logsumexp`` and ``torch.gather``'s
    values and their autograd's gradient op for op, so the same bits."""

    @staticmethod
    def forward(ctx, logits, labels, start, group):
        mx = logits.amax(-1, keepdim=True)
        if group is not None and group.size() > 1:
            mx = _all_reduce(mx, "max", group)
        mx.masked_fill_(mx.abs() == float("inf"), 0)
        sumexp = (logits - mx).exp().sum(-1)
        local = labels.long() - start
        inside = (local >= 0) & (local < logits.shape[-1])
        idx = local.clamp(0, logits.shape[-1] - 1)[..., None]
        gold = torch.where(inside, torch.gather(logits, -1, idx).squeeze(-1),
                           0.0)
        if group is not None and group.size() > 1:
            sumexp = _all_reduce(sumexp, "sum", group)
            gold = _all_reduce(gold, "sum", group)
        logz = sumexp.log() + mx.squeeze(-1)
        ctx.save_for_backward(logits, logz, idx, inside)
        return logz - gold

    @staticmethod
    def backward(ctx, g):
        logits, logz, idx, inside = ctx.saved_tensors
        soft = g[..., None] * (logits - logz[..., None]).exp()
        gold = torch.zeros_like(logits).scatter_add_(
            -1, idx, torch.where(inside, -g, 0.0)[..., None])
        return soft + gold, None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 start: int, group) -> torch.Tensor:
    """Per-token NLL (fp32) from this rank's vocab columns ``start`` to
    ``start + logits.shape[-1]``."""
    return _VocabParallelNLL.apply(logits.float(), labels, start, group)


# ---------------------------------------------------------------------------
# the route a step runs
# ---------------------------------------------------------------------------
class Route:
    """A plan and the ``"model"`` group it runs over: the model calls it
    where the reference pins an activation's sharding. ``mesh``: the mesh
    whose every rank is the MoE family's expert-parallel group."""

    def __init__(self, plan: Plan, group, mesh=None) -> None:
        if group is not None and group.size() != plan.model:
            raise ValueError(f"a plan for {plan.model} ranks on a group of "
                             f"{group.size()}")
        self.plan, self.group, self.mesh = plan, group, mesh
        self.rank = group.rank() if group is not None else 0
        self.sp = plan.seq_parallel

    @property
    def _many(self) -> bool:
        return self.plan.model > 1

    # -- collectives, the identity over one rank ------------------------------
    def copy_in(self, x):
        return _CopyIn.apply(x, self.group) if self._many else x

    def reduce_out(self, x):
        return _ReduceOut.apply(x, self.group) if self._many else x

    def gather_seq(self, x, reduce_grad: bool = True):
        return (_GatherSeq.apply(x, self.group, reduce_grad)
                if self._many else x)

    def scatter_seq(self, x):
        return _ReduceScatterSeq.apply(x, self.group) if self._many else x

    def split_seq(self, x):
        """This rank's slice of a sequence every rank holds whole (its
        gradient is the slice's alone)."""
        return x.chunk(self.plan.model, 1)[self.rank] if self._many else x

    def rows_nll(self, nll_of, h: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None, skip: int = 0) -> torch.Tensor:
        """The mean NLL over a data rank's whole rows under ``loss_rows``
        from this rank's slice ``h`` of the normed residual: ``nll_of(x,
        labels)`` each token's NLL of the whole-vocab logits of ``x``, on
        the slice's positions that have labels (the residual's first
        ``skip``, a vlm's patches, have none); ``labels`` and ``mask`` are
        the whole rows'. The slice's masked sum is all-reduced along
        ``"model"`` (each rank's gradient its own positions'), over the
        whole rows' count."""
        n = h.shape[1]
        a = self.rank * n
        lo, hi = max(a, skip), max(a + n, skip)     # the labelled positions
        nll = nll_of(h[:, lo - a:], labels[:, lo - skip:hi - skip])
        if mask is None:
            return self.reduce_out(nll.sum()) / labels.numel()
        mask = mask.float()
        part = (nll * mask[:, lo - skip:hi - skip]).sum()
        return self.reduce_out(part) / torch.clamp_min(mask.sum(), 1.0)

    @property
    def q_rows(self) -> tuple[int, int] | None:
        """This rank's query rows under "q_seq", else None."""
        return self.plan.q_rows(self.rank)

    @property
    def kv_split(self) -> KVSplit | None:
        """This rank's block of a KV cache split over its positions
        (``Plan.cache_len`` set: a "kv_seq" decode, or a prefill that
        writes that layout), else None."""
        rows = self.plan.kv_rows(self.rank)
        if rows is None:
            return None
        return KVSplit(rows[0], rows[1] - rows[0], self.plan.cache_len,
                       self.group)

    def kv_slice(self, w: torch.Tensor) -> torch.Tensor:
        """The columns of this rank's KV head in a whole ``wk`` or ``wv``
        (d, Hkv * hd) under "kv_replicated"; the slice's gradient is zero
        outside them."""
        hkv = self.plan.model // self.plan.kv_share
        width = w.shape[-1] // hkv
        head = self.rank // self.plan.kv_share
        return w[..., head * width:(head + 1) * width]

    # -- the model's boundaries -----------------------------------------------
    def attention(self, fn, p, x: torch.Tensor) -> torch.Tensor:
        """The attention sublayer ``fn(p, x, q_rows)`` (``p`` its params,
        an ``AttnParams``; ``q_rows`` the rows it returns, None for all) on
        the normed residual ``x``, in the plan's mode (``Plan.heads``).
        Under "kv_seq", as under "gathered", ``fn`` runs whole on every
        rank: the attention block reads the rank's positions of the cache
        and the merge of the ranks' partials from ``kv_split``, which a
        cached trunk passes it. Returns the output in the residual's
        layout."""
        mode = self.plan.heads
        if mode == "kv_replicated":
            p = p._replace(wk=self.kv_slice(p.wk), wv=self.kv_slice(p.wv))
        if mode == "q_seq":
            if self.sp:           # the output is the rank's residual slice
                return fn(p, self.gather_seq(x), self.q_rows)
            # prefill: forward only, each rank's rows gathered
            return self.gather_seq(fn(p, x, self.q_rows), reduce_grad=False)
        return self.sublayer(lambda h: fn(p, h, None), x,
                             self.plan.heads_local)

    @property
    def encoder(self) -> Route:
        """An enc-dec step's encoder route: its plan (``Plan.encoder``)
        over the same group."""
        return Route(self.plan.encoder, self.group, self.mesh)

    def cross_attention(self, fn, p, x: torch.Tensor) -> torch.Tensor:
        """The cross-attention sublayer ``fn(p, x, q_rows)`` (``p`` its
        params, whose ``wk``/``wv`` ``fn`` does not read: its K/V are the
        encoder's, ``memory``'s) on the normed residual ``x``, in the
        decoder's mode: its heads' columns and rows of ``wq`` and ``wo``
        column- then row-parallel where they split; under "q_seq" the
        rank's query rows (in training its residual slice, so nothing is
        gathered or reduced); else whole on every rank. Returns the output
        in the residual's layout."""
        if self.plan.heads == "q_seq":
            if self.sp:
                return fn(p, x, None)
            return self.gather_seq(fn(p, x, self.q_rows), reduce_grad=False)
        return self.sublayer(lambda h: fn(p, h, None), x,
                             self.plan.heads_local)

    def memory(self, enc: Route, h: torch.Tensor) -> torch.Tensor:
        """The encoder's normed output ``h``, in the residual layout of
        its route ``enc``, whole on every rank for the cross K/V. Where
        the decoder's cross-attention is rank-local (its heads split, or
        its query rows are the rank's) each rank's gradient of it is a
        share, summed over the ranks; else every rank's is the whole."""
        share = self.plan.heads_local or self.plan.heads == "q_seq"
        if enc.sp:
            return enc.gather_seq(h, reduce_grad=share)
        return self.copy_in(h) if share else h

    def sublayer(self, fn, x: torch.Tensor, local: bool) -> torch.Tensor:
        """``fn`` (attention or the MLP, without its residual) on the
        normed residual ``x``: column- then row-parallel when its weights
        are ``local``, else on whole weights, every rank alike. Returns
        the output in the residual's layout."""
        if local:
            if self.sp:
                return self.scatter_seq(fn(self.gather_seq(x)))
            return self.reduce_out(fn(self.copy_in(x)))
        if self.sp:
            return self.split_seq(fn(self.gather_seq(x)))
        return fn(x)

    def moe(self, routed, shared, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
        """The MoE sublayer on the normed residual ``x``: its data rows'
        tokens whole on every rank along ``"model"`` (gathered where the
        residual is sequence-parallel), flattened, padded with zero rows
        to a multiple of m and cut into m blocks; ``routed(tokens, padded,
        counts)`` the routed experts on this rank's block (n, d) by
        expert parallelism, ``padded`` whether zero rows were added,
        ``counts`` whether this rank's loss is one the aux's gradient
        takes (rank 0 along ``"model"``: the others repeat its loss),
        returning (its output (n, d), the aux); the blocks' outputs
        gathered along ``"model"``. ``shared(h)`` the shared experts (None
        without them), column- then row-parallel where the plan's MLP is
        local, as ``sublayer``. The two outputs add in the residual's
        layout. Returns (the output, the aux)."""
        m, r = self.plan.model, self.rank
        rows = self.gather_seq(x) if self.sp else self.copy_in(x)
        B, T, d = rows.shape
        n = B * T
        n_loc = -(-n // m)
        tokens = F.pad(rows.reshape(n, d), (0, 0, 0, m * n_loc - n))
        out, aux = routed(tokens[r * n_loc:(r + 1) * n_loc],
                          padded=m * n_loc != n, counts=r == 0)
        out = gather_blocks(out, self.group, reduce_grad=self.sp) if \
            self._many else out
        out = out[:n].reshape(B, T, d)
        if self.sp:
            out = self.split_seq(out)
        if shared is None:
            return out, aux
        if self.plan.mlp_local:
            s = shared(rows)
            s = self.scatter_seq(s) if self.sp else self.reduce_out(s)
        else:
            s = self.sublayer(shared, x, False)
        return out + s, aux

    def embed(self, tokens: torch.Tensor, table: torch.Tensor,
              prefix: torch.Tensor | None = None) -> torch.Tensor:
        """The residual stream's entry: the lookup (vocab-parallel where
        the vocab is local) after ``prefix`` (a vlm's projected patches),
        in the residual's layout. Where the lookup is a partial sum, the
        prefix counts on rank 0 alone (zeros elsewhere, so its gradient
        stays on the graph of every rank)."""
        if self.plan.vocab_local:
            h = vocab_parallel_embedding(tokens, table,
                                         self.rank * table.shape[0])
            if prefix is not None:
                h = torch.cat([prefix if self.rank == 0 else prefix * 0, h],
                              dim=1)
            return self.scatter_seq(h) if self.sp else self.reduce_out(h)
        h = F.embedding(tokens.long(), table)
        if prefix is not None:
            h = torch.cat([prefix, h], dim=1)
        return self.split_seq(h) if self.sp else h

    def head_input(self, h: torch.Tensor) -> torch.Tensor:
        """The normed residual, whole on every rank, for the logits: a
        column-parallel product where the vocab is local."""
        if self.sp:
            return self.gather_seq(h, reduce_grad=self.plan.vocab_local)
        return self.copy_in(h) if self.plan.vocab_local else h

    def nll(self, logits: torch.Tensor, labels: torch.Tensor
            ) -> torch.Tensor:
        """Per-token NLL of this rank's logits (its vocab columns where
        the vocab is local)."""
        return vocab_parallel_cross_entropy(
            logits, labels, self.rank * logits.shape[-1], self.group)

    def ssm(self, fn, p, x: torch.Tensor) -> torch.Tensor:
        """The mamba2 block ``fn(p, x, norm_sum)`` (``p`` its params, a
        ``Mamba2Params``; ``norm_sum`` what the gated RMSNorm's sum of
        squares goes through, None where the block is whole) on the normed
        residual ``x``, in the plan's mode (``Plan.ssm``): "local", the
        rank's heads of ``p`` (``ssm_slice``) column- then row-parallel;
        else whole on every rank. Returns the output in the residual's
        layout."""
        if self.plan.ssm != "local":
            return self.sublayer(lambda h: fn(p, h, None), x, False)
        return self.sublayer(
            lambda h: fn(self.ssm_slice(p), h, self.norm_sum), x, True)

    def norm_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of a statistic each rank's own math
        reads (``_SumOverRanks``)."""
        return _SumOverRanks.apply(x, self.group) if self._many else x

    def ssm_slice(self, p):
        """The columns a mamba2 block computes with on this rank: of
        ``in_proj`` ``[z_r, x_r, B, C, dt_r]`` (its heads' z, x and dt, B
        and C whole) and of ``conv_w`` and ``conv_b`` ``[x_r, B, C]``.
        Under "by_rank" ``p``'s three leaves are the rank's blocks
        ``[z_r, x_r, B_r, C_r, dt_r]`` and ``[x_r, B_r, C_r]``, and B and C
        are all-gathered along ``"model"`` (``_whole_bc``); under "whole"
        they are whole along ``"model"`` and the rank takes its columns
        (their gradients zero outside them). Either way B's and C's
        gradients are this rank's heads' share. The other leaves are the
        rank's already. Over one rank, ``p`` itself."""
        if self.plan.ssm != "local" or not self._many:
            return p
        m, r, hw = self.plan.model, self.rank, self.plan.ssm_heads
        ch = p.conv_w.shape[-1]
        if self.plan.ssm_layout == "by_rank":
            xw = p.in_proj.shape[-1] - ch - hw      # x_r's width
            n = (ch - xw) // 2                      # B_r's and C_r's
            return p._replace(in_proj=self._whole_bc(p.in_proj, 2 * xw, n),
                              conv_w=self._whole_bc(p.conv_w, xw, n),
                              conv_b=self._whole_bc(p.conv_b, xw, n))
        din = p.in_proj.shape[-1] - ch - hw * m
        xw = din // m

        def cols(w, spans):
            return torch.cat([w[..., a:b] for a, b in spans], dim=-1)

        conv = [(r * xw, (r + 1) * xw), (din, ch)]
        proj = [(r * xw, (r + 1) * xw),
                (din + r * xw, din + (r + 1) * xw), (2 * din, din + ch),
                (din + ch + r * hw, din + ch + (r + 1) * hw)]
        return p._replace(in_proj=cols(p.in_proj, proj),
                          conv_w=cols(p.conv_w, conv),
                          conv_b=cols(p.conv_b, conv))

    def _whole_bc(self, w: torch.Tensor, start: int, n: int
                  ) -> torch.Tensor:
        """A rank's block ``w`` of a by-rank leaf, whose last axis holds its
        B_r and C_r (``n`` = N/m columns each) from ``start``, with B and C
        whole: the ranks' [B_r, C_r] all-gathered along ``"model"`` in one
        collective, each rank's share of their gradient summed into the
        rank that holds them (``gather_blocks``)."""
        m = self.plan.model
        bc = w[..., start:start + 2 * n].movedim(-1, 0)
        every = gather_blocks(bc, self.group, reduce_grad=True)
        every = every.reshape(m, 2, n, *bc.shape[1:])
        b, c = (every[:, i].reshape(m * n, *bc.shape[1:]).movedim(0, -1)
                for i in (0, 1))
        return torch.cat([w[..., :start], b, c, w[..., start + 2 * n:]],
                         dim=-1)

    def check(self, cfg, params: dict) -> None:
        """Raises unless the leaves, as a layer gathers them, have the
        local widths the plan says (a sharded step's leaves are
        ``sharding.Placed``, whose ``shape`` is the gathered layer's, lead
        axes kept: nothing is gathered here) (``wk`` whole unless the
        heads are "local"; a mamba2 block's
        ``in_proj`` the rank's block under "by_rank", else whole, its
        heads' leaves the rank's where local; an
        MoE layer's router whole, its expert stacks the rank's experts,
        its shared experts as the MLP; an enc-dec model's encoder and
        decoder layers, the cross-attention's as the self-attention's)."""
        p, hd, m = self.plan, cfg.hd, self.plan.model
        vocab = cfg.vocab_size // (m if p.vocab_local else 1)
        want = {"lm_head columns": (params["lm_head"].shape[-1], vocab)}
        if p.vocab_local:     # a whole table may be the rows a step reads
            want["embed rows"] = (params["embed"].shape[0], vocab)
        if cfg.family == "encdec":
            dec = params["dec_layers"]
            attn, mlp = dec.self_attn, dec.mlp
            for name, a in (("encoder", params["enc_layers"].attn),
                            ("cross", dec.cross_attn)):
                want[f"{name} wq columns"] = (a.wq.shape[-1],
                                              p.local_heads[0] * hd)
                want[f"{name} wk columns"] = (a.wk.shape[-1],
                                              dec.self_attn.wk.shape[-1])
            want["encoder w_gate columns"] = (
                params["enc_layers"].mlp.w_gate.shape[-1],
                dec.mlp.w_gate.shape[-1])
        elif cfg.family == "hybrid":
            attn, mlp = params["shared_attn"], params["shared_mlp"]
        elif cfg.family == "moe":
            moe = params["layers"].moe
            attn, mlp = params["layers"].attn, moe.shared
            want["router columns"] = (moe.router.shape[-1], cfg.n_experts)
            want["experts a rank"] = (moe.w_gate.shape[-3], p.ep_experts)
        elif p.ssm is None:
            attn, mlp = params["layers"].attn, params["layers"].mlp
        else:
            attn = mlp = None
        if attn is not None:
            want["wq columns"] = (attn.wq.shape[-1], p.local_heads[0] * hd)
            want["wk columns"] = (attn.wk.shape[-1],
                                  (p.local_heads[1] if p.heads == "local"
                                   else cfg.n_kv_heads) * hd)
        if mlp is not None:
            ff = cfg.d_ff * (cfg.n_shared_experts if cfg.family == "moe"
                             else 1)
            want["w_gate columns"] = (mlp.w_gate.shape[-1],
                                      ff // (m if p.mlp_local else 1))
        if p.ssm is not None:
            mamba = params["layers"].mamba
            want["A_log heads"] = (mamba.A_log.shape[-1], p.ssm_heads)
            want["out_proj rows"] = (mamba.out_proj.shape[-2],
                                     p.ssm_heads * cfg.ssm_head_dim)
            want["in_proj columns"] = (
                mamba.in_proj.shape[-1], (2 * cfg.d_inner
                                          + 2 * cfg.ssm_state + cfg.ssm_heads)
                // (m if p.ssm_layout == "by_rank" else 1))
        bad = {k: v for k, v in want.items() if v[0] != v[1]}
        if bad:
            raise ValueError(f"leaves not laid out as {p}: {bad}")


def route(cfg, *, kind: str, seq_len: int, rows: int | None = None,
          cache_len: int | None = None) -> Route | None:
    """The installed policy's route for a ``kind`` step of ``cfg`` (its
    ``"model"`` group's size is m) on ``rows`` rows a data rank, against a
    KV cache of ``cache_len`` positions (``plan``'s), or None: no policy,
    a mesh without a ``"model"`` axis, or a family that computes whole."""
    group = logical.model_group()
    if not computes_tp(cfg) or group is None:
        return None
    mesh = logical.current_mesh()
    ep = mesh.size() if cfg.family == "moe" else None
    return Route(plan(cfg, group.size(), kind=kind, seq_len=seq_len, ep=ep,
                      rows=rows, cache_len=cache_len), group, mesh)
