"""Cell builders (counterpart of ``repro/launch/build.py``): (architecture
x shape x mesh) -> the step one rank runs and its inputs, placed on the
mesh by the port's sharding specs.

On ``device="meta"`` (the dry run) the params' shapes come from
``model.init`` under ``FakeTensorMode`` (no draws: the counterpart of
``jax.eval_shape(model.init, key)``) and every input is an empty ``meta``
tensor; on ``"cuda"`` each rank draws its block of each param from
``seed``, a matrix at a time (``model.init`` under
``common.deferred_draws``), and the inputs are the card's. Either way the
params are placed through ``sharding.place_state``, so a mamba2 block's
``in_proj``, ``conv_w`` and ``conv_b`` are in the by-rank column order
where the plan stores them so (a drawn matrix's columns taken in that
order). Importing this module starts no process group.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import (SHAPES, ShapeCell, cell_inputs,
                                 cell_runnable, get_config)
from repro_torch.distributed import logical
from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel
from repro_torch.models.common import (ArchConfig, Deferred, deferred_draws,
                                      tree_leaves, tree_map)
from repro_torch.models.transformer import build_model
from repro_torch.train.optimizer import OptimizerConfig, build_optimizer
from repro_torch.train.train_step import build_train_step

from .mesh import data_axes

#: momentum-light optimizer for the HBM-bound giants (see DESIGN.md)
OPT_FOR_ARCH = {
    "kimi-k2-1t-a32b": OptimizerConfig(name="adafactor", momentum=False),
    "llava-next-34b": OptimizerConfig(name="adamw",
                                      moment_dtype=torch.bfloat16),
}


def active_params(cfg: ArchConfig) -> float:
    """Per-token active parameter count (MoE: top_k + shared experts)."""
    d, hd = cfg.d_model, cfg.hd
    attn = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    if cfg.family == "moe":
        ffn = 3 * d * cfg.d_ff * (cfg.top_k + cfg.n_shared_experts)
        ffn += d * cfg.n_experts                    # router
    elif cfg.family == "ssm":
        attn = 0
        din = cfg.d_inner
        ffn = d * (2 * din + 2 * cfg.ssm_state + cfg.ssm_heads) + din * d
    elif cfg.family == "hybrid":
        din = cfg.d_inner
        mamba = d * (2 * din + 2 * cfg.ssm_state + cfg.ssm_heads) + din * d
        shared = (attn + 3 * d * cfg.d_ff) / cfg.attn_every  # amortized
        return cfg.n_layers * (mamba + shared) + 2 * cfg.vocab_size * d
    else:
        ffn = 3 * d * cfg.d_ff
    layers = cfg.n_layers + cfg.n_enc_layers
    return layers * (attn + ffn) + 2 * cfg.vocab_size * d


def shared_memory_kernel_bytes(cfg: ArchConfig, kind: str, B: int,
                               S: int) -> float:
    """HBM bytes that the port's kernels keep in shared memory and
    registers on the card, which the plain route of the ``meta`` device
    writes out (score/prob blocks of the chunked attention; SSD
    intra-chunk decay/CB matrices): the reference's ``vmem_kernel_bytes``
    (its Pallas kernels keep them in VMEM), the same formula. Subtracting
    this from the counted traffic gives the kernel-adjusted memory term.

    Accounting: attention fwd materializes scores+probs (2 fp32 tensors);
    backward recomputes them and forms dP (3 more) -> ~5 x B*Hq*Tq*Tk*4 per
    layer for train, 2 x for inference. SSD analogous on (nc, H+1, Q, Q).
    """
    total = 0.0
    mult = 5.0 if kind == "train" else 2.0
    if cfg.n_heads:
        layers = cfg.n_layers + cfg.n_enc_layers
        if cfg.family == "hybrid":
            layers = cfg.n_layers // cfg.attn_every
        if cfg.family == "encdec":
            total = mult * 4.0 * B * cfg.n_heads * (
                cfg.n_layers * (S * S + S * cfg.enc_len)
                + cfg.n_enc_layers * cfg.enc_len * cfg.enc_len)
        else:
            seq = S + (cfg.n_patches if cfg.family == "vlm" else 0)
            total = mult * 4.0 * B * cfg.n_heads * layers * seq * seq
    if cfg.family in ("ssm", "hybrid"):
        Q = cfg.ssm_chunk
        nc = max(1, S // Q)
        total += mult * 4.0 * B * cfg.n_layers * nc * Q * Q * (
            cfg.ssm_heads + 1)
    if kind == "decode":
        total = 0.0     # decode kernels stream the cache; nothing to adjust
    return total


def min_step_bytes(kind: str, *, param_bytes: float, cache_bytes: float,
                   tokens: float, d_model: int, n_layers: int) -> float:
    """Minimum HBM traffic per step (the memory-roofline floor):
      train   : params fwd-read + bwd-read + grad write + opt update r/w
                (~5x params) + per-layer activation in/out (fwd+bwd)
      prefill : params read + KV-cache write + activations
      decode  : params read (every step reads all weights) + cache read
    """
    act = 4.0 * tokens * d_model * n_layers * 2.0    # bf16 in+out, fwd+bwd
    if kind == "train":
        return 5.0 * param_bytes + act
    if kind == "prefill":
        return param_bytes + cache_bytes + act / 2.0
    return param_bytes + cache_bytes


@dataclass
class Cell:
    arch: str
    shape: str
    cfg: ArchConfig
    kind: str
    step: Callable              # this rank's step: step(*args)
    args: tuple                 # its inputs, placed on the mesh
    semantic: Callable          # () -> (fn, args): the unsharded step at
    #                             the global shape, on the meta device
    tokens_processed: float     # per step (for MODEL_FLOPS)
    n_active: float
    min_bytes: float = 0.0      # HBM-traffic floor (roofline denominator)
    grad_accum: int = 1
    rows: int = 0               # this rank's rows of the global batch
    chips: int = 1              # ranks of the mesh
    tp: dict | None = None      # the tensor-parallel plan's record (the
    #                             families of TP_FAMILIES), else None:
    #                             computed whole
    cache_bytes: float = 0.0    # a serve cell's whole cache (0 in train)

    def rank_cache_bytes(self) -> float:
        """The bytes of this rank's block of a serve cell's cache (its
        placed args' third), 0 for a train cell."""
        if self.kind == "train":
            return 0.0
        return _tree_bytes(tree_map(lambda t: t.to_local(), self.args[2]))


def _tree_bytes(tree) -> float:
    return float(sum(t.numel() * t.element_size()
                     for t in tree_leaves(tree)))


def param_shapes(cfg: ArchConfig) -> dict:
    """``model.init``'s tree as empty ``meta`` tensors: the init runs under
    ``FakeTensorMode``, so no number is drawn and nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    model = build_model(cfg, device="meta")
    with FakeTensorMode():
        fake = model.init(torch.Generator().manual_seed(0))
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), fake)


def _local_block(t: torch.Tensor, s) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` under ``s`` (a
    ``NamedSharding``), a copy of its own where it is not all of ``t``."""
    local = shd.local_shard(s.mesh, t, s.placements)
    return local.clone() if local.numel() != t.numel() else local


def _place(tree, shardings):
    """Each leaf (``meta`` tensors of the whole leaves) as a DTensor
    holding this rank's block of it: ``sharding.place`` without its
    scatter from rank 0."""
    return tree_map(lambda t, s: DTensor.from_local(
        _local_block(t, s), s.mesh, list(s.placements), shape=t.shape,
        stride=t.stride()), tree, shardings)


def _span(mesh, shape, placements) -> list[list[int]]:
    """This rank's block of a leaf of ``shape`` under ``placements``, as
    [start, stop) per dim (even shards, cut major to minor as
    ``sharding.local_shard`` cuts them)."""
    span = [[0, n] for n in shape]
    for j, p in enumerate(placements):
        if isinstance(p, Shard):
            a, b = span[p.dim]
            n = (b - a) // mesh.size(j)
            a += mesh.get_local_rank(j) * n
            span[p.dim] = [a, a + n]
    return span


def drawn_params(cfg: ArchConfig, device, seed: int) -> dict:
    """``model.init`` of ``cfg`` from ``seed`` under ``deferred_draws``:
    the matrices and embeddings as ``Deferred`` leaves, drawn a matrix at a
    time where a block of them is asked for, the other leaves whole. The
    experts unpadded: the padding's blocks are zeros."""
    with deferred_draws(seed):
        return build_model(replace(cfg, moe_pad_experts=0),
                           device=device).init(
            torch.Generator(device=device).manual_seed(seed))


def _drawn_placed(shapes, drawn, shardings) -> dict:
    """The params (``shapes``: their whole shapes as ``meta`` tensors;
    ``drawn``: ``drawn_params``) as DTensors holding this rank's block:
    no matrix outside it is drawn (kimi-k2-1t-a32b's routed experts are
    2.06 TB whole, a rank's block of its padded stacks 10.7 GB)."""
    def block(t, d, s):
        local = (d.block(_span(s.mesh, t.shape, s.placements))
                 if isinstance(d, Deferred) else _local_block(d, s))
        return DTensor.from_local(local, s.mesh, list(s.placements),
                                  shape=t.shape, stride=t.stride())
    return tree_map(block, shapes, drawn, shardings)


def _zeros_placed(tree, shardings, device) -> dict:
    """Each leaf of ``tree`` (``meta`` tensors of a state whose leaves
    start at zero: a fresh cache, a fresh optimizer state) as a DTensor
    whose block on this rank is zeros on ``device``: the whole leaf is
    never allocated (a decode cell's cache is over a TB whole)."""
    def block(t, s):
        shape = shd.local_shard(s.mesh, t, s.placements).shape
        return DTensor.from_local(
            torch.zeros(shape, dtype=t.dtype, device=device), s.mesh,
            list(s.placements), shape=t.shape, stride=t.stride())
    return tree_map(block, tree, shardings)


def _local(t: DTensor, want: list) -> torch.Tensor:
    """``t``'s local tensor in the placements ``want``."""
    if shd.same_layout(t.device_mesh, t.placements, want):
        return t.to_local()
    return t.redistribute(t.device_mesh, want).to_local()


def _put_back(local: torch.Tensor, t: DTensor, have: list) -> DTensor:
    """``local``, laid out by ``have``, as a DTensor in ``t``'s placements."""
    mesh = t.device_mesh
    if shd.same_layout(mesh, have, t.placements):
        return DTensor.from_local(local, mesh, t.placements, shape=t.shape,
                                  stride=t.stride())
    return DTensor.from_local(local, mesh, have).redistribute(
        mesh, t.placements)


def _read_rows(table: DTensor, tokens: DTensor) -> tuple[torch.Tensor,
                                                          torch.Tensor]:
    """A decode step's embedding lookup without gathering the table: for a
    ``table`` whole along the vocab and sharded on its columns (whisper's
    51865 rows, which "model" does not divide, under FSDP), the rows the
    step's ``tokens`` read on every batch rank, whole, and this rank's
    tokens as indices into them. The tokens are all-gathered over the
    batch ranks, each rank looks its columns up, and the lookups are
    all-gathered: a (tokens, d) block where the table would be (V, d). The
    lookup reads the same values, so its output is the same bits."""
    mesh = table.device_mesh
    every = tokens.full_tensor()                            # (B, T)
    mine = shd.local_shard(mesh, torch.arange(
        every.numel(), device=every.device).reshape(every.shape),
        tokens.placements)
    cols = torch.nn.functional.embedding(every.reshape(-1).long(),
                                         table.to_local())
    rows = DTensor.from_local(cols, mesh, table.placements).full_tensor()
    return rows, mine.to(tokens.dtype)


def _read_by_rows(table: DTensor) -> bool:
    """Whether ``_read_rows`` applies: the table sharded on its columns
    alone (not along the vocab)."""
    return (any(p == Shard(1) for p in table.placements)
            and all(p in (Shard(1), Replicate()) for p in table.placements))


def serve_step(model, mesh, kind: str) -> Callable:
    """The prefill or decode step one rank runs on placed params, inputs
    and cache: this rank's rows of the inputs and cache, then the model's
    own ``prefill`` or ``decode`` on the params as ``sharding.Placed``
    leaves, each layer's gathered along the data axes when that layer
    runs and dropped when it ends (``sharding.gather_layer``), the leaves
    outside the stacks where they are used; the cache comes back in its
    placements. Returns (this rank's logits, cache).

    The dense, vlm, ssm, hybrid, enc-dec and expert-parallel MoE families
    compute tensor-parallel along ``"model"`` (``tensor_parallel``), with
    the logical policy installed around the model's step: each leaf in its
    ``sharding.tp_layouts`` (a decode step's whole-vocab embedding table
    but the rows its tokens read, ``_read_rows``)
    placements; the cache's layout follows the decode plan for the cache's
    positions S (``sharding.tp_cache``'s), whichever step runs: the KV
    cache kept local along ``"model"`` where that plan's heads are
    "local" or "kv_replicated" (its KV heads are sharded there) or
    "kv_seq" (its positions are; the model gets S as ``cache_len``, so a
    prefill writes the rank's positions and a decode step merges the
    ranks' partials), else gathered (a "q_seq" or "gathered" prefill then
    writes every row); an enc-dec model's cross K/V kept in their
    placements (the rank's heads, or whole along ``"model"``); the SSM state
    and conv tail kept local where the SSM heads are (the tail in
    ``tp_cache``'s layout), else gathered; the logits are this rank's
    vocab columns where the vocab is local, as the reference's
    ``out_shardings`` (``P(batch, None, "model")``) leave them; an MoE
    layer's routed experts by expert parallelism over every rank, on each
    rank's block of its rows' tokens (``Route.moe``), which needs the
    batch split over the batch ranks. A grouped-dispatch MoE gathers each
    layer's leaves and the cache whole along ``"model"`` and runs with no
    policy installed (its layers by ``moe_block``'s grouped dispatch, one
    group a rank)."""
    baxes = data_axes(mesh)
    names = mesh.mesh_dim_names
    full = [Replicate()] * mesh.ndim
    plan = tensor_parallel.mesh_plan(model.cfg, mesh, kind=kind, seq_len=1)
    layouts = None if plan is None else shd.tp_layouts(model.cfg, mesh, plan)

    def rows(t: DTensor) -> list:
        return [p if names[j] in baxes else Replicate()
                for j, p in enumerate(t.placements)]

    def run(local, mine, held, cache_len=None):
        kw = {} if cache_len is None else {"cache_len": cache_len}
        if kind == "decode":
            return model.decode(local, mine["tokens"], held, **kw)
        return model.prefill(local, mine, held, **kw)

    def step(params, inputs: dict, cache: dict):
        if plan is not None and plan.ep is not None:
            for k, v in inputs.items():
                if any(not isinstance(p, Shard) and mesh.size(j) > 1
                       for j, p in enumerate(v.placements)
                       if names[j] in baxes):
                    raise ValueError(f"input {k}: expert parallelism needs "
                                     f"the batch split over {baxes}")
        mine = {k: _local(v, rows(v)) for k, v in inputs.items()}
        # the cache leaves kept in their placements along "model": the
        # decode plan's for the cache's positions
        cache_len = cache["k"].shape[2] if "k" in cache else None
        kv = None if plan is None else tensor_parallel.mesh_plan(
            model.cfg, mesh, kind="decode", seq_len=1, cache_len=cache_len)
        keep = {"k": kv is not None and (kv.heads_local
                                         or kv.cache_len is not None),
                "state": plan is not None and plan.ssm == "local",
                "cross_k": plan is not None}
        keep["v"], keep["cross_v"] = keep["k"], keep["cross_k"]
        have = {k: tree_map(lambda t: list(t.placements) if keep.get(k)
                            else rows(t), v) for k, v in cache.items()}
        held = tree_map(_local, cache, have)
        if plan is None:
            logits, held = run(tree_map(
                lambda t: shd.Placed.of(t, full), params), mine, held)
        else:
            rows_read = kind == "decode" and _read_by_rows(params["embed"])
            placed = {k: tree_map(lambda t, lay: shd.Placed.of(t, lay[0]),
                                  v, layouts[k])
                      for k, v in params.items()
                      if not (rows_read and k == "embed")}
            if rows_read:
                placed["embed"], mine["tokens"] = _read_rows(
                    params["embed"], inputs["tokens"])
            with logical.policy(mesh):
                logits, held = run(placed, mine, held, cache_len)
        return logits, tree_map(_put_back, held, cache, have)

    return step


def _draw_inputs(cfg: ArchConfig, kind: str, B: int, S: int, device,
                 seed: int) -> dict:
    """The cell's inputs on a real device: uniform tokens and labels,
    N(0, 1) frames and patch embeddings, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    out = {}
    for k, t in cell_inputs(cfg, kind, B, S).items():
        if t.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                                   device=device, dtype=torch.int32)
        else:
            out[k] = torch.randn(t.shape, generator=gen, device=device,
                                 dtype=t.dtype)
    return out


def resolve_shape(shape_id: str | ShapeCell) -> ShapeCell:
    return shape_id if isinstance(shape_id, ShapeCell) else SHAPES[shape_id]


def build_cell(arch: str, shape_id: str | ShapeCell, mesh, *,
               grad_accum: int = 1, remat: str | None = None,
               extra_cfg: dict | None = None,
               device: str | torch.device = "meta", seed: int = 0) -> Cell:
    """The cell's step on ``mesh`` and its placed inputs. ``shape_id`` may
    be a ``ShapeCell`` of its own (a small cell for tests); ``extra_cfg``
    overrides config fields, input widths included."""
    cfg = get_config(arch)
    n_rows = math.prod(mesh.size(j) for j, a in enumerate(mesh.mesh_dim_names)
                       if a in data_axes(mesh))        # the batch shards
    if remat is not None or extra_cfg:
        over = dict(extra_cfg or {})
        if remat is not None:
            over["remat"] = remat
        cfg = replace(cfg, **over)
    # the grouped dispatch (a grouped-dispatch MoE's step, every MoE's
    # unsharded semantic step) takes one group a batch shard, as the
    # reference's; an expert-parallel step pads the experts to the world
    grouped = cfg
    if cfg.family == "moe":
        if cfg.moe_impl == "ep":
            from repro_torch.models.moe_ep import pad_experts
            cfg = replace(cfg, moe_pad_experts=pad_experts(cfg, mesh))
        grouped = replace(cfg, moe_groups=n_rows)
        if cfg.moe_impl != "ep":
            cfg = grouped
    shape = resolve_shape(shape_id)
    ok, why = cell_runnable(cfg, shape)
    if not ok:
        raise ValueError(f"cell {arch}x{shape.name} skipped: {why}")
    device = torch.device(device)
    on_meta = device.type == "meta"
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    rows = B // n_rows if B % n_rows == 0 else B

    shapes = param_shapes(cfg)
    pspecs = shd.fit_tree(mesh, shd.param_specs(cfg, mesh), shapes)
    param_bytes = _tree_bytes(shapes)
    model = build_model(cfg, device=device)

    drawn = None if on_meta else drawn_params(cfg, device, seed)

    def placed_params(shardings):
        # in the stored column order (``sharding.place_state``); on a
        # device each rank draws its block of each leaf, a matrix at a time
        # (``_drawn_placed``)
        if on_meta:
            return shd.place_state(cfg, mesh, shapes, shardings, put=_place)
        return shd.place_state(
            cfg, mesh, drawn, shardings,
            put=lambda tree, named: _drawn_placed(shapes, tree, named))
    inputs = (cell_inputs(cfg, kind, B, S) if on_meta else
              _draw_inputs(cfg, kind, B, S, device, seed))
    opt_cfg = OPT_FOR_ARCH.get(arch, OptimizerConfig())
    plan = tensor_parallel.mesh_plan(
        cfg, mesh, kind=kind, seq_len=1 if kind == "decode" else S,
        rows=rows, cache_len=None if kind == "train" else S)
    common = dict(n_active=active_params(cfg), grad_accum=grad_accum,
                  rows=rows, chips=mesh.size(),
                  tp=None if plan is None else plan.record(
                      mesh.get_local_rank("model")))

    def meta_model():
        return build_model(grouped, device="meta")

    if kind == "train":
        opt = build_optimizer(opt_cfg)
        sharded = shd.shard_train_step(model, opt, mesh,
                                       grad_accum=grad_accum)

        def step(state: dict, batch: dict):
            with logical.policy(mesh):    # activation-sharding policy
                return sharded(state, batch)

        # the optimizer's state starts at zeros: each rank allocates its
        # block of it alone (whole, llama-3.1-8b's AdamW moments would fill
        # the card), as the cache below; zeros read alike in any column
        # order
        opt_state = opt.init(shapes)
        specs = shd.to_named(mesh, shd.train_state_specs(
            {"params": shapes, "opt": opt_state}, opt_cfg.name, pspecs))
        state = {"params": placed_params(specs["params"]),
                 "opt": _zeros_placed(opt_state, specs["opt"], device)}

        def semantic():
            p = param_shapes(cfg)
            return (build_train_step(meta_model(), opt,
                                     grad_accum=grad_accum),
                    ({"params": p, "opt": opt.init(p)},
                     cell_inputs(cfg, kind, B, S)))

        return Cell(arch, shape.name, cfg, kind, step, (state, inputs),
                    semantic, tokens_processed=B * S,
                    min_bytes=min_step_bytes(
                        "train", param_bytes=param_bytes, cache_bytes=0.0,
                        tokens=B * S, d_model=cfg.d_model,
                        n_layers=cfg.n_layers + cfg.n_enc_layers),
                    **common)

    cache = meta_model().init_cache(B, S)
    cache_bytes = _tree_bytes(cache)
    cache, cspecs = shd.tp_cache(cfg, mesh, cache)
    bspecs = {k: shd.fit_spec(mesh, v, inputs[k].shape)
              for k, v in shd.batch_specs(cfg, mesh, inputs).items()}
    placed = (placed_params(shd.to_named(mesh, pspecs)),
              _place(inputs, shd.to_named(mesh, bspecs)),
              _zeros_placed(cache, shd.to_named(mesh, cspecs), device))

    def semantic():
        m = meta_model()
        fn = m.decode if kind == "decode" else m.prefill
        x = cell_inputs(cfg, kind, B, S)
        return fn, (param_shapes(cfg),
                    x["tokens"] if kind == "decode" else x,
                    m.init_cache(B, S))

    return Cell(arch, shape.name, cfg, kind, serve_step(model, mesh, kind),
                placed, semantic, cache_bytes=cache_bytes,
                tokens_processed=B * S if kind == "prefill" else B,
                min_bytes=min_step_bytes(
                    kind, param_bytes=param_bytes, cache_bytes=cache_bytes,
                    tokens=B * S if kind == "prefill" else B,
                    d_model=cfg.d_model,
                    n_layers=cfg.n_layers + cfg.n_enc_layers),
                **common)
