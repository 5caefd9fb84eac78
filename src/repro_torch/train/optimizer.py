"""Hand-written optimizers (counterpart of ``repro/train/optimizer.py``).

AdamW with a configurable moment dtype, and Adafactor (factored second
moment, optional bf16 momentum). The update rules are the reference's,
line for line, not ``torch.optim``'s: global-norm clipping with the scale
cast to the gradient's dtype, the step count from ``state["step"] + 1``,
bias correction as ``b ** step`` in fp32, decoupled weight decay on every
leaf with ``ndim >= 2``. The leaves are the reference's: per-layer weights
stacked on axis 0, so the (L, d) RMSNorm weights are decayed and
Adafactor factors them over (layers, d) exactly as the reference does.

XLA fuses the reference's update of each leaf; here a stacked leaf
(``ndim >= 3``) is updated, and its share of the global norm summed, a
slice of axis 0 at a time, so no fp32 temporary is larger than one
layer's slice of a leaf (kimi-k2-1t-a32b's expert stacks are 3.6 GB a
rank in bf16), and the clip's scale is applied to each slice where the
update reads it. The arithmetic is the reference's; only sums over a
whole leaf (the norm, Adafactor's means and update RMS) add in another
order. Under DTensor (the sharded train step) both optimizers compute on
each leaf's local blocks by plain ops (``_blocks``), and a sum over a
sharded axis of a leaf is a partial sum reduced across the ranks once a
leaf (``_summed``; the norm once a step).

Unlike the reference's pure functions, ``update`` writes the new params
and optimizer state IN PLACE, under ``torch.no_grad()``, and returns the
same objects: no second copy of params and moments. The step count too is
a device tensor advanced in place, so a captured step
(``repro_torch.graphs``) reads and writes the same one at every replay.
"""
from __future__ import annotations

import functools
import math
import operator
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.models.common import tree_leaves, tree_map


class Schedule:
    """Linear warmup + cosine decay."""

    def __init__(self, peak_lr: float, warmup: int = 100,
                 total: int = 10_000, floor: float = 0.1) -> None:
        self.peak_lr, self.warmup, self.total, self.floor = \
            peak_lr, warmup, total, floor

    def __call__(self, step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = step / max(1.0, self.warmup)
        prog = torch.clamp((step - self.warmup) /
                           max(1.0, self.total - self.warmup), 0.0, 1.0)
        cos = self.floor + (1 - self.floor) * 0.5 * (1 + torch.cos(
            math.pi * prog))
        return self.peak_lr * torch.clamp(warm, max=1.0) * cos


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"               # adamw | adafactor
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32   # bf16 halves optimizer memory
    # adafactor
    factored_threshold: int = 2       # factor 2nd moment for ndim >= this
    momentum: bool = False            # adafactor w/ bf16 momentum if True


class Optimizer(NamedTuple):
    init: Callable                     # params -> state
    # (grads, state, params, grad_norm) -> (params, state); grad_norm:
    # ``global_norm(grads)``, which the train step also reports
    update: Callable


def _slices(leaf: torch.Tensor, t: torch.Tensor) -> tuple:
    """``t`` (``leaf`` or a tensor of its optimizer state, stacked as it
    is, or their local blocks) as the slices the update and the norm hold
    fp32 temporaries of: its slices of axis 0 where ``leaf`` is a stack
    (``ndim >= 3``: a layer each, or a hybrid's group; axis 0 is whole on
    every rank under DTensor), else ``t`` whole."""
    return t.unbind(0) if leaf.ndim >= 3 else (t,)


def _join(leaf: torch.Tensor, parts: list) -> torch.Tensor:
    """The inverse of ``_slices``: ``parts`` stacked on axis 0 where
    ``leaf`` is a stack, else its one part."""
    return torch.stack(parts) if leaf.ndim >= 3 else parts[0]


def _total(terms) -> torch.Tensor:
    """The sum of ``terms`` (0-d tensors), started from the first: under
    DTensor partial sums add up as partial sums, reduced across ranks once
    where the total is read, where ``sum`` would start from 0 and reduce
    each term."""
    return functools.reduce(operator.add, terms)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block (a replicated scalar's: its value), any
    other tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _summed(t: torch.Tensor, leaf: torch.Tensor, dims) -> torch.Tensor:
    """``t``, a sum over the axes ``dims`` of ``leaf``'s local block (kept
    as axes of size 1, or all of them to a 0-d tensor), summed over the
    ranks whose blocks of ``leaf`` part along those axes: one reduce per
    call, none where no mesh dim shards them. The result is laid out as
    ``leaf``'s block along the other axes. Off DTensor, ``t`` itself."""
    if not isinstance(leaf, DTensor):
        return t
    dims = {d % leaf.ndim for d in dims}
    summed = [p.is_shard() and p.dim in dims for p in leaf.placements]
    if not any(summed):
        return t
    mesh = leaf.device_mesh
    out = [Replicate() if s else p
           for s, p in zip(summed, leaf.placements)]
    return DTensor.from_local(
        t, mesh, [Partial() if s else p for s, p in zip(summed, out)]
    ).redistribute(mesh, out).to_local()


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """``x``'s fp32 sum of squares, a slice at a time (``_slices``); a
    DTensor's over its local block, as a partial sum over the mesh dims
    that shard it (reduced where the total is read, ``global_norm``)."""
    if isinstance(x, DTensor):
        if any(p.is_partial() for p in x.placements):
            raise ValueError("the norm of a DTensor with partial "
                             f"placements {x.placements}")
        return DTensor.from_local(
            _sum_squares(x.to_local()), x.device_mesh,
            [Partial() if p.is_shard() else p for p in x.placements])
    return _total(torch.sum(torch.square(part.float()))
                  for part in _slices(x, x))


def global_norm(tree) -> torch.Tensor:
    """The fp32 norm over every leaf of ``tree``: each slice's fp32
    squares summed (``_sum_squares``), so no fp32 copy of a whole stack is
    made; the reference's arithmetic, the summation in slices."""
    return torch.sqrt(_total(_sum_squares(x) for x in tree_leaves(tree)))


def _blocks(p: torch.Tensor, g: torch.Tensor, *state) -> tuple:
    """A leaf, its gradient and its optimizer state as the local blocks the
    update computes on by plain ops (a DTensor op costs the host hundreds
    of microseconds, and an update takes a dozen a slice): the gradient
    first brought to the leaf's placements where it came in others. The
    state is laid out from the leaf's specs (``sharding.train_state_specs``),
    so its blocks are the leaf's blocks' (Adafactor's statistics: less the
    axis each drops)."""
    if isinstance(p, DTensor) and g.placements != p.placements:
        g = g.redistribute(p.device_mesh, p.placements)
    return tuple(_local(t) for t in (p, g, *state))


def _clipper(grad_norm: torch.Tensor, max_norm: float) -> Callable:
    """The global-norm clip as a function of one slice of a gradient's
    local block: the slice times the clip's scale cast to its dtype, as the
    reference scales each leaf, where the update reads it (no clipped copy
    of the gradients is held)."""
    scale = _local(torch.clamp(
        max_norm / torch.clamp(grad_norm, min=1e-6), max=1.0))
    cast: dict = {}

    def clip(x: torch.Tensor) -> torch.Tensor:
        if x.dtype not in cast:
            cast[x.dtype] = scale.to(x.dtype)
        return x * cast[x.dtype]
    return clip


# ---------------------------------------------------------------------------
def adamw(cfg: OptimizerConfig) -> Optimizer:
    sched = Schedule(cfg.peak_lr, cfg.warmup, cfg.total_steps)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype,
                                      device=p.device)
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": step}

    @torch.no_grad()
    def update(grads, state, params, grad_norm):
        clip = _clipper(grad_norm, cfg.grad_clip)
        step = state["step"].add_(1)
        lr = _local(sched(step))
        b1, b2 = cfg.b1, cfg.b2
        bc1 = _local(1 - b1 ** step.float())
        bc2 = _local(1 - b2 ** step.float())

        def upd(p, g, m, v, decay: bool):
            g32 = clip(g).float()
            m32 = b1 * m.float() + (1 - b1) * g32
            v32 = b2 * v.float() + (1 - b2) * g32 * g32
            mhat = m32 / bc1
            vhat = v32 / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps)
            if decay:
                delta = delta + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m32)
            v.copy_(v32)

        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            # decoupled weight decay on matrices only (the leaf's ndim); a
            # stacked leaf is updated a slice of axis 0 at a time, the same
            # elementwise arithmetic with fp32 temporaries of one layer's
            # (or group's) size instead of the whole stack's
            for part in zip(*(_slices(p, t) for t in _blocks(p, g, m, v))):
                upd(*part, p.ndim >= 2)
        return params, state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
def adafactor(cfg: OptimizerConfig) -> Optimizer:
    """Factored 2nd moment (row/col RMS) for >=2D params; optional bf16
    momentum."""
    sched = Schedule(cfg.peak_lr, cfg.warmup, cfg.total_steps)

    def _factored(p) -> bool:
        return p.ndim >= cfg.factored_threshold

    def init(params):
        def slot(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if _factored(p):
                return {"row": z(p.shape[:-1]),
                        "col": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        # one slot dict per param, in tree_leaves order
        state = {"v": [slot(p) for p in tree_leaves(params)],
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=tree_leaves(params)[0].device)}
        if cfg.momentum:
            state["m"] = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.bfloat16, device=p.device), params)
        return state

    @torch.no_grad()
    def update(grads, state, params, grad_norm):
        clip = _clipper(grad_norm, cfg.grad_clip)
        step = state["step"].add_(1)
        lr = _local(sched(step))
        decay = _local(1.0 - step.float() ** -0.8)     # t^-0.8 schedule

        def squared(g):
            g32 = clip(g).float()
            return g32 * g32 + 1e-30

        def statistics(leaf, g, v, row_like):
            """Pass 1: the new second-moment statistics, written, and the
            factored statistics' row mean (clamped; None unfactored). The
            means over a factored axis are sums a slice at a time, each
            reduced across the ranks that shard that axis once a leaf
            (``_summed``; ``row_like``: the row statistic as placed); per
            slice for a stack: row drops the last axis, rmean is over
            row's."""
            if "v" in v:
                for gs, vs in zip(_slices(leaf, g), _slices(leaf, v["v"])):
                    vs.copy_(decay * vs + (1 - decay) * squared(gs))
                return None
            n, last, rows = leaf.ndim, leaf.shape[-1], leaf.shape[-2]
            sums = [(s.sum(-1, keepdim=True), s.sum(-2, keepdim=True))
                    for s in map(squared, _slices(leaf, g))]
            row, col = (_summed(_join(leaf, list(t)), leaf, (axis,))
                        for t, axis in zip(zip(*sums), (n - 1, n - 2)))
            v["row"].copy_(decay * v["row"]
                           + (1 - decay) * (row / last).squeeze(-1))
            v["col"].copy_(decay * v["col"]
                           + (1 - decay) * (col / rows).squeeze(-2))
            rsum = _summed(v["row"].sum(-1, keepdim=True), row_like, (-1,))
            return torch.clamp(rsum / rows, min=1e-30)

        def unclipped(gs, vs):
            """A slice's update before the RMS clip, from its gradient and
            its statistics' slices: (v,), or (row, col, rmean)."""
            vhat = (vs[0] if len(vs) == 1 else
                    vs[0][..., None] * vs[1][..., None, :] / vs[2][..., None])
            return clip(gs).float() / torch.sqrt(vhat + cfg.eps)

        def upd(leaf, g, v, m):
            # on the leaf's local blocks (``_blocks``), a stacked leaf a
            # slice of axis 0 at a time: pass 1 writes the statistics
            # (``statistics``), pass 2 sums the update's squares for the
            # update clipping's RMS over the whole leaf (reduced across
            # ranks once), pass 3 recomputes each slice's update and
            # applies it
            p, g, m, *stats = _blocks(leaf, g, m, *v.values())
            rmean = statistics(leaf, g, dict(zip(v, stats)), v.get("row"))
            v = dict(zip(v, stats))
            vs = ((v["v"],) if rmean is None else
                  (v["row"], v["col"], rmean))
            parts = list(zip(_slices(leaf, g), zip(
                *(_slices(leaf, t) for t in vs))))
            squares = _total(torch.sum(torch.square(unclipped(*part)))
                             for part in parts)
            # update clipping (Adafactor's RMS rule)
            rms = torch.sqrt(_summed(squares, leaf, range(leaf.ndim))
                             / leaf.numel() + 1e-30)
            ms = _slices(leaf, m) if m is not None else [None] * len(parts)
            for ps, part, mm in zip(_slices(leaf, p), parts, ms):
                upd_s = unclipped(*part) / torch.clamp(rms, min=1.0)
                if mm is not None:
                    upd_s = 0.9 * mm.float() + 0.1 * upd_s
                    mm.copy_(upd_s)
                if leaf.ndim >= 2:
                    upd_s = upd_s + cfg.weight_decay * ps.float()
                ps.copy_(ps.float() - lr * upd_s)

        leaves_p = tree_leaves(params)
        ms = tree_leaves(state["m"]) if "m" in state else [None] * len(leaves_p)
        for p, g, v, m in zip(leaves_p, tree_leaves(grads), state["v"], ms):
            upd(p, g, v, m)
        return params, state

    return Optimizer(init, update)


def build_optimizer(cfg: OptimizerConfig) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor}[cfg.name](cfg)
