"""Hand-written optimizers (counterpart of ``repro/train/optimizer.py``).

AdamW with a configurable moment dtype, and Adafactor (factored second
moment, optional bf16 momentum). The update rules are the reference's,
line for line, not ``torch.optim``'s: global-norm clipping with the scale
cast to the gradient's dtype, the step count from ``state["step"] + 1``,
bias correction as ``b ** step`` in fp32, decoupled weight decay on every
leaf with ``ndim >= 2``. The leaves are the reference's: per-layer weights
stacked on axis 0, so the (L, d) RMSNorm weights are decayed and
Adafactor factors them over (layers, d) exactly as the reference does.

Unlike the reference's pure functions, ``update`` writes the new params
and optimizer state IN PLACE, under ``torch.no_grad()``, and returns the
same objects: no second copy of params and moments. The step count too is
a device tensor advanced in place, so a captured step
(``repro_torch.graphs``) reads and writes the same one at every replay.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

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
    update: Callable                   # (grads, state, params) -> (params, state)


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _clip_by_global_norm(grads, max_norm: float):
    g = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-6), max=1.0)
    return tree_map(lambda x: x * scale.to(x.dtype), grads), g


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
    def update(grads, state, params):
        grads, _ = _clip_by_global_norm(grads, cfg.grad_clip)
        step = state["step"].add_(1)
        lr = sched(step)
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def upd(p, g, m, v, decay: bool):
            g32 = g.float()
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
            parts = zip(p, g, m, v) if p.ndim >= 3 else [(p, g, m, v)]
            for part in parts:
                upd(*part, decay=p.ndim >= 2)
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
    def update(grads, state, params):
        grads, _ = _clip_by_global_norm(grads, cfg.grad_clip)
        step = state["step"].add_(1)
        lr = sched(step)
        decay = 1.0 - step.float() ** -0.8     # t^-0.8 schedule

        def upd(p, g, v, m):
            g32 = g.float()
            g2 = g32 * g32 + 1e-30
            if _factored(p):
                row = decay * v["row"] + (1 - decay) * g2.mean(dim=-1)
                col = decay * v["col"] + (1 - decay) * g2.mean(dim=-2)
                rmean = row.mean(dim=-1, keepdim=True)
                vhat = (row[..., None] * col[..., None, :]
                        / torch.clamp(rmean[..., None], min=1e-30))
                v["row"].copy_(row)
                v["col"].copy_(col)
            else:
                vhat = decay * v["v"] + (1 - decay) * g2
                v["v"].copy_(vhat)
            upd32 = g32 / torch.sqrt(vhat + cfg.eps)
            # update clipping (Adafactor's RMS rule)
            rms = torch.sqrt(torch.mean(upd32 * upd32) + 1e-30)
            upd32 = upd32 / torch.clamp(rms, min=1.0)
            if m is not None:
                upd32 = 0.9 * m.float() + 0.1 * upd32
                m.copy_(upd32)
            if p.ndim >= 2:
                upd32 = upd32 + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * upd32)

        leaves_p = tree_leaves(params)
        ms = tree_leaves(state["m"]) if "m" in state else [None] * len(leaves_p)
        for p, g, v, m in zip(leaves_p, tree_leaves(grads), state["v"], ms):
            upd(p, g, v, m)
        return params, state

    return Optimizer(init, update)


def build_optimizer(cfg: OptimizerConfig) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor}[cfg.name](cfg)
