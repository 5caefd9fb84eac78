"""Generic train-step builder (counterpart of ``repro/train/train_step.py``):
loss and gradients by autograd + optimizer + microbatch gradient
accumulation + optional gradient compression hook.

The returned step is (state, batch) -> (state, metrics). It updates the
params and optimizer state in place (see ``optimizer.py``) and returns the
same state dict; the metrics are 0-d fp32 tensors on the params' device.
``make_training`` compiles it, as the reference jits it: on the card a
CUDA graph (``repro_torch.graphs``) over a state it owns and static batch
buffers.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.graphs import CompiledStep
from repro_torch.models.common import tree_leaves, tree_map

from .optimizer import (Optimizer, OptimizerConfig, build_optimizer,
                        global_norm)


def init_train_state(model, opt: Optimizer, generator: torch.Generator
                     ) -> dict:
    params = model.init(generator)
    return {"params": params, "opt": opt.init(params)}


def value_and_grad(loss_fn, params, batch):
    """(loss, grads in the params' structure and dtype). A leaf the loss
    does not use (vlm's ``patch_proj`` on a text-only batch) gets zeros,
    as ``jax.value_and_grad`` gives."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = (torch.zeros_like(p) if g is None else g
          for p, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda _: next(it), params)


def build_train_step(model, opt: Optimizer, *, grad_accum: int = 1,
                     compress=None) -> Callable:
    """``compress``: optional (grads, residual) -> (grads, residual) hook,
    the residual carried in ``state["compress_residual"]``."""

    def step(state: dict, batch: dict):
        params = state["params"]
        if grad_accum == 1:
            # gradients in the params' dtype, as jax.value_and_grad gives
            loss, grads = value_and_grad(model.loss_fn, params, batch)
        else:
            # microbatches along axis 0, gradients summed in fp32
            micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            # zeros like each leaf: a DTensor's keep its placements
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            for i in range(grad_accum):
                mb = {k: v[i] for k, v in micro.items()}
                l, g = value_and_grad(model.loss_fn, params, mb)
                loss = loss + l
                tree_map(lambda a, b: a.add_(b.float()), grads, g)
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)

        if compress is not None:
            grads, new_resid = compress(grads, state.get("compress_residual"))
        # the norm a slice of a stack at a time, computed once for the
        # metric and the optimizer's clip (the reference computes the same
        # value twice)
        gnorm = global_norm(grads)
        new_params, new_opt = opt.update(grads, state["opt"], params,
                                         grad_norm=gnorm)
        new_state = {"params": new_params, "opt": new_opt}
        if compress is not None:
            new_state["compress_residual"] = new_resid
        return new_state, {"loss": loss.float(), "grad_norm": gnorm}

    return step


def _in_place(step: Callable, state: dict, batch: dict):
    """``step`` with every state leaf it returns anew (a compress hook's
    residual) copied into the leaf it replaces, so the state's tensors
    stay the same from step to step; the first step adds the leaves the
    state lacks."""
    new, metrics = step(state, batch)
    for key, tree in new.items():
        if key not in state:
            state[key] = tree
            continue
        for old, leaf in zip(tree_leaves(state[key]), tree_leaves(tree)):
            if leaf is not old:
                old.copy_(leaf)
    return state, metrics


class TrainStep:
    """The compiled train step ``make_training`` returns: (state, batch)
    -> (state, metrics), as ``build_train_step``'s step, over the
    ``state`` it owns (the reference donates it) and static batch
    buffers, which each call fills by ``copy_`` from its batch. Forward,
    backward, the optimizer's update and every microbatch are one graph
    on the card."""

    def __init__(self, model, opt: Optimizer, state: dict, **step_kw):
        self.state = state
        self.batch: dict | None = None
        self.device = model.device
        self.compiled = CompiledStep(functools.partial(
            _in_place, build_train_step(model, opt, **step_kw)), self.device)

    def __call__(self, state: dict, batch: dict):
        if state is not self.state:
            raise ValueError("the compiled step owns its state: pass the "
                             "state make_training returned (load() copies "
                             "another into it)")
        self._fill(batch)
        return self.compiled(self.state, self.batch)

    def _fill(self, batch: dict) -> None:
        """``batch`` into the static buffers, made like it at the first
        call; raises on other keys, shapes or dtypes."""
        if self.batch is None:
            self.batch = {k: torch.empty(v.shape, dtype=v.dtype,
                                         device=self.device)
                          for k, v in batch.items()}
        if _spec(batch) != _spec(self.batch):
            raise ValueError(f"batch {_spec(batch)}: the step's buffers are "
                             f"{_spec(self.batch)}")
        for k, v in batch.items():
            self.batch[k].copy_(v, non_blocking=True)

    def load(self, state: dict) -> None:
        """Copies ``state``'s leaves (a checkpoint, an op's initial params
        and a fresh optimizer state) into the owned state, which must have
        the same structure, shapes and dtypes."""
        mine, theirs = tree_leaves(self.state), tree_leaves(state)
        if len(mine) != len(theirs) or any(
                a.shape != b.shape or a.dtype != b.dtype
                for a, b in zip(mine, theirs)):
            raise ValueError("the state to load differs from the owned one "
                             "in structure, shape or dtype")
        with torch.no_grad():
            for a, b in zip(mine, theirs):
                a.copy_(b)


def _spec(batch: dict) -> dict:
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in sorted(
        batch.items())}


def make_training(model, opt_cfg: OptimizerConfig | None = None,
                  generator: torch.Generator | None = None, **step_kw):
    """(state, compiled step), the counterpart of the reference's
    ``make_training``: the state drawn from ``generator`` (seed 0 on the
    model's device by default), the step a ``TrainStep`` that owns it."""
    opt = build_optimizer(opt_cfg or OptimizerConfig())
    state = init_train_state(model, opt, generator or torch.Generator(
        device=model.device).manual_seed(0))
    return state, TrainStep(model, opt, state, **step_kw)
