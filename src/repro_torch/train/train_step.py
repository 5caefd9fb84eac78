"""Generic train-step builder (counterpart of ``repro/train/train_step.py``):
loss and gradients by autograd + optimizer + microbatch gradient
accumulation + optional gradient compression hook.

The returned step is (state, batch) -> (state, metrics). It updates the
params and optimizer state in place (see ``optimizer.py``) and returns the
same state dict; the metrics are 0-d fp32 tensors on the params' device.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.common import tree_leaves, tree_map

from .optimizer import Optimizer


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
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(grad_accum):
                mb = {k: v[i] for k, v in micro.items()}
                l, g = value_and_grad(model.loss_fn, params, mb)
                loss = loss + l
                tree_map(lambda a, b: a.add_(b.float()), grads, g)
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)

        if compress is not None:
            grads, new_resid = compress(grads, state.get("compress_residual"))
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in tree_leaves(grads)))
        new_params, new_opt = opt.update(grads, state["opt"], params)
        new_state = {"params": new_params, "opt": new_opt}
        if compress is not None:
            new_state["compress_residual"] = new_resid
        return new_state, {"loss": loss.float(), "grad_norm": gnorm}

    return step
