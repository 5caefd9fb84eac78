"""Model assemblies (counterpart of ``repro/models/transformer.py``).

This slice holds the dense decoder LM:

    init(generator)                 -> params
    loss_fn(params, batch)          -> scalar loss
    prefill(params, batch, cache)   -> (last_logits, cache)
    decode(params, tokens, cache)   -> (logits, cache)
    init_cache(batch, max_len)      -> cache

Per-layer leaves are stacked on axis 0, as the reference stacks them for
``lax.scan``; the trunks are Python loops over per-layer views of them, so
gradients flow back to the stacked leaves. The other families come with
their own slices.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops

from .attention import AttnParams, attention_block, init_attn
from .common import (ArchConfig, cross_entropy, dense_init, embed_init,
                     require_device, rmsnorm)
from .ffn import MLPParams, init_mlp, swiglu


class DenseLayer(NamedTuple):
    attn: AttnParams
    mlp: MLPParams
    norm1: torch.Tensor
    norm2: torch.Tensor


def unstack(layers: DenseLayer) -> list[DenseLayer]:
    """Per-layer views of the stacked (L, ...) leaves: one ``unbind`` per
    leaf, so each leaf's gradient is gathered by one node."""
    attn = [AttnParams(*w) for w in zip(*(t.unbind(0) for t in layers.attn))]
    mlp = [MLPParams(*w) for w in zip(*(t.unbind(0) for t in layers.mlp))]
    return [DenseLayer(a, m, n1, n2) for a, m, n1, n2 in
            zip(attn, mlp, layers.norm1.unbind(0), layers.norm2.unbind(0))]


class DenseLM:
    """GQA + RoPE + SwiGLU decoder-only LM.

    Weight matrices keep the reference's (in, out) layout and are applied
    as ``x @ w``. ``decode_attention`` and ``flash_attention`` are the
    attentions that decode steps and the loss call; they are the kernel
    seams unless a caller passes the plain versions to hold the kernels
    against them."""

    def __init__(self, cfg: ArchConfig, *, device: str | torch.device = "cuda",
                 decode_attention: Callable = kops.decode_attention,
                 flash_attention: Callable = kops.flash_attention):
        self.cfg = cfg
        self.device = require_device(device)
        self.decode_attention = decode_attention
        self.flash_attention = flash_attention

    def init(self, generator: torch.Generator) -> dict:
        """Seeded random weights. The draws happen on the generator's
        device in fp32, then move to the model's device and param dtype."""
        cfg, dev = self.cfg, self.device
        L = cfg.n_layers
        ones = lambda *lead: torch.ones((*lead, cfg.d_model),
                                        dtype=cfg.param_dtype, device=dev)
        embed = embed_init(generator, (cfg.vocab_size, cfg.d_model),
                           cfg.param_dtype, dev)
        layers = DenseLayer(init_attn(generator, cfg, dev, lead=(L,)),
                            init_mlp(generator, cfg.d_model, cfg.d_ff,
                                     cfg.param_dtype, dev, lead=(L,)),
                            ones(L), ones(L))
        lm_head = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                             dtype=cfg.param_dtype, device=dev)
        return {"embed": embed, "layers": layers, "final_norm": ones(),
                "lm_head": lm_head}

    # -- shared trunk -------------------------------------------------------
    def _layer(self, x: torch.Tensor, lp: DenseLayer) -> torch.Tensor:
        cfg = self.cfg
        a, _ = attention_block(lp.attn, rmsnorm(x, lp.norm1, cfg.norm_eps),
                               cfg, flash_attention=self.flash_attention)
        x = x + a
        return x + swiglu(lp.mlp, rmsnorm(x, lp.norm2, cfg.norm_eps),
                          cfg.compute_dtype)

    def _trunk(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        """Every layer without a cache; ``remat="block"`` checkpoints each
        layer (its forward runs again in the backward)."""
        cfg = self.cfg
        for lp in unstack(params["layers"]):
            if cfg.remat == "block":
                h = checkpoint(self._layer, h, lp, use_reentrant=False)
            else:
                h = self._layer(h, lp)
        return rmsnorm(h, params["final_norm"], cfg.norm_eps)

    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The lookup as ``F.embedding``: its backward sums each row's
        gradient in a fixed order (advanced indexing's backward on the CPU
        does not), so losses are reproducible from run to run."""
        return F.embedding(tokens.long(),
                           params["embed"].to(self.cfg.compute_dtype))

    def loss_fn(self, params: dict, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        h = self._trunk(params, self._embed(params, batch["tokens"]))
        logits = h @ params["lm_head"].to(cfg.compute_dtype)
        return cross_entropy(logits, batch["labels"], batch.get("loss_mask"))

    # -- serving ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=cfg.compute_dtype,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=cfg.compute_dtype,
                                 device=self.device),
                "index": torch.zeros((batch,), dtype=torch.int32,
                                     device=self.device)}

    def _cached_trunk(self, params: dict, h: torch.Tensor, cache: dict
                      ) -> tuple[torch.Tensor, dict]:
        """Runs every layer against the cache. K/V land in ``cache["k"]``
        and ``cache["v"]`` in place; the returned cache holds those same
        tensors and a new ``index`` advanced by the number of tokens."""
        cfg = self.cfg
        idx = cache["index"]
        for i, lp in enumerate(unstack(params["layers"])):
            a, _ = attention_block(
                lp.attn, rmsnorm(h, lp.norm1, cfg.norm_eps), cfg,
                kv_cache=(cache["k"][i], cache["v"][i]), cache_index=idx,
                decode_attention=self.decode_attention)
            h = h + a
            h = h + swiglu(lp.mlp, rmsnorm(h, lp.norm2, cfg.norm_eps),
                           cfg.compute_dtype)
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        return h, {"k": cache["k"], "v": cache["v"],
                   "index": idx + h.shape[1]}

    def prefill(self, params: dict, batch: dict, cache: dict
                ) -> tuple[torch.Tensor, dict]:
        cfg = self.cfg
        h = self._embed(params, batch["tokens"])
        h, cache = self._cached_trunk(params, h, cache)
        logits = h[:, -1:] @ params["lm_head"].to(cfg.compute_dtype)
        return logits, cache

    def decode(self, params: dict, tokens: torch.Tensor, cache: dict
               ) -> tuple[torch.Tensor, dict]:
        cfg = self.cfg
        h = self._embed(params, tokens)                        # (B,1,d)
        h, cache = self._cached_trunk(params, h, cache)
        logits = h @ params["lm_head"].to(cfg.compute_dtype)
        return logits, cache


def build_model(cfg: ArchConfig, *, device: str | torch.device = "cuda"
                ) -> DenseLM:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: this "
            "slice of the port runs the dense family only")
    return DenseLM(cfg, device=device)
