"""Model assemblies (counterpart of ``repro/models/transformer.py``).

This slice holds the dense decoder LM's serving path:

    init(generator)                 -> params
    prefill(params, batch, cache)   -> (last_logits, cache)
    decode(params, tokens, cache)   -> (logits, cache)
    init_cache(batch, max_len)      -> cache

``loss_fn`` comes with the training slice (it needs flash attention), and
the other families with their own slices. The reference's ``lax.scan``
over stacked layers is a Python loop over a list of layers here.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import ops as kops

from .attention import AttnParams, attention_block, init_attn
from .common import (ArchConfig, dense_init, embed_init, require_device,
                     rmsnorm)
from .ffn import MLPParams, init_mlp, swiglu


class DenseLayer(NamedTuple):
    attn: AttnParams
    mlp: MLPParams
    norm1: torch.Tensor
    norm2: torch.Tensor


class DenseLM:
    """GQA + RoPE + SwiGLU decoder-only LM.

    Weight matrices keep the reference's (in, out) layout and are applied
    as ``x @ w``. ``decode_attention`` is the attention that decode steps
    call; it is the kernel seam unless a caller passes the plain version to
    hold the kernel against it."""

    def __init__(self, cfg: ArchConfig, *, device: str | torch.device = "cuda",
                 decode_attention: Callable = kops.decode_attention):
        self.cfg = cfg
        self.device = require_device(device)
        self.decode_attention = decode_attention

    def init(self, generator: torch.Generator) -> dict:
        """Seeded random weights. The draws happen on the generator's
        device in fp32, then move to the model's device and param dtype."""
        cfg, dev = self.cfg, self.device
        ones = lambda: torch.ones((cfg.d_model,), dtype=cfg.param_dtype,
                                  device=dev)
        embed = embed_init(generator, (cfg.vocab_size, cfg.d_model),
                           cfg.param_dtype, dev)
        layers = [DenseLayer(init_attn(generator, cfg, dev),
                             init_mlp(generator, cfg.d_model, cfg.d_ff,
                                      cfg.param_dtype, dev),
                             ones(), ones())
                  for _ in range(cfg.n_layers)]
        lm_head = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                             dtype=cfg.param_dtype, device=dev)
        return {"embed": embed, "layers": layers, "final_norm": ones(),
                "lm_head": lm_head}

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

    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"].to(self.cfg.compute_dtype)[tokens.long()]

    def _cached_trunk(self, params: dict, h: torch.Tensor, cache: dict
                      ) -> tuple[torch.Tensor, dict]:
        """Runs every layer against the cache. K/V land in ``cache["k"]``
        and ``cache["v"]`` in place; the returned cache holds those same
        tensors and a new ``index`` advanced by the number of tokens."""
        cfg = self.cfg
        idx = cache["index"]
        for i, lp in enumerate(params["layers"]):
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
            "slice of the port serves the dense family only")
    return DenseLM(cfg, device=device)
