"""Model assemblies (counterpart of ``repro/models/transformer.py``).

This slice holds the dense decoder LM, the pure SSM LM (mamba2) and the
hybrid (zamba2), each with

    init(generator)                 -> params
    loss_fn(params, batch)          -> scalar loss
    prefill(params, batch, cache)   -> (last_logits, cache)
    decode(params, tokens, cache)   -> (logits, cache)
    init_cache(batch, max_len)      -> cache
    cache_slot_axes()               -> the slot axis of each cache leaf

Per-layer leaves are stacked on axis 0 (the hybrid's on (groups,
per_group)), as the reference stacks them for ``lax.scan``; the trunks are
Python loops over per-layer views of them, so gradients flow back to the
stacked leaves. Caches are updated in place. The other families come with
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
from .mamba2 import (Mamba2Params, MambaState, init_mamba2, init_mamba_state,
                     mamba2_block)


class DenseLayer(NamedTuple):
    attn: AttnParams
    mlp: MLPParams
    norm1: torch.Tensor
    norm2: torch.Tensor


def unstack(tree):
    """Views along axis 0 of a NamedTuple tree of stacked leaves (the
    layers, or the hybrid's groups): one ``unbind`` per leaf, so each
    leaf's gradient is gathered by one node."""
    if isinstance(tree, tuple):
        return [type(tree)(*xs) for xs in zip(*(unstack(t) for t in tree))]
    return list(tree.unbind(0))


class DecoderLM:
    """What the families share: the embedding lookup, the trunk without a
    cache (``_layer`` per stacked layer), the loss, prefill and decode
    around a family's ``_cached_trunk``."""

    def __init__(self, cfg: ArchConfig, *,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = require_device(device)

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


class DenseLM(DecoderLM):
    """GQA + RoPE + SwiGLU decoder-only LM.

    Weight matrices keep the reference's (in, out) layout and are applied
    as ``x @ w``. ``decode_attention`` and ``flash_attention`` are the
    attentions that decode steps and the loss call; they are the kernel
    seams unless a caller passes the plain versions to hold the kernels
    against them."""

    def __init__(self, cfg: ArchConfig, *, device: str | torch.device = "cuda",
                 decode_attention: Callable = kops.decode_attention,
                 flash_attention: Callable = kops.flash_attention):
        super().__init__(cfg, device=device)
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

    def cache_slot_axes(self) -> dict:
        """The slot (batch) axis of each cache leaf but ``index``."""
        return {"k": 1, "v": 1}


# ===========================================================================
# Pure SSM LM (mamba2-1.3b)
# ===========================================================================
class SSMLayer(NamedTuple):
    mamba: Mamba2Params
    norm: torch.Tensor


def _ssm_step(cfg: ArchConfig, lp: SSMLayer, x: torch.Tensor,
              state: MambaState, ssd_scan: Callable) -> torch.Tensor:
    """One SSM layer against its cached state, which it updates in place;
    returns the residual stream after the layer."""
    m, new = mamba2_block(lp.mamba, rmsnorm(x, lp.norm, cfg.norm_eps), cfg,
                          state=state, return_state=True, ssd_scan=ssd_scan)
    state.conv_tail.copy_(new.conv_tail)
    state.ssm.copy_(new.ssm)
    return x + m


class MambaLM(DecoderLM):
    """Attention-free mamba2 LM. ``ssd_scan`` is the kernel seam of every
    prefill layer and of the loss (decode steps the recurrence in plain
    torch ops); a caller may pass the plain version. The scan has no
    backward on the card yet, so ``loss_fn`` differentiates only on the
    CPU."""

    def __init__(self, cfg: ArchConfig, *, device: str | torch.device = "cuda",
                 ssd_scan: Callable = kops.ssd_scan):
        super().__init__(cfg, device=device)
        self.ssd_scan = ssd_scan

    def _ssm_layers(self, generator: torch.Generator,
                    lead: tuple[int, ...]) -> SSMLayer:
        cfg = self.cfg
        return SSMLayer(init_mamba2(generator, cfg, self.device, lead=lead),
                        torch.ones((*lead, cfg.d_model),
                                   dtype=cfg.param_dtype, device=self.device))

    def init(self, generator: torch.Generator) -> dict:
        cfg, dev = self.cfg, self.device
        embed = embed_init(generator, (cfg.vocab_size, cfg.d_model),
                           cfg.param_dtype, dev)
        layers = self._ssm_layers(generator, (cfg.n_layers,))
        lm_head = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                             dtype=cfg.param_dtype, device=dev)
        return {"embed": embed, "layers": layers,
                "final_norm": torch.ones((cfg.d_model,),
                                         dtype=cfg.param_dtype, device=dev),
                "lm_head": lm_head}

    def _layer(self, x: torch.Tensor, lp: SSMLayer) -> torch.Tensor:
        cfg = self.cfg
        m, _ = mamba2_block(lp.mamba, rmsnorm(x, lp.norm, cfg.norm_eps), cfg,
                            ssd_scan=self.ssd_scan)
        return x + m

    # -- serving: O(1) state --------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        return {"state": init_mamba_state(cfg, batch, cfg.compute_dtype,
                                          self.device, lead=(cfg.n_layers,)),
                "index": torch.zeros((batch,), dtype=torch.int32,
                                     device=self.device)}

    def cache_slot_axes(self) -> dict:
        return {"state": MambaState(1, 1)}

    def _cached_trunk(self, params: dict, h: torch.Tensor, cache: dict
                      ) -> tuple[torch.Tensor, dict]:
        cfg, st = self.cfg, cache["state"]
        for lp, state in zip(unstack(params["layers"]), unstack(st)):
            h = _ssm_step(cfg, lp, h, state, self.ssd_scan)
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        return h, {"state": st, "index": cache["index"] + h.shape[1]}


# ===========================================================================
# Hybrid (zamba2): mamba2 backbone + ONE shared attention block every k layers
# ===========================================================================
class HybridLM(MambaLM):
    """Mamba2 layers in groups of ``attn_every``, each group led by one
    attention + MLP block whose weights all groups share. Layer leaves are
    (groups, per_group, ...); each group has its own KV cache, written in
    place through ``attention_block``."""

    def __init__(self, cfg: ArchConfig, *, device: str | torch.device = "cuda",
                 ssd_scan: Callable = kops.ssd_scan,
                 decode_attention: Callable = kops.decode_attention):
        if cfg.attn_every <= 0 or cfg.n_layers % cfg.attn_every:
            raise ValueError(f"n_layers {cfg.n_layers} is not a whole number "
                             f"of groups of attn_every {cfg.attn_every}")
        super().__init__(cfg, device=device, ssd_scan=ssd_scan)
        self.decode_attention = decode_attention
        self.n_groups = cfg.n_layers // cfg.attn_every

    def init(self, generator: torch.Generator) -> dict:
        cfg, dev = self.cfg, self.device
        ones = lambda: torch.ones((cfg.d_model,), dtype=cfg.param_dtype,
                                  device=dev)
        embed = embed_init(generator, (cfg.vocab_size, cfg.d_model),
                           cfg.param_dtype, dev)
        layers = self._ssm_layers(generator, (self.n_groups, cfg.attn_every))
        shared_attn = init_attn(generator, cfg, dev)
        shared_mlp = init_mlp(generator, cfg.d_model, cfg.d_ff,
                              cfg.param_dtype, dev)
        lm_head = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                             dtype=cfg.param_dtype, device=dev)
        return {"embed": embed, "layers": layers, "shared_attn": shared_attn,
                "shared_mlp": shared_mlp, "shared_norm1": ones(),
                "shared_norm2": ones(), "final_norm": ones(),
                "lm_head": lm_head}

    def _shared_block(self, params: dict, x: torch.Tensor, *, kv_cache=None,
                      cache_index=None) -> torch.Tensor:
        cfg = self.cfg
        a, _ = attention_block(
            params["shared_attn"],
            rmsnorm(x, params["shared_norm1"], cfg.norm_eps), cfg,
            kv_cache=kv_cache, cache_index=cache_index,
            decode_attention=self.decode_attention)
        x = x + a
        return x + swiglu(params["shared_mlp"],
                          rmsnorm(x, params["shared_norm2"], cfg.norm_eps),
                          cfg.compute_dtype)

    def _group(self, x: torch.Tensor, params: dict,
               glp: SSMLayer) -> torch.Tensor:
        x = self._shared_block(params, x)
        for lp in unstack(glp):
            x = self._layer(x, lp)
        return x

    def _trunk(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        """Every group without a cache; ``remat="block"`` checkpoints each
        group, as the reference remats its group scan."""
        cfg = self.cfg
        for glp in unstack(params["layers"]):
            if cfg.remat == "block":
                h = checkpoint(self._group, h, params, glp,
                               use_reentrant=False)
            else:
                h = self._group(h, params, glp)
        return rmsnorm(h, params["final_norm"], cfg.norm_eps)

    # -- serving: SSM states + per-group KV cache for the shared block --------
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg, dev = self.cfg, self.device
        kshape = (self.n_groups, batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {"state": init_mamba_state(cfg, batch, cfg.compute_dtype, dev,
                                          lead=(self.n_groups,
                                                cfg.attn_every)),
                "k": torch.zeros(kshape, dtype=cfg.compute_dtype, device=dev),
                "v": torch.zeros(kshape, dtype=cfg.compute_dtype, device=dev),
                "index": torch.zeros((batch,), dtype=torch.int32, device=dev)}

    def cache_slot_axes(self) -> dict:
        return {"state": MambaState(2, 2), "k": 1, "v": 1}

    def _cached_trunk(self, params: dict, h: torch.Tensor, cache: dict
                      ) -> tuple[torch.Tensor, dict]:
        cfg, idx, st = self.cfg, cache["index"], cache["state"]
        for g, (glp, gst) in enumerate(zip(unstack(params["layers"]),
                                           unstack(st))):
            h = self._shared_block(params, h,
                                   kv_cache=(cache["k"][g], cache["v"][g]),
                                   cache_index=idx)
            for lp, state in zip(unstack(glp), unstack(gst)):
                h = _ssm_step(cfg, lp, h, state, self.ssd_scan)
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        return h, {"state": st, "k": cache["k"], "v": cache["v"],
                   "index": idx + h.shape[1]}


_FAMILIES = {"dense": DenseLM, "ssm": MambaLM, "hybrid": HybridLM}


def build_model(cfg: ArchConfig, *, device: str | torch.device = "cuda"
                ) -> DecoderLM:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: this "
            f"slice of the port runs {sorted(_FAMILIES)}")
    return _FAMILIES[cfg.family](cfg, device=device)
