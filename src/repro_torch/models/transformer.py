"""Model assemblies (counterpart of ``repro/models/transformer.py``).

Every family of the reference: the dense decoder LM, which is also the
vlm backbone (llava, with projected patch embeddings before the text), the
MoE LM (qwen2-moe, kimi-k2), the pure SSM LM (mamba2), the hybrid (zamba2)
and the encoder-decoder (whisper), each with

    init(generator)                 -> params
    loss_fn(params, batch)          -> scalar loss
    prefill(params, batch, cache)   -> (last_logits, cache)
    decode(params, tokens, cache)   -> (logits, cache)
    init_cache(batch, max_len)      -> cache
    cache_slot_axes()               -> the slot axis of each cache leaf

Per-layer leaves are stacked on axis 0 (the hybrid's on (groups,
per_group)), as the reference stacks them for ``lax.scan``; the trunks are
Python loops over per-layer views of them, so gradients flow back to the
stacked leaves. Caches are updated in place.
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
from .ffn import (MLPParams, MoEParams, init_mlp, init_moe, moe_block,
                  swiglu)
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

    def _remat(self, layer: Callable, *args):
        """``layer(*args)``; under ``remat="block"`` checkpointed, so its
        forward runs again in the backward."""
        if self.cfg.remat == "block":
            return checkpoint(layer, *args, use_reentrant=False)
        return layer(*args)

    def _trunk(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        """Every layer without a cache, each through ``_remat``."""
        for lp in unstack(params["layers"]):
            h = self._remat(self._layer, h, lp)
        return rmsnorm(h, params["final_norm"], self.cfg.norm_eps)

    def _patches(self, batch: dict) -> torch.Tensor | None:
        """The batch's ``patch_embeds`` (B, n_patches, d) where the family
        is vlm, else None."""
        return batch.get("patch_embeds") if self.cfg.family == "vlm" else None

    def _embed(self, params: dict, tokens: torch.Tensor,
               patch_embeds: torch.Tensor | None = None) -> torch.Tensor:
        """The lookup as ``F.embedding``: its backward sums each row's
        gradient in a fixed order (advanced indexing's backward on the CPU
        does not), so losses are reproducible from run to run. Patch
        embeddings, projected by ``patch_proj``, go before the text."""
        cd = self.cfg.compute_dtype
        h = F.embedding(tokens.long(), params["embed"].to(cd))
        if patch_embeds is None:
            return h
        return torch.cat([patch_embeds.to(cd) @ params["patch_proj"].to(cd),
                          h], dim=1)

    def loss_fn(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token NLL over the text positions (the patches'
        positions are sliced off)."""
        cfg = self.cfg
        patches = self._patches(batch)
        h = self._trunk(params, self._embed(params, batch["tokens"], patches))
        if patches is not None:
            h = h[:, patches.shape[1]:]
        logits = h @ params["lm_head"].to(cfg.compute_dtype)
        return cross_entropy(logits, batch["labels"], batch.get("loss_mask"))

    def prefill(self, params: dict, batch: dict, cache: dict
                ) -> tuple[torch.Tensor, dict]:
        """The prompt (after its patches, for vlm) into the cache; ``index``
        advances by every position written."""
        cfg = self.cfg
        h = self._embed(params, batch["tokens"], self._patches(batch))
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

    _layer_type = DenseLayer      # the NamedTuple of a layer's params

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
        layers = self._layer_type(init_attn(generator, cfg, dev, lead=(L,)),
                                  self._init_ffn(generator, (L,)),
                                  ones(L), ones(L))
        lm_head = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                             dtype=cfg.param_dtype, device=dev)
        params = {"embed": embed, "layers": layers, "final_norm": ones(),
                  "lm_head": lm_head}
        if cfg.family == "vlm":
            params["patch_proj"] = dense_init(
                generator, (cfg.d_model, cfg.d_model), dtype=cfg.param_dtype,
                device=dev)
        return params

    def _init_ffn(self, generator: torch.Generator,
                  lead: tuple[int, ...]) -> MLPParams:
        """The layers' feed-forward params, stacked on ``lead``."""
        cfg = self.cfg
        return init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.param_dtype,
                        self.device, lead=lead)

    # -- shared trunk -------------------------------------------------------
    def _ffn(self, lp: DenseLayer, x: torch.Tensor) -> torch.Tensor:
        """The layer's feed-forward on its normed input."""
        return swiglu(lp.mlp, x, self.cfg.compute_dtype)

    def _layer(self, x: torch.Tensor, lp: DenseLayer) -> torch.Tensor:
        cfg = self.cfg
        a, _ = attention_block(lp.attn, rmsnorm(x, lp.norm1, cfg.norm_eps),
                               cfg, flash_attention=self.flash_attention)
        x = x + a
        return x + self._ffn(lp, rmsnorm(x, lp.norm2, cfg.norm_eps))

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
            h = h + self._ffn(lp, rmsnorm(h, lp.norm2, cfg.norm_eps))
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        return h, {"k": cache["k"], "v": cache["v"],
                   "index": idx + h.shape[1]}

    def cache_slot_axes(self) -> dict:
        """The slot (batch) axis of each cache leaf but ``index``."""
        return {"k": 1, "v": 1}


# ===========================================================================
# MoE decoder LM (qwen2-moe / kimi-k2)
# ===========================================================================
class MoELayer(NamedTuple):
    attn: AttnParams
    moe: MoEParams
    norm1: torch.Tensor
    norm2: torch.Tensor


class MoELM(DenseLM):
    """``DenseLM`` with a routed MoE block for every MLP. The loss adds
    ``AUX_WEIGHT`` times the mean over layers of the Switch auxiliary loss;
    prefill and decode drop it, as the reference's cached trunk does."""

    AUX_WEIGHT = 0.01
    _layer_type = MoELayer

    def _init_ffn(self, generator: torch.Generator,
                  lead: tuple[int, ...]) -> MoEParams:
        """The expert leaves are drawn a layer at a time into the param
        dtype (``init_moe``), so full width fits on the card."""
        return init_moe(generator, self.cfg, self.device, lead=lead)

    def _ffn(self, lp: MoELayer, x: torch.Tensor) -> torch.Tensor:
        return moe_block(lp.moe, x, self.cfg)[0]

    def _layer(self, x: torch.Tensor, lp: MoELayer
               ) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        a, _ = attention_block(lp.attn, rmsnorm(x, lp.norm1, cfg.norm_eps),
                               cfg, flash_attention=self.flash_attention)
        x = x + a
        m, aux = moe_block(lp.moe, rmsnorm(x, lp.norm2, cfg.norm_eps), cfg)
        return x + m, aux

    def _trunk(self, params: dict, h: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(normed h, mean aux over the layers); ``remat="block"``
        checkpoints each layer with both outputs."""
        cfg = self.cfg
        auxes = []
        for lp in unstack(params["layers"]):
            h, aux = self._remat(self._layer, h, lp)
            auxes.append(aux)
        return (rmsnorm(h, params["final_norm"], cfg.norm_eps),
                torch.stack(auxes).mean())

    def loss_fn(self, params: dict, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        h, aux = self._trunk(params, self._embed(params, batch["tokens"]))
        logits = h @ params["lm_head"].to(cfg.compute_dtype)
        return cross_entropy(logits, batch["labels"],
                             batch.get("loss_mask")) + self.AUX_WEIGHT * aux


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
        for glp in unstack(params["layers"]):
            h = self._remat(self._group, h, params, glp)
        return rmsnorm(h, params["final_norm"], self.cfg.norm_eps)

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


# ===========================================================================
# Encoder-decoder backbone (whisper-tiny); the frame frontend is a stub
# ===========================================================================
class EncLayer(NamedTuple):
    attn: AttnParams
    mlp: MLPParams
    norm1: torch.Tensor
    norm2: torch.Tensor


class DecLayer(NamedTuple):
    self_attn: AttnParams
    cross_attn: AttnParams
    mlp: MLPParams
    norm1: torch.Tensor
    norm2: torch.Tensor
    norm3: torch.Tensor


def _sinusoid(T: int, d: int, dtype, device=None) -> torch.Tensor:
    """(T, d) encoder positions: sin then cos of pos / 10000^(2i/d), in
    fp32, then cast."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


class EncDecLM(DecoderLM):
    """Whisper's backbone: an encoder over precomputed frame embeddings
    (B, enc_len, d) with sinusoid positions and non-causal attention, and a
    RoPE decoder whose layers run self-attention (``flash_attention`` in
    the loss, ``decode_attention`` against the slot cache at T == 1), then
    cross-attention to the encoder's output, then SwiGLU. The cache holds
    the decoder's K/V and each decoder layer's cross K/V, (L, B, enc_len,
    Hkv, hd), which prefill writes in place and decode reads."""

    def __init__(self, cfg: ArchConfig, *, device: str | torch.device = "cuda",
                 decode_attention: Callable = kops.decode_attention,
                 flash_attention: Callable = kops.flash_attention):
        super().__init__(cfg, device=device)
        self.decode_attention = decode_attention
        self.flash_attention = flash_attention

    def init(self, generator: torch.Generator) -> dict:
        cfg, dev = self.cfg, self.device
        Le, L = cfg.n_enc_layers, cfg.n_layers
        ones = lambda *lead: torch.ones((*lead, cfg.d_model),
                                        dtype=cfg.param_dtype, device=dev)
        mlp = lambda lead: init_mlp(generator, cfg.d_model, cfg.d_ff,
                                    cfg.param_dtype, dev, lead=lead)
        embed = embed_init(generator, (cfg.vocab_size, cfg.d_model),
                           cfg.param_dtype, dev)
        enc = EncLayer(init_attn(generator, cfg, dev, lead=(Le,)), mlp((Le,)),
                       ones(Le), ones(Le))
        dec = DecLayer(init_attn(generator, cfg, dev, lead=(L,)),
                       init_attn(generator, cfg, dev, lead=(L,)), mlp((L,)),
                       ones(L), ones(L), ones(L))
        lm_head = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                             dtype=cfg.param_dtype, device=dev)
        return {"embed": embed, "enc_layers": enc, "dec_layers": dec,
                "enc_norm": ones(), "final_norm": ones(), "lm_head": lm_head}

    # -- encoder --------------------------------------------------------------
    def _enc_layer(self, x: torch.Tensor, lp: EncLayer) -> torch.Tensor:
        cfg = self.cfg
        a, _ = attention_block(lp.attn, rmsnorm(x, lp.norm1, cfg.norm_eps),
                               cfg, causal=False, use_rope=False)
        x = x + a
        return x + swiglu(lp.mlp, rmsnorm(x, lp.norm2, cfg.norm_eps),
                          cfg.compute_dtype)

    def encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T_enc, d) precomputed embeddings (stub frontend)."""
        cfg = self.cfg
        h = frames.to(cfg.compute_dtype) + _sinusoid(
            frames.shape[1], cfg.d_model, cfg.compute_dtype, frames.device)
        for lp in unstack(params["enc_layers"]):
            h = self._remat(self._enc_layer, h, lp)
        return rmsnorm(h, params["enc_norm"], cfg.norm_eps)

    def _cross_kv(self, params: dict, enc_out: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """Every decoder layer's cross K and V, each (L, B, T_enc, Hkv,
        hd): one product of the encoder's output with the stacked
        ``cross_attn.wk`` / ``wv``."""
        cfg = self.cfg
        B, Te, _ = enc_out.shape
        shape = (cfg.n_layers, B, Te, cfg.n_kv_heads, cfg.hd)
        ca = params["dec_layers"].cross_attn
        return tuple((enc_out[None] @ w.to(cfg.compute_dtype)[:, None]
                      ).reshape(shape) for w in (ca.wk, ca.wv))

    # -- decoder --------------------------------------------------------------
    def _dec_layer(self, x: torch.Tensor, lp: DecLayer,
                   cross_k: torch.Tensor, cross_v: torch.Tensor,
                   kv_cache=None, index=None) -> torch.Tensor:
        cfg = self.cfg
        a, _ = attention_block(
            lp.self_attn, rmsnorm(x, lp.norm1, cfg.norm_eps), cfg,
            kv_cache=kv_cache, cache_index=index,
            decode_attention=self.decode_attention,
            flash_attention=self.flash_attention)
        x = x + a
        c, _ = attention_block(lp.cross_attn,
                               rmsnorm(x, lp.norm2, cfg.norm_eps), cfg,
                               cross_kv=(cross_k, cross_v))
        x = x + c
        return x + swiglu(lp.mlp, rmsnorm(x, lp.norm3, cfg.norm_eps),
                          cfg.compute_dtype)

    def _decoder(self, params: dict, h: torch.Tensor,
                 cross_kv: tuple[torch.Tensor, torch.Tensor],
                 cache: dict | None = None) -> torch.Tensor:
        """Every decoder layer: without a cache each through ``_remat``;
        with one, its K/V written in place at ``cache["index"]`` (no remat,
        as in the reference)."""
        layers = zip(unstack(params["dec_layers"]), *(t.unbind(0)
                                                      for t in cross_kv))
        for i, (lp, ck, cv) in enumerate(layers):
            if cache is None:
                h = self._remat(self._dec_layer, h, lp, ck, cv)
            else:
                h = self._dec_layer(h, lp, ck, cv,
                                    (cache["k"][i], cache["v"][i]),
                                    cache["index"])
        return rmsnorm(h, params["final_norm"], self.cfg.norm_eps)

    def loss_fn(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token NLL of the decoder; needs ``batch["frames"]``."""
        cfg = self.cfg
        cross_kv = self._cross_kv(params, self.encode(params,
                                                      batch["frames"]))
        h = self._decoder(params, self._embed(params, batch["tokens"]),
                          cross_kv)
        logits = h @ params["lm_head"].to(cfg.compute_dtype)
        return cross_entropy(logits, batch["labels"], batch.get("loss_mask"))

    # -- serving ------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        zeros = lambda T: torch.zeros(
            (cfg.n_layers, batch, T, cfg.n_kv_heads, cfg.hd),
            dtype=cfg.compute_dtype, device=self.device)
        return {"k": zeros(max_len), "v": zeros(max_len),
                "cross_k": zeros(cfg.enc_len), "cross_v": zeros(cfg.enc_len),
                "index": torch.zeros((batch,), dtype=torch.int32,
                                     device=self.device)}

    def cache_slot_axes(self) -> dict:
        return {"k": 1, "v": 1, "cross_k": 1, "cross_v": 1}

    def prefill(self, params: dict, batch: dict, cache: dict
                ) -> tuple[torch.Tensor, dict]:
        """Encodes ``batch["frames"]`` (B, enc_len, d), writes the cross
        K/V into the cache in place, then runs the prompt's tokens through
        the decoder into the cache; ``index`` advances by T."""
        cfg = self.cfg
        frames = batch["frames"]
        if frames.shape[1] != cfg.enc_len:
            raise ValueError(f"{frames.shape[1]} frames, the cache holds "
                             f"enc_len {cfg.enc_len}")
        for leaf, new in zip((cache["cross_k"], cache["cross_v"]),
                             self._cross_kv(params,
                                            self.encode(params, frames))):
            leaf.copy_(new)
        h = self._decoder(params, self._embed(params, batch["tokens"]),
                          (cache["cross_k"], cache["cross_v"]), cache)
        logits = h[:, -1:] @ params["lm_head"].to(cfg.compute_dtype)
        return logits, {**cache, "index": cache["index"] + h.shape[1]}

    def decode(self, params: dict, tokens: torch.Tensor, cache: dict
               ) -> tuple[torch.Tensor, dict]:
        cfg = self.cfg
        h = self._decoder(params, self._embed(params, tokens),
                          (cache["cross_k"], cache["cross_v"]), cache)
        logits = h @ params["lm_head"].to(cfg.compute_dtype)
        return logits, {**cache, "index": cache["index"] + 1}


_FAMILIES = {"dense": DenseLM, "vlm": DenseLM, "moe": MoELM, "ssm": MambaLM,
             "hybrid": HybridLM, "encdec": EncDecLM}


def build_model(cfg: ArchConfig, *, device: str | torch.device = "cuda"
                ) -> DecoderLM:
    return _FAMILIES[cfg.family](cfg, device=device)
