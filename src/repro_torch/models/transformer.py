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
stacked leaves. A sharded step hands the model its leaves as
``sharding.Placed`` (a rank's DTensor and its layouts): each layer gathers
its own leaves at its start (``sharding.gather_layer``, the identity on
plain tensors) and drops them at its end, and the leaves outside the
stacks are gathered where they are used, as the reference's scan body
holds each layer's collectives. Caches are updated in place.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding as shd
from repro_torch.distributed import tensor_parallel
from repro_torch.kernels import ops as kops

from .attention import AttnParams, attention_block, init_attn
from .common import (ArchConfig, cross_entropy, dense_init, embed_init,
                     require_device, rmsnorm, token_nll)
from .ffn import (MLPParams, MoEParams, init_mlp, init_moe, moe_block,
                  swiglu)
from .mamba2 import (Mamba2Params, MambaState, init_mamba2, init_mamba_state,
                     mamba2_block)
from .moe_ep import moe_block_tp


class DenseLayer(NamedTuple):
    attn: AttnParams
    mlp: MLPParams
    norm1: torch.Tensor
    norm2: torch.Tensor


def unstack(tree):
    """Views along axis 0 of a NamedTuple tree of stacked leaves (the
    layers, or the hybrid's groups): one ``unbind`` per leaf, so each
    leaf's gradient is gathered by one node. A ``sharding.Placed`` leaf
    (a sharded step's) gives its rank's block of each layer with the
    layer's layouts, nothing gathered: the layer gathers it when it runs
    (``sharding.gather_layer``) and frees it when it ends."""
    if isinstance(tree, tuple):
        return [type(tree)(*xs) for xs in zip(*(unstack(t) for t in tree))]
    return list(tree.unbind(0))


def _routes(tp) -> tuple:
    """The trunk's extra arguments: the route where there is one (the
    families of ``tensor_parallel.TP_FAMILIES`` get one), else none."""
    return () if tp is None else (tp,)


def _mlp(tp, fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` (the MLP on its normed input); under a route, its
    tensor-parallel form, local where the plan's MLP is."""
    if tp is None:
        return fn(x)
    return tp.sublayer(fn, x, tp.plan.mlp_local)


def _attention(tp, fn, p: AttnParams, x: torch.Tensor) -> torch.Tensor:
    """``fn(p, x, None)`` (attention on its normed input, every query
    row); under a route, in the plan's mode (``Route.attention``: the
    rank's KV head's columns of ``p``, or its query rows)."""
    if tp is None:
        return fn(p, x, None)
    return tp.attention(fn, p, x)


def _cross_attention(tp, fn, p: AttnParams, x: torch.Tensor
                     ) -> torch.Tensor:
    """``fn(p, x, None)`` (cross-attention on its normed input, every
    query row); under a route, in the decoder's mode
    (``Route.cross_attention``)."""
    if tp is None:
        return fn(p, x, None)
    return tp.cross_attention(fn, p, x)


def _ssm(tp, fn, p: Mamba2Params, x: torch.Tensor) -> torch.Tensor:
    """``fn(p, x, None)`` (the mamba2 block on its normed input); under a
    route, in the plan's mode (``Route.ssm``: the rank's heads of ``p``
    and the gated RMSNorm's sum over the ranks)."""
    if tp is None:
        return fn(p, x, None)
    return tp.ssm(fn, p, x)


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

    def _tp(self, kind: str, seq_len: int, rows: int,
            cache_len: int | None = None):
        """The ``tensor_parallel.Route`` of an installed policy (a family
        of ``tensor_parallel.TP_FAMILIES`` on a mesh with a ``"model"``
        axis) for a step of ``rows`` rows against a cache of ``cache_len``
        positions, else None."""
        return tensor_parallel.route(self.cfg, kind=kind, seq_len=seq_len,
                                     rows=rows, cache_len=cache_len)

    def _trunk(self, params: dict, h: torch.Tensor, tp=None) -> torch.Tensor:
        """Every layer without a cache, each through ``_remat``; under a
        route the layers get it as an argument, so a checkpoint's
        recompute in the backward runs the same route."""
        layer = self._layer if tp is None else functools.partial(
            self._layer, tp=tp)
        for lp in unstack(params["layers"]):
            h = self._remat(layer, h, lp)
        return self._final_norm(params, h)

    def _final_norm(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        """The trunk's last RMSNorm, its weight gathered where it is
        used."""
        return rmsnorm(h, shd.gather_layer(params["final_norm"]),
                       self.cfg.norm_eps)

    def _patches(self, batch: dict) -> torch.Tensor | None:
        """The batch's ``patch_embeds`` (B, n_patches, d) where the family
        is vlm, else None."""
        return batch.get("patch_embeds") if self.cfg.family == "vlm" else None

    def _embed(self, params: dict, tokens: torch.Tensor,
               patch_embeds: torch.Tensor | None = None, tp=None
               ) -> torch.Tensor:
        """The lookup as ``F.embedding``: its backward sums each row's
        gradient in a fixed order (advanced indexing's backward on the CPU
        does not), so losses are reproducible from run to run. Patch
        embeddings, projected by ``patch_proj``, go before the text. Under
        a route, the residual stream in its layout (``Route.embed``)."""
        cd = self.cfg.compute_dtype
        table = shd.gather_layer(params["embed"]).to(cd)
        pe = None if patch_embeds is None else \
            patch_embeds.to(cd) @ shd.gather_layer(
                params["patch_proj"]).to(cd)
        if tp is not None:
            return tp.embed(tokens, table, pe)
        h = F.embedding(tokens.long(), table)
        return h if pe is None else torch.cat([pe, h], dim=1)

    def _logits(self, params: dict, h: torch.Tensor, tp=None
                ) -> torch.Tensor:
        """The normed residual's logits: this rank's vocab columns under a
        route whose vocab is local."""
        if tp is not None:
            h = tp.head_input(h)
        lm_head = shd.gather_layer(params["lm_head"])
        return h @ lm_head.to(self.cfg.compute_dtype)

    def _routed(self, params: dict, kind: str, seq_len: int, rows: int,
                cache_len: int | None = None):
        """``_tp``, with the leaves checked against its plan."""
        tp = self._tp(kind, seq_len, rows, cache_len)
        if tp is not None:
            tp.check(self.cfg, params)
        return tp

    def _nll(self, params: dict, h: torch.Tensor, batch: dict, tp=None,
             skip: int = 0) -> torch.Tensor:
        """Mean next-token NLL of the normed residual ``h`` over the text
        (its first ``skip`` positions, a vlm's patches, have no labels).
        Under a route vocab-parallel where the vocab is local; where it is
        whole and the residual sequence-parallel (``Plan.loss_rows``), the
        whole-vocab logits of this rank's own positions alone
        (``Route.rows_nll``)."""
        labels, mask = batch["labels"], batch.get("loss_mask")
        lm_head = shd.gather_layer(params["lm_head"]).to(
            self.cfg.compute_dtype)
        if tp is not None and tp.plan.loss_rows:
            return tp.rows_nll(lambda x, y: token_nll(x @ lm_head, y), h,
                               labels, mask, skip)
        if tp is not None:
            h = tp.head_input(h)
        vocab_tp = tp if tp is not None and tp.plan.vocab_local else None
        return cross_entropy(h[:, skip:] @ lm_head, labels, mask, tp=vocab_tp)

    def loss_fn(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token NLL over the text positions (the patches'
        positions are sliced off)."""
        cfg = self.cfg
        patches = self._patches(batch)
        tp = self._routed(params, "train",
                          tensor_parallel.residual_len(cfg, batch),
                          batch["tokens"].shape[0])
        h = self._trunk(params, self._embed(params, batch["tokens"], patches,
                                            tp), *_routes(tp))
        return self._nll(params, h, batch, tp,
                         0 if patches is None else patches.shape[1])

    def prefill(self, params: dict, batch: dict, cache: dict, *,
                cache_len: int | None = None) -> tuple[torch.Tensor, dict]:
        """The prompt (after its patches, for vlm) into the cache; ``index``
        advances by every position written. Under a route, the logits are
        this rank's vocab columns where the vocab is local; ``cache_len``
        is the whole cache's positions where ``cache`` is a rank's block
        of a cache laid out by the plan (``launch.build.serve_step``'s),
        None where it is whole."""
        tp = self._routed(params, "prefill",
                          tensor_parallel.residual_len(self.cfg, batch),
                          batch["tokens"].shape[0], cache_len)
        h = self._embed(params, batch["tokens"], self._patches(batch), tp)
        h, cache = self._cached_trunk(params, h, cache, *_routes(tp))
        return self._logits(params, h[:, -1:], tp), cache

    def decode(self, params: dict, tokens: torch.Tensor, cache: dict, *,
               cache_len: int | None = None) -> tuple[torch.Tensor, dict]:
        """One token a slot against the cache; ``cache_len`` as
        ``prefill``'s."""
        tp = self._routed(params, "decode", 1, tokens.shape[0], cache_len)
        h = self._embed(params, tokens, tp=tp)                 # (B,1,d)
        h, cache = self._cached_trunk(params, h, cache, *_routes(tp))
        return self._logits(params, h, tp), cache


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

    def _feed_forward(self, lp: DenseLayer, x: torch.Tensor, tp=None
                      ) -> torch.Tensor:
        """The feed-forward sublayer on its normed input; under a route in
        its tensor-parallel form (``_mlp``)."""
        return _mlp(tp, functools.partial(self._ffn, lp), x)

    def _layer(self, x: torch.Tensor, lp: DenseLayer, tp=None
               ) -> torch.Tensor:
        """One layer, its leaves gathered first
        (``sharding.gather_layer``); under a route each sublayer in its
        tensor-parallel form (``Route.sublayer``)."""
        cfg = self.cfg
        lp = shd.gather_layer(lp)

        def attn(p, h, rows):
            return attention_block(p, h, cfg, q_rows=rows,
                                   flash_attention=self.flash_attention)[0]

        x = x + _attention(tp, attn, lp.attn,
                           rmsnorm(x, lp.norm1, cfg.norm_eps))
        return x + self._feed_forward(lp, rmsnorm(x, lp.norm2, cfg.norm_eps),
                                      tp)

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

    def _cached_trunk(self, params: dict, h: torch.Tensor, cache: dict,
                      tp=None) -> tuple[torch.Tensor, dict]:
        """Runs every layer against the cache. K/V land in ``cache["k"]``
        and ``cache["v"]`` in place; the returned cache holds those same
        tensors and a new ``index`` advanced by the number of tokens.
        Under a route whose heads are "local" the cache holds this rank's
        KV heads, under "kv_replicated" its one KV head; where the plan
        splits it over its positions (``Route.kv_split``: "kv_seq", and a
        prefill into that layout) the rank's positions of every head, else
        every head and position (a "q_seq" prefill writes every row and
        attends from its own)."""
        cfg = self.cfg
        idx = cache["index"]
        split = None if tp is None else tp.kv_split
        for i, lp in enumerate(unstack(params["layers"])):
            lp = shd.gather_layer(lp)

            def attn(p, x, rows, i=i):
                return attention_block(
                    p, x, cfg, kv_cache=(cache["k"][i], cache["v"][i]),
                    cache_index=idx, q_rows=rows, kv_split=split,
                    decode_attention=self.decode_attention)[0]

            h = h + _attention(tp, attn, lp.attn,
                               rmsnorm(h, lp.norm1, cfg.norm_eps))
            h = h + self._feed_forward(
                lp, rmsnorm(h, lp.norm2, cfg.norm_eps), tp)
        h = self._final_norm(params, h)
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
    prefill and decode drop it, as the reference's cached trunk does.
    Under a tensor-parallel route (an expert-parallel config on a mesh)
    each layer's MoE block is ``moe_ep.moe_block_tp`` and its aux the
    global one, the same on every rank."""

    AUX_WEIGHT = 0.01
    _layer_type = MoELayer

    def _init_ffn(self, generator: torch.Generator,
                  lead: tuple[int, ...]) -> MoEParams:
        """The expert leaves are drawn a layer at a time into the param
        dtype (``init_moe``), so full width fits on the card."""
        return init_moe(generator, self.cfg, self.device, lead=lead)

    def _moe(self, lp: MoELayer, x: torch.Tensor, tp=None
             ) -> tuple[torch.Tensor, torch.Tensor]:
        """(the MoE sublayer's output on its normed input, its aux): under
        a route in its expert- and tensor-parallel form."""
        if tp is None:
            return moe_block(lp.moe, x, self.cfg)
        return moe_block_tp(lp.moe, x, self.cfg, tp)

    def _feed_forward(self, lp: MoELayer, x: torch.Tensor, tp=None
                      ) -> torch.Tensor:
        return self._moe(lp, x, tp)[0]

    def _layer(self, x: torch.Tensor, lp: MoELayer, tp=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """One layer and its aux, its leaves gathered first; an
        expert-parallel layer's expert stacks are the rank's experts
        already and keep their placement."""
        cfg = self.cfg
        lp = shd.gather_layer(lp)

        def attn(p, h, rows):
            return attention_block(p, h, cfg, q_rows=rows,
                                   flash_attention=self.flash_attention)[0]

        x = x + _attention(tp, attn, lp.attn,
                           rmsnorm(x, lp.norm1, cfg.norm_eps))
        m, aux = self._moe(lp, rmsnorm(x, lp.norm2, cfg.norm_eps), tp)
        return x + m, aux

    def _trunk(self, params: dict, h: torch.Tensor, tp=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(normed h, mean aux over the layers); ``remat="block"``
        checkpoints each layer with both outputs. Under a route the layers
        get it as an argument, as ``DecoderLM._trunk``'s."""
        layer = self._layer if tp is None else functools.partial(
            self._layer, tp=tp)
        auxes = []
        for lp in unstack(params["layers"]):
            h, aux = self._remat(layer, h, lp)
            auxes.append(aux)
        return (self._final_norm(params, h),
                torch.stack(auxes).mean())

    def loss_fn(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token NLL plus ``AUX_WEIGHT`` times the layers' mean
        aux; under a route the NLL as ``DecoderLM._nll``'s."""
        tokens = batch["tokens"]
        tp = self._routed(params, "train", tokens.shape[1], tokens.shape[0])
        h, aux = self._trunk(params, self._embed(params, tokens, tp=tp),
                             *_routes(tp))
        return self._nll(params, h, batch, tp) + self.AUX_WEIGHT * aux


# ===========================================================================
# Pure SSM LM (mamba2-1.3b)
# ===========================================================================
class SSMLayer(NamedTuple):
    mamba: Mamba2Params
    norm: torch.Tensor


def _ssm_step(cfg: ArchConfig, lp: SSMLayer, x: torch.Tensor,
              state: MambaState, ssd_scan: Callable, tp=None
              ) -> torch.Tensor:
    """One SSM layer against its cached state, which it updates in place
    (under a route whose SSM heads are local, the rank's heads' state);
    returns the residual stream after the layer. The layer's leaves are
    gathered first."""
    lp = shd.gather_layer(lp)
    new = []

    def block(p, h, norm_sum):
        out, st = mamba2_block(p, h, cfg, state=state, return_state=True,
                               ssd_scan=ssd_scan, norm_sum=norm_sum)
        new.append(st)
        return out

    m = _ssm(tp, block, lp.mamba, rmsnorm(x, lp.norm, cfg.norm_eps))
    state.conv_tail.copy_(new[0].conv_tail)
    state.ssm.copy_(new[0].ssm)
    return x + m


class MambaLM(DecoderLM):
    """Attention-free mamba2 LM. ``ssd_scan`` is the kernel seam of every
    prefill layer and of the loss (decode steps the recurrence in plain
    torch ops); a caller may pass the plain version. On the card the
    loss's gradient goes through the scan's backward kernel."""

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

    def _layer(self, x: torch.Tensor, lp: SSMLayer, tp=None
               ) -> torch.Tensor:
        """One SSM layer, its leaves gathered first; under a route the
        block in its tensor-parallel form (``Route.ssm``)."""
        cfg = self.cfg
        lp = shd.gather_layer(lp)

        def block(p, h, norm_sum):
            return mamba2_block(p, h, cfg, ssd_scan=self.ssd_scan,
                                norm_sum=norm_sum)[0]

        return x + _ssm(tp, block, lp.mamba,
                        rmsnorm(x, lp.norm, cfg.norm_eps))

    # -- serving: O(1) state --------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        return {"state": init_mamba_state(cfg, batch, cfg.compute_dtype,
                                          self.device, lead=(cfg.n_layers,)),
                "index": torch.zeros((batch,), dtype=torch.int32,
                                     device=self.device)}

    def cache_slot_axes(self) -> dict:
        return {"state": MambaState(1, 1)}

    def _cached_trunk(self, params: dict, h: torch.Tensor, cache: dict,
                      tp=None) -> tuple[torch.Tensor, dict]:
        """Every layer against its state, in place. Under a route whose
        SSM heads are local the states are the rank's heads' (and its
        conv channels, ``sharding.tp_cache``), else whole."""
        cfg, st = self.cfg, cache["state"]
        for lp, state in zip(unstack(params["layers"]), unstack(st)):
            h = _ssm_step(cfg, lp, h, state, self.ssd_scan, tp)
        h = self._final_norm(params, h)
        return h, {"state": st, "index": cache["index"] + h.shape[1]}


# ===========================================================================
# Hybrid (zamba2): mamba2 backbone + ONE shared attention block every k layers
# ===========================================================================
class HybridLM(MambaLM):
    """Mamba2 layers in groups of ``attn_every``, each group led by one
    attention + MLP block whose weights all groups share. Layer leaves are
    (groups, per_group, ...); each group has its own KV cache, written in
    place through ``attention_block``. The shared block's attention goes
    through the ``decode_attention`` and ``flash_attention`` seams (the
    loss and a prefill without a cache through the latter), as
    ``DenseLM``'s does."""

    def __init__(self, cfg: ArchConfig, *, device: str | torch.device = "cuda",
                 ssd_scan: Callable = kops.ssd_scan,
                 decode_attention: Callable = kops.decode_attention,
                 flash_attention: Callable = kops.flash_attention):
        if cfg.attn_every <= 0 or cfg.n_layers % cfg.attn_every:
            raise ValueError(f"n_layers {cfg.n_layers} is not a whole number "
                             f"of groups of attn_every {cfg.attn_every}")
        super().__init__(cfg, device=device, ssd_scan=ssd_scan)
        self.decode_attention = decode_attention
        self.flash_attention = flash_attention
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

    def _shared(self, params: dict) -> dict:
        """The shared block's leaves, gathered once a step: every group
        reuses them, so a rank holds one layer's worth of them whole."""
        return shd.gather_layer({k: params[k] for k in (
            "shared_attn", "shared_mlp", "shared_norm1", "shared_norm2")})

    def _shared_block(self, params: dict, x: torch.Tensor, *, kv_cache=None,
                      cache_index=None, tp=None) -> torch.Tensor:
        """The shared attention and MLP (``params``: their leaves,
        ``_shared``'s); under a route each in its tensor-parallel form, as
        ``DenseLM._layer``'s."""
        cfg = self.cfg

        def attn(p, h, rows):
            return attention_block(
                p, h, cfg, kv_cache=kv_cache, cache_index=cache_index,
                q_rows=rows, decode_attention=self.decode_attention,
                flash_attention=self.flash_attention)[0]

        x = x + _attention(tp, attn, params["shared_attn"],
                           rmsnorm(x, params["shared_norm1"], cfg.norm_eps))
        return x + _mlp(tp, lambda h: swiglu(params["shared_mlp"], h,
                                             cfg.compute_dtype),
                        rmsnorm(x, params["shared_norm2"], cfg.norm_eps))

    def _group(self, x: torch.Tensor, shared: dict, glp: SSMLayer,
               tp=None) -> torch.Tensor:
        """One group: the shared block (``shared``, its gathered leaves),
        then the group's SSM layers, each gathering its own leaves when it
        runs (``MambaLM._layer``)."""
        x = self._shared_block(shared, x, tp=tp)
        for lp in unstack(glp):
            x = self._layer(x, lp, tp)
        return x

    def _trunk(self, params: dict, h: torch.Tensor, tp=None) -> torch.Tensor:
        """Every group without a cache; ``remat="block"`` checkpoints each
        group, as the reference remats its group scan. Under a route the
        groups get it as an argument, so a checkpoint's recompute in the
        backward runs the same route."""
        group = self._group if tp is None else functools.partial(
            self._group, tp=tp)
        shared = self._shared(params)
        for glp in unstack(params["layers"]):
            h = self._remat(group, h, shared, glp)
        return self._final_norm(params, h)

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

    def _cached_trunk(self, params: dict, h: torch.Tensor, cache: dict,
                      tp=None) -> tuple[torch.Tensor, dict]:
        """Every group against its KV cache and states, in place; under a
        route each leaf holds what ``DenseLM._cached_trunk`` and
        ``MambaLM._cached_trunk`` say of it."""
        cfg, idx, st = self.cfg, cache["index"], cache["state"]
        shared = self._shared(params)
        for g, (glp, gst) in enumerate(zip(unstack(params["layers"]),
                                           unstack(st))):
            h = self._shared_block(shared, h,
                                   kv_cache=(cache["k"][g], cache["v"][g]),
                                   cache_index=idx, tp=tp)
            for lp, state in zip(unstack(glp), unstack(gst)):
                h = _ssm_step(cfg, lp, h, state, self.ssd_scan, tp)
        h = self._final_norm(params, h)
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
    Hkv, hd), which prefill writes in place and decode reads.

    Under a tensor-parallel route the decoder takes the decoder's plan and
    the encoder its own (``Route.encoder``), each sublayer in its mode, the
    cross-attention in the decoder's (``Route.cross_attention``); the
    cache then holds what ``sharding.tp_cache`` lays out: the self K/V as
    ``DenseLM``'s, the cross K/V the rank's heads where they split, else
    whole."""

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
    def _enc_layer(self, x: torch.Tensor, lp: EncLayer, tp=None
                   ) -> torch.Tensor:
        """One encoder layer, its leaves gathered first; under the
        encoder's route each sublayer in its tensor-parallel form."""
        cfg = self.cfg
        lp = shd.gather_layer(lp)

        def attn(p, h, rows):
            return attention_block(p, h, cfg, causal=False, use_rope=False,
                                   q_rows=rows)[0]

        x = x + _attention(tp, attn, lp.attn,
                           rmsnorm(x, lp.norm1, cfg.norm_eps))
        return x + _mlp(tp, lambda h: swiglu(lp.mlp, h, cfg.compute_dtype),
                        rmsnorm(x, lp.norm2, cfg.norm_eps))

    def encode(self, params: dict, frames: torch.Tensor, tp=None
               ) -> torch.Tensor:
        """frames: (B, T_enc, d) precomputed embeddings (stub frontend).
        ``tp``: the encoder's route; the output is then in its residual's
        layout (the rank's slice where sequence-parallel)."""
        cfg = self.cfg
        h = frames.to(cfg.compute_dtype) + _sinusoid(
            frames.shape[1], cfg.d_model, cfg.compute_dtype, frames.device)
        layer = self._enc_layer
        if tp is not None:
            layer = functools.partial(self._enc_layer, tp=tp)
            if tp.sp:
                h = tp.split_seq(h)
        for lp in unstack(params["enc_layers"]):
            h = self._remat(layer, h, lp)
        return rmsnorm(h, shd.gather_layer(params["enc_norm"]), cfg.norm_eps)

    def _cross_kv(self, params: dict, enc_out: torch.Tensor, tp=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """Every decoder layer's cross K and V, each (L, B, T_enc, Hkv,
        hd): the encoder's output times each layer's ``cross_attn.wk`` /
        ``wv``, a layer at a time through ``_remat`` (``_cross_layer``).
        Under a route, the heads the rank's ``wk`` / ``wv`` hold (its KV
        head's columns under "kv_replicated")."""
        ca = params["dec_layers"].cross_attn
        kv = [self._remat(self._cross_layer, enc_out, wk, wv, tp)
              for wk, wv in zip(unstack(ca.wk), unstack(ca.wv))]
        return tuple(torch.stack(x) for x in zip(*kv))

    def _cross_layer(self, enc_out: torch.Tensor, wk, wv, tp=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """One decoder layer's cross K and V, (B, T_enc, Hkv, hd), its
        ``wk`` and ``wv`` gathered first."""
        cfg = self.cfg
        B, Te, _ = enc_out.shape
        ws = shd.gather_layer((wk, wv))
        if tp is not None and tp.plan.heads == "kv_replicated":
            ws = tuple(tp.kv_slice(w) for w in ws)
        return tuple((enc_out @ w.to(cfg.compute_dtype)).reshape(
            B, Te, w.shape[-1] // cfg.hd, cfg.hd) for w in ws)

    def _encoded(self, params: dict, frames: torch.Tensor, tp=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """The cross K/V of ``frames``: the encoder under its route, its
        output whole on every rank (``Route.memory``)."""
        if tp is None:
            return self._cross_kv(params, self.encode(params, frames))
        enc = tp.encoder
        return self._cross_kv(
            params, tp.memory(enc, self.encode(params, frames, enc)), tp)

    # -- decoder --------------------------------------------------------------
    def _dec_layer(self, x: torch.Tensor, lp: DecLayer,
                   cross_k: torch.Tensor, cross_v: torch.Tensor,
                   kv_cache=None, index=None, tp=None, split=None
                   ) -> torch.Tensor:
        """One decoder layer, its leaves gathered first but the
        cross-attention's ``wk`` and ``wv`` (its K/V are ``cross_k`` and
        ``cross_v``, ``_cross_kv``'s); under a route each sublayer in its
        tensor-parallel form, ``split`` the self K/V's block of positions
        (``Route.kv_split``)."""
        cfg = self.cfg
        lp = shd.gather_layer(lp._replace(
            cross_attn=lp.cross_attn._replace(wk=None, wv=None)))

        def self_attn(p, h, rows):
            return attention_block(
                p, h, cfg, kv_cache=kv_cache, cache_index=index, q_rows=rows,
                kv_split=split, decode_attention=self.decode_attention,
                flash_attention=self.flash_attention)[0]

        def cross_attn(p, h, rows):
            return attention_block(p, h, cfg, cross_kv=(cross_k, cross_v),
                                   q_rows=rows)[0]

        x = x + _attention(tp, self_attn, lp.self_attn,
                           rmsnorm(x, lp.norm1, cfg.norm_eps))
        x = x + _cross_attention(tp, cross_attn, lp.cross_attn,
                                 rmsnorm(x, lp.norm2, cfg.norm_eps))
        return x + _mlp(tp, lambda h: swiglu(lp.mlp, h, cfg.compute_dtype),
                        rmsnorm(x, lp.norm3, cfg.norm_eps))

    def _decoder(self, params: dict, h: torch.Tensor,
                 cross_kv: tuple[torch.Tensor, torch.Tensor],
                 cache: dict | None = None, tp=None) -> torch.Tensor:
        """Every decoder layer: without a cache each through ``_remat``;
        with one, its K/V written in place at ``cache["index"]`` (no remat,
        as in the reference). Under a route the layers get it as an
        argument, so a checkpoint's recompute in the backward runs it
        too."""
        layer = self._dec_layer if tp is None else functools.partial(
            self._dec_layer, tp=tp)
        split = None if tp is None else tp.kv_split
        layers = zip(unstack(params["dec_layers"]), *(t.unbind(0)
                                                      for t in cross_kv))
        for i, (lp, ck, cv) in enumerate(layers):
            if cache is None:
                h = self._remat(layer, h, lp, ck, cv)
            else:
                h = layer(h, lp, ck, cv, (cache["k"][i], cache["v"][i]),
                          cache["index"], split=split)
        return self._final_norm(params, h)

    def loss_fn(self, params: dict, batch: dict) -> torch.Tensor:
        """Mean next-token NLL of the decoder; needs ``batch["frames"]``.
        Under a route the NLL as ``DecoderLM._nll``'s (whisper-tiny's
        vocab is whole at m = 16: each rank's own positions' logits)."""
        tokens = batch["tokens"]
        tp = self._routed(params, "train", tokens.shape[1], tokens.shape[0])
        cross_kv = self._encoded(params, batch["frames"], tp)
        h = self._decoder(params, self._embed(params, tokens, tp=tp),
                          cross_kv, tp=tp)
        return self._nll(params, h, batch, tp)

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

    def prefill(self, params: dict, batch: dict, cache: dict, *,
                cache_len: int | None = None) -> tuple[torch.Tensor, dict]:
        """Encodes ``batch["frames"]`` (B, enc_len, d), writes the cross
        K/V into the cache in place, then runs the prompt's tokens through
        the decoder into the cache; ``index`` advances by T. ``cache_len``
        as ``DecoderLM.prefill``'s."""
        cfg = self.cfg
        frames, tokens = batch["frames"], batch["tokens"]
        if frames.shape[1] != cfg.enc_len:
            raise ValueError(f"{frames.shape[1]} frames, the cache holds "
                             f"enc_len {cfg.enc_len}")
        tp = self._routed(params, "prefill", tokens.shape[1],
                          tokens.shape[0], cache_len)
        for leaf, new in zip((cache["cross_k"], cache["cross_v"]),
                             self._encoded(params, frames, tp)):
            leaf.copy_(new)
        h = self._decoder(params, self._embed(params, tokens, tp=tp),
                          (cache["cross_k"], cache["cross_v"]), cache, tp)
        return (self._logits(params, h[:, -1:], tp),
                {**cache, "index": cache["index"] + h.shape[1]})

    def decode(self, params: dict, tokens: torch.Tensor, cache: dict, *,
               cache_len: int | None = None) -> tuple[torch.Tensor, dict]:
        """One token a slot against the cache; ``cache_len`` as
        ``prefill``'s."""
        tp = self._routed(params, "decode", 1, tokens.shape[0], cache_len)
        h = self._decoder(params, self._embed(params, tokens, tp=tp),
                          (cache["cross_k"], cache["cross_v"]), cache, tp)
        return (self._logits(params, h, tp),
                {**cache, "index": cache["index"] + 1})


_FAMILIES = {"dense": DenseLM, "vlm": DenseLM, "moe": MoELM, "ssm": MambaLM,
             "hybrid": HybridLM, "encdec": EncDecLM}


def build_model(cfg: ArchConfig, *, device: str | torch.device = "cuda"
                ) -> DecoderLM:
    return _FAMILIES[cfg.family](cfg, device=device)
