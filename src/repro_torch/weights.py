"""Bridge from the reference's parameters to the port's.

Takes a flat dict of numpy arrays keyed by path, as a JAX param pytree
flattens with ``jax.tree_util.tree_flatten_with_path``: ``"embed"``,
``"final_norm"``, ``"lm_head"`` and the layer leaves, ``"layers/<attn|mlp>/
<name>"`` and ``"layers/norm1"`` for the dense LM (the MoE LM has
``"layers/moe/<name>"`` and ``"layers/moe/shared/<name>"`` in place of the
MLP; the vlm backbone adds ``"patch_proj"``), ``"layers/mamba/<field>"``
and ``"layers/norm"`` for the SSM LM, which the hybrid extends with
``"shared_attn/<name>"``, ``"shared_mlp/<name>"`` and ``"shared_norm1/2"``;
the enc-dec LM has ``"enc_layers/<attn|mlp>/<name>"``,
``"enc_layers/norm1|2"``, ``"dec_layers/<self_attn|cross_attn|mlp>/<name>"``,
``"dec_layers/norm1|2|3"`` and ``"enc_norm"`` in place of ``"layers/"``.
The port never sees a JAX type.

Layouts: layer leaves stay stacked as in the reference, on axis 0 (L, ...)
or, for the hybrid, on (groups, per_group, ...), so the port's optimizer
sees the reference's shapes. Matrices keep the reference's (in, out)
layout and are applied as ``x @ w`` (no transpose into ``nn.Linear``).
Missing or unexpected paths raise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import AttnParams
from repro_torch.models.common import ArchConfig
from repro_torch.models.ffn import MLPParams, MoEParams
from repro_torch.models.mamba2 import Mamba2Params
from repro_torch.models.transformer import (DecLayer, DenseLayer, EncLayer,
                                            MoELayer, SSMLayer)

# leaves the reference keeps in fp32 whatever the param dtype
_FP32 = {*(f"layers/mamba/{n}" for n in ("dt_bias", "A_log", "D")),
         "layers/moe/router"}


def _tensors(flat: dict[str, np.ndarray], want: set[str], cfg: ArchConfig,
             device: str | torch.device,
             leads: dict[str, tuple[int, ...]]) -> dict[str, torch.Tensor]:
    """Every wanted path as a tensor on ``device`` in ``cfg.param_dtype``
    (the reference's fp32 leaves in fp32); the leaves of each stack in
    ``leads`` (``"layers"``, or ``"enc_layers"`` and ``"dec_layers"``) must
    lead with its shape."""
    if set(flat) != want:
        raise KeyError(f"param paths differ: missing {sorted(want - set(flat))}"
                       f", unexpected {sorted(set(flat) - want)}")
    out = {}
    for path, a in flat.items():
        dtype = torch.float32 if path in _FP32 else cfg.param_dtype
        t = torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                          dtype=dtype)
        lead = leads.get(path.split("/")[0])
        if lead is not None and tuple(t.shape[:len(lead)]) != lead:
            raise ValueError(f"{path}: leading shape {tuple(t.shape)}, "
                             f"config stacks {lead}")
        out[path] = t
    return out


def _top(t: dict[str, torch.Tensor]) -> dict:
    return {"embed": t["embed"], "final_norm": t["final_norm"],
            "lm_head": t["lm_head"]}


def _fields(prefix: str, names) -> set[str]:
    return {f"{prefix}/{n}" for n in names}


def _attn(t: dict[str, torch.Tensor], prefix: str) -> AttnParams:
    return AttnParams(*(t[f"{prefix}/{n}"] for n in AttnParams._fields))


def _mlp(t: dict[str, torch.Tensor], prefix: str) -> MLPParams:
    return MLPParams(*(t[f"{prefix}/{n}"] for n in MLPParams._fields))


def dense_params_from_flat(flat: dict[str, np.ndarray], cfg: ArchConfig,
                           device: str | torch.device) -> dict:
    """The port's ``DenseLM`` params from a reference ``DenseLM`` param
    dict flattened by path, cast to ``cfg.param_dtype`` on ``device``;
    ``patch_proj`` exactly when the family is vlm."""
    want = {"embed", "final_norm", "lm_head", "layers/norm1", "layers/norm2",
            *_fields("layers/attn", AttnParams._fields),
            *_fields("layers/mlp", MLPParams._fields)}
    if cfg.family == "vlm":
        want.add("patch_proj")
    t = _tensors(flat, want, cfg, device, {"layers": (cfg.n_layers,)})
    layers = DenseLayer(_attn(t, "layers/attn"), _mlp(t, "layers/mlp"),
                        t["layers/norm1"], t["layers/norm2"])
    params = {**_top(t), "layers": layers}
    if cfg.family == "vlm":
        params["patch_proj"] = t["patch_proj"]
    return params


def encdec_params_from_flat(flat: dict[str, np.ndarray], cfg: ArchConfig,
                            device: str | torch.device) -> dict:
    """The port's ``EncDecLM`` params from a reference ``EncDecLM`` param
    dict flattened by path; encoder leaves (n_enc_layers, ...), decoder
    leaves (n_layers, ...)."""
    want = {"embed", "final_norm", "lm_head", "enc_norm",
            "enc_layers/norm1", "enc_layers/norm2",
            *_fields("dec_layers", ("norm1", "norm2", "norm3")),
            *(p for attn in ("enc_layers/attn", "dec_layers/self_attn",
                             "dec_layers/cross_attn")
              for p in _fields(attn, AttnParams._fields)),
            *_fields("enc_layers/mlp", MLPParams._fields),
            *_fields("dec_layers/mlp", MLPParams._fields)}
    t = _tensors(flat, want, cfg, device,
                 {"enc_layers": (cfg.n_enc_layers,),
                  "dec_layers": (cfg.n_layers,)})
    enc = EncLayer(_attn(t, "enc_layers/attn"), _mlp(t, "enc_layers/mlp"),
                   t["enc_layers/norm1"], t["enc_layers/norm2"])
    dec = DecLayer(_attn(t, "dec_layers/self_attn"),
                   _attn(t, "dec_layers/cross_attn"),
                   _mlp(t, "dec_layers/mlp"), t["dec_layers/norm1"],
                   t["dec_layers/norm2"], t["dec_layers/norm3"])
    return {**_top(t), "enc_layers": enc, "dec_layers": dec,
            "enc_norm": t["enc_norm"]}


def moe_params_from_flat(flat: dict[str, np.ndarray], cfg: ArchConfig,
                         device: str | torch.device) -> dict:
    """The port's ``MoELM`` params from a reference ``MoELM`` param dict
    flattened by path; the shared experts' paths exactly when
    ``n_shared_experts > 0``, the router in fp32."""
    routed = [n for n in MoEParams._fields if n != "shared"]
    want = {"embed", "final_norm", "lm_head", "layers/norm1", "layers/norm2",
            *_fields("layers/attn", AttnParams._fields),
            *_fields("layers/moe", routed)}
    if cfg.n_shared_experts:
        want |= _fields("layers/moe/shared", MLPParams._fields)
    t = _tensors(flat, want, cfg, device, {"layers": (cfg.n_layers,)})
    shared = _mlp(t, "layers/moe/shared") if cfg.n_shared_experts else None
    layers = MoELayer(
        _attn(t, "layers/attn"),
        MoEParams(*(t[f"layers/moe/{n}"] for n in routed), shared),
        t["layers/norm1"], t["layers/norm2"])
    return {**_top(t), "layers": layers}


_SSM_PATHS = {"embed", "final_norm", "lm_head", "layers/norm",
              *_fields("layers/mamba", Mamba2Params._fields)}


def _ssm_layers(t: dict[str, torch.Tensor]) -> SSMLayer:
    return SSMLayer(Mamba2Params(*(t[f"layers/mamba/{n}"]
                                   for n in Mamba2Params._fields)),
                    t["layers/norm"])


def ssm_params_from_flat(flat: dict[str, np.ndarray], cfg: ArchConfig,
                         device: str | torch.device) -> dict:
    """The port's ``MambaLM`` params from a reference ``MambaLM`` param
    dict flattened by path; layer leaves (L, ...)."""
    t = _tensors(flat, _SSM_PATHS, cfg, device, {"layers": (cfg.n_layers,)})
    return {**_top(t), "layers": _ssm_layers(t)}


def hybrid_params_from_flat(flat: dict[str, np.ndarray], cfg: ArchConfig,
                            device: str | torch.device) -> dict:
    """The port's ``HybridLM`` params from a reference ``HybridLM`` param
    dict flattened by path; layer leaves (groups, per_group, ...)."""
    want = {*_SSM_PATHS, "shared_norm1", "shared_norm2",
            *_fields("shared_attn", AttnParams._fields),
            *_fields("shared_mlp", MLPParams._fields)}
    lead = (cfg.n_layers // max(cfg.attn_every, 1), cfg.attn_every)
    t = _tensors(flat, want, cfg, device, {"layers": lead})
    return {**_top(t), "layers": _ssm_layers(t),
            "shared_attn": _attn(t, "shared_attn"),
            "shared_mlp": _mlp(t, "shared_mlp"),
            "shared_norm1": t["shared_norm1"],
            "shared_norm2": t["shared_norm2"]}
