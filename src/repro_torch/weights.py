"""Bridge from the reference's parameters to the port's.

Takes a flat dict of numpy arrays keyed by path, as a JAX param pytree
flattens with ``jax.tree_util.tree_flatten_with_path``: ``"embed"``,
``"final_norm"``, ``"lm_head"`` and the layer leaves, ``"layers/<attn|mlp>/
<name>"`` and ``"layers/norm1"`` for the dense LM (the MoE LM has
``"layers/moe/<name>"`` and ``"layers/moe/shared/<name>"`` in place of the
MLP), ``"layers/mamba/<field>"`` and ``"layers/norm"`` for the SSM LM,
which the hybrid extends with ``"shared_attn/<name>"``,
``"shared_mlp/<name>"`` and ``"shared_norm1/2"``.
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
from repro_torch.models.transformer import DenseLayer, MoELayer, SSMLayer

# leaves the reference keeps in fp32 whatever the param dtype
_FP32 = {*(f"layers/mamba/{n}" for n in ("dt_bias", "A_log", "D")),
         "layers/moe/router"}


def _tensors(flat: dict[str, np.ndarray], want: set[str], cfg: ArchConfig,
             device: str | torch.device,
             layer_lead: tuple[int, ...]) -> dict[str, torch.Tensor]:
    """Every wanted path as a tensor on ``device`` in ``cfg.param_dtype``
    (the reference's fp32 leaves in fp32); the ``layers/`` leaves must lead
    with ``layer_lead``."""
    if set(flat) != want:
        raise KeyError(f"param paths differ: missing {sorted(want - set(flat))}"
                       f", unexpected {sorted(set(flat) - want)}")
    out = {}
    for path, a in flat.items():
        dtype = torch.float32 if path in _FP32 else cfg.param_dtype
        t = torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                          dtype=dtype)
        if path.startswith("layers/") and \
                tuple(t.shape[:len(layer_lead)]) != layer_lead:
            raise ValueError(f"{path}: leading shape {tuple(t.shape)}, "
                             f"config stacks {layer_lead}")
        out[path] = t
    return out


def _top(t: dict[str, torch.Tensor]) -> dict:
    return {"embed": t["embed"], "final_norm": t["final_norm"],
            "lm_head": t["lm_head"]}


def _fields(prefix: str, names) -> set[str]:
    return {f"{prefix}/{n}" for n in names}


def dense_params_from_flat(flat: dict[str, np.ndarray], cfg: ArchConfig,
                           device: str | torch.device) -> dict:
    """The port's ``DenseLM`` params from a reference ``DenseLM`` param
    dict flattened by path, cast to ``cfg.param_dtype`` on ``device``."""
    want = {"embed", "final_norm", "lm_head", "layers/norm1", "layers/norm2",
            *_fields("layers/attn", AttnParams._fields),
            *_fields("layers/mlp", MLPParams._fields)}
    t = _tensors(flat, want, cfg, device, (cfg.n_layers,))
    layers = DenseLayer(
        AttnParams(*(t[f"layers/attn/{n}"] for n in AttnParams._fields)),
        MLPParams(*(t[f"layers/mlp/{n}"] for n in MLPParams._fields)),
        t["layers/norm1"], t["layers/norm2"])
    return {**_top(t), "layers": layers}


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
    t = _tensors(flat, want, cfg, device, (cfg.n_layers,))
    shared = None
    if cfg.n_shared_experts:
        shared = MLPParams(*(t[f"layers/moe/shared/{n}"]
                             for n in MLPParams._fields))
    layers = MoELayer(
        AttnParams(*(t[f"layers/attn/{n}"] for n in AttnParams._fields)),
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
    t = _tensors(flat, _SSM_PATHS, cfg, device, (cfg.n_layers,))
    return {**_top(t), "layers": _ssm_layers(t)}


def hybrid_params_from_flat(flat: dict[str, np.ndarray], cfg: ArchConfig,
                            device: str | torch.device) -> dict:
    """The port's ``HybridLM`` params from a reference ``HybridLM`` param
    dict flattened by path; layer leaves (groups, per_group, ...)."""
    want = {*_SSM_PATHS, "shared_norm1", "shared_norm2",
            *_fields("shared_attn", AttnParams._fields),
            *_fields("shared_mlp", MLPParams._fields)}
    lead = (cfg.n_layers // max(cfg.attn_every, 1), cfg.attn_every)
    t = _tensors(flat, want, cfg, device, lead)
    return {**_top(t), "layers": _ssm_layers(t),
            "shared_attn": AttnParams(*(t[f"shared_attn/{n}"]
                                        for n in AttnParams._fields)),
            "shared_mlp": MLPParams(*(t[f"shared_mlp/{n}"]
                                      for n in MLPParams._fields)),
            "shared_norm1": t["shared_norm1"],
            "shared_norm2": t["shared_norm2"]}
