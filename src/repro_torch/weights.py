"""Bridge from the reference's parameters to the port's.

Takes a flat dict of numpy arrays keyed by path, ``"embed"``,
``"final_norm"``, ``"lm_head"`` and ``"layers/<attn|mlp>/<name>"`` or
``"layers/norm1"``, as a JAX param pytree flattens with
``jax.tree_util.tree_flatten_with_path``. The port never sees a JAX type.

Layouts: per-layer arrays stay stacked on axis 0, as in the reference (so
the port's optimizer sees the reference's shapes). Matrices keep the reference's (in, out)
layout and are applied as ``x @ w`` (no transpose into ``nn.Linear``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import AttnParams
from repro_torch.models.common import ArchConfig
from repro_torch.models.ffn import MLPParams
from repro_torch.models.transformer import DenseLayer


def dense_params_from_flat(flat: dict[str, np.ndarray], cfg: ArchConfig,
                           device: str | torch.device) -> dict:
    """The port's ``DenseLM`` params from a reference ``DenseLM`` param
    dict flattened by path, cast to ``cfg.param_dtype`` on ``device``."""
    want = {"embed", "final_norm", "lm_head", "layers/norm1", "layers/norm2",
            *(f"layers/attn/{n}" for n in AttnParams._fields),
            *(f"layers/mlp/{n}" for n in MLPParams._fields)}
    if set(flat) != want:
        raise KeyError(f"param paths differ: missing {sorted(want - set(flat))}"
                       f", unexpected {sorted(set(flat) - want)}")

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=cfg.param_dtype)

    stacked = {path: tensor(a) for path, a in flat.items()}
    for path, t in stacked.items():
        if path.startswith("layers/") and t.shape[0] != cfg.n_layers:
            raise ValueError(f"{path}: {t.shape[0]} layers stacked, config "
                             f"has {cfg.n_layers}")

    layers = DenseLayer(
        AttnParams(*(stacked[f"layers/attn/{n}"] for n in AttnParams._fields)),
        MLPParams(*(stacked[f"layers/mlp/{n}"] for n in MLPParams._fields)),
        stacked["layers/norm1"], stacked["layers/norm2"])
    return {"embed": stacked["embed"], "layers": layers,
            "final_norm": stacked["final_norm"],
            "lm_head": stacked["lm_head"]}
