"""Architecture registry and input-shape cells (counterpart of
``repro/configs/__init__.py``).

``get_config(arch_id)`` returns the exact published config, with the
reference's ids; ``input_specs(arch_id, shape_id)`` returns a ``meta``
tensor for every model input of that (arch x shape) cell and
``cache_specs`` the decode cell's cache as ``meta`` tensors: shapes and
dtypes with no storage behind them (the dry-run contract, zero
allocation).
"""
from __future__ import annotations

from dataclasses import dataclass
from importlib import import_module

import torch

from repro_torch.models.common import ArchConfig

_MODULES = {
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "minitron-4b": "minitron_4b",
    "smollm-360m": "smollm_360m",
    "smollm-135m": "smollm_135m",
    "whisper-tiny": "whisper_tiny",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "zamba2-2.7b": "zamba2_2_7b",
    "llava-next-34b": "llava_next_34b",
    "mamba2-1.3b": "mamba2_1_3b",
    # the paper's own §5 models (extra, not part of the 40-cell table)
    "llama-3.2-1b": "llama3_2_1b",
    "llama-3.1-8b": "llama3_1_8b",
}

#: the 10 assigned architectures (40-cell table rows)
ASSIGNED = [k for k in _MODULES if not k.startswith("llama")]


def get_config(arch_id: str) -> ArchConfig:
    mod = import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
    subquadratic_only: bool = False


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1,
                           subquadratic_only=True),
}

#: families with O(1)-state decode (eligible for long_500k)
SUBQUADRATIC_FAMILIES = {"ssm", "hybrid"}


def cell_runnable(cfg: ArchConfig, shape: ShapeCell) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) — see DESIGN.md shape-cell skips."""
    if shape.subquadratic_only and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, ("full-attention arch: 500k dense-KV decode is "
                       "out of contract (sub-quadratic-only cell)")
    return True, ""


def cell_inputs(cfg: ArchConfig, kind: str, B: int, S: int, *,
                device: str | torch.device = "meta") -> dict:
    """Empty tensors for every model input of a (kind, B, S) cell of
    ``cfg``: tokens (+ labels) for train, the request batch for prefill,
    one new token per sequence for decode (the cache comes from
    ``cache_specs``). A vlm's S counts its patches before the text; an
    enc-dec's frames are (B, enc_len, d)."""
    tok = lambda *shape: torch.empty(shape, dtype=torch.int32, device=device)
    emb = lambda *shape: torch.empty(shape, dtype=cfg.compute_dtype,
                                     device=device)
    if kind == "decode":
        return {"tokens": tok(B, 1)}
    text = S - cfg.n_patches if cfg.family == "vlm" else S
    specs = {"tokens": tok(B, text)}
    if kind == "train":
        specs["labels"] = tok(B, text)
    if cfg.family == "encdec":
        specs["frames"] = emb(B, cfg.enc_len, cfg.d_model)
    if cfg.family == "vlm":
        specs["patch_embeds"] = emb(B, cfg.n_patches, cfg.d_model)
    return specs


def _cell(arch_id: str, shape_id: str, reduced: bool
          ) -> tuple[ArchConfig, ShapeCell, int, int]:
    cfg = get_config(arch_id)
    if reduced:
        cfg = cfg.reduced()
    shape = SHAPES[shape_id]
    B, S = shape.global_batch, shape.seq_len
    if reduced:
        B, S = 2, min(S, 64)
    return cfg, shape, B, S


def input_specs(arch_id: str, shape_id: str, *, reduced: bool = False,
                ) -> dict:
    """``meta`` stand-ins for every model input of the cell (int32 tokens
    and labels, frames and patch embeddings in the compute dtype)."""
    cfg, shape, B, S = _cell(arch_id, shape_id, reduced)
    return cell_inputs(cfg, shape.kind, B, S)


def cache_specs(arch_id: str, shape_id: str, *, reduced: bool = False) -> dict:
    """The decode cell's cache tree (``model.init_cache(B, S)``) as
    ``meta`` tensors."""
    from repro_torch.models.transformer import build_model
    cfg, _, B, S = _cell(arch_id, shape_id, reduced)
    return build_model(cfg, device="meta").init_cache(B, S)
