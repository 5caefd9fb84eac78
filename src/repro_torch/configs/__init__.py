"""Architecture registry: ``get_config(arch_id)`` returns the exact
published config, with the same ids as ``repro/configs/__init__.py``."""
from __future__ import annotations

from importlib import import_module

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
