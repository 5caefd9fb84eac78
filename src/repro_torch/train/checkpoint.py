"""CAS-backed checkpointing (counterpart of ``repro/train/checkpoint.py``).

Every leaf tensor is an immutable content-addressed blob; a checkpoint is
a small JSON manifest (the state's structure, the leaf hashes, the step),
published by advancing the named ref ``checkpoint/<run>`` after the blobs
are written. Unchanged leaves are stored once across the whole history.

The leaf encoding is the reference's: a 4-byte little-endian header
length, a JSON header with the dtype name and shape, then the raw bytes;
bf16 leaves are their 2-byte patterns under the dtype name "bfloat16".
The manifest stores the port's own structure (dicts, lists, the model's
NamedTuples by name), not a pickled JAX treedef.
"""
from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from repro_torch.core.cas import CAS
from repro_torch.models.attention import AttnParams
from repro_torch.models.ffn import MLPParams, MoEParams
from repro_torch.models.mamba2 import Mamba2Params
from repro_torch.models.transformer import (DecLayer, DenseLayer, EncLayer,
                                            MoELayer, SSMLayer)

# every NamedTuple that params or optimizer state can hold: the dense and
# MoE layers, the SSM layers, the hybrid's shared attention and MLP, and
# the enc-dec's encoder and decoder layers
_NAMED = {c.__name__: c for c in (DenseLayer, AttnParams, MLPParams,
                                  MoELayer, MoEParams, SSMLayer,
                                  Mamba2Params, EncLayer, DecLayer)}


def _leaf_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        name, raw = "bfloat16", t.view(torch.int16).numpy().tobytes()
    else:
        arr = t.numpy()
        name, raw = str(arr.dtype), arr.tobytes()
    header = json.dumps({"dtype": name, "shape": list(t.shape)}).encode()
    return len(header).to_bytes(4, "little") + header + raw


def _bytes_leaf(data: bytes, device) -> torch.Tensor:
    n = int.from_bytes(data[:4], "little")
    meta = json.loads(data[4:4 + n])
    raw = data[4 + n:]
    if meta["dtype"] == "bfloat16":
        t = torch.from_numpy(np.frombuffer(raw, np.int16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(raw, meta["dtype"]).copy())
    return t.reshape(meta["shape"]).to(device)


def _structure(tree, leaves: list) -> Any:
    """JSON description of ``tree``; its tensors appended to ``leaves``."""
    if isinstance(tree, dict):
        return {"dict": {k: _structure(tree[k], leaves) for k in sorted(tree)}}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        name = type(tree).__name__
        if _NAMED.get(name) is not type(tree):
            # restore could not rebuild it: refuse to write the manifest
            raise TypeError(f"cannot checkpoint an unregistered NamedTuple "
                            f"{name}; add it to checkpoint._NAMED")
        return {"named": name,
                "items": [_structure(x, leaves) for x in tree]}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [_structure(x, leaves) for x in tree]}
    if tree is None:
        return None
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} leaf")
    leaves.append(tree)
    return {"leaf": len(leaves) - 1}


def _build(desc, leaves: list) -> Any:
    if desc is None:
        return None
    if "dict" in desc:
        return {k: _build(v, leaves) for k, v in desc["dict"].items()}
    if "named" in desc:
        return _NAMED[desc["named"]](*(_build(x, leaves)
                                       for x in desc["items"]))
    if "list" in desc:
        return [_build(x, leaves) for x in desc["list"]]
    if "tuple" in desc:
        return tuple(_build(x, leaves) for x in desc["tuple"])
    return leaves[desc["leaf"]]


class Checkpointer:
    def __init__(self, cas: CAS, run_name: str = "run") -> None:
        self.cas = cas
        self.run_name = run_name

    @property
    def _ref(self) -> str:
        return f"checkpoint/{self.run_name}"

    def save(self, state: Any, step: int, *, extra: dict | None = None) -> str:
        leaves: list[torch.Tensor] = []
        structure = _structure(state, leaves)
        manifest = {
            "step": step,
            "leaves": [self.cas.put_bytes(_leaf_bytes(t)) for t in leaves],
            "structure": structure,
            "extra": extra or {},
        }
        mhash = self.cas.put_bytes(json.dumps(manifest).encode())
        self.cas.set_ref(self._ref, mhash)     # blob first, then the pointer
        return mhash

    def restore(self, manifest_hash: str | None = None, *,
                device: str | torch.device = "cpu") -> tuple[Any, int, dict]:
        """(state with every leaf on ``device``, step, extra)."""
        mhash = manifest_hash or self.cas.get_ref(self._ref)
        if mhash is None:
            raise FileNotFoundError(f"no checkpoint for run {self.run_name}")
        manifest = json.loads(self.cas.get_bytes(mhash))
        leaves = [_bytes_leaf(self.cas.get_bytes(h), device)
                  for h in manifest["leaves"]]
        return (_build(manifest["structure"], leaves), manifest["step"],
                manifest["extra"])

    @property
    def latest(self) -> str | None:
        return self.cas.get_ref(self._ref)
