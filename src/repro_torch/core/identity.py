"""Deterministic operator identity — the heart of FlowMesh's consolidation.

Implements the paper's two hashes (§3):

    H_task = hash(H_model, canonical(P), H_in_1..n)      # full execution context
    H_exec = hash(H_model, canonical(P\resource-irrelevant), resource_class)

``H_task`` equality  => the computations are byte-identical => execute at most
once (unification by identity / dedup).
``H_exec`` equality  => same executor + weights + hyperparameters, different
inputs => batch-compatible (consolidation by execution signature).
"""
from __future__ import annotations

import hashlib
import json
from collections.abc import Mapping, Sequence   # abc fast-path isinstance
from typing import Any

HASH_LEN = 20  # hex chars kept; 80 bits — collision-safe at fabric scale


def _stable(obj: Any) -> Any:
    """Recursively convert to a JSON-stable structure with sorted keys."""
    if isinstance(obj, Mapping):
        return {str(k): _stable(obj[k]) for k in sorted(obj, key=str)}
    if isinstance(obj, (list, tuple)):
        return [_stable(x) for x in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(_stable(x) for x in obj)
    if isinstance(obj, float):
        # canonicalize floats so 1.0 and 1 hash identically across tenants
        return repr(float(obj))
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    return repr(obj)


def canonical(params: Mapping[str, Any] | None) -> str:
    """The paper's ``canonical(P)``: deterministic serialization of
    hyperparameters + resource hints. Key order, float formatting and container
    types are all normalized so semantically identical specs collide."""
    if not params:
        return "{}"         # the common no-hyperparameter case, pre-rendered
    return json.dumps(_stable(params), sort_keys=True, separators=(",", ":"))


def digest(*parts: str | bytes) -> str:
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, str):
            p = p.encode("utf-8")
        h.update(len(p).to_bytes(8, "little"))  # length-prefix: no ambiguity
        h.update(p)
    return h.hexdigest()[:HASH_LEN]


def model_hash(model_id: str, revision: str = "main",
               adapters: Sequence[str] = ()) -> str:
    """H_model digests the executor model (base id + revision + adapter set)."""
    return digest("model", model_id, revision, *sorted(adapters))


def task_hash(h_model: str, params: Mapping[str, Any] | None,
              input_hashes: Sequence[str]) -> str:
    """H_task — full execution context. Inputs are ORDERED (positional lineage)."""
    return digest("task", h_model, canonical(params), *input_hashes)


def task_hash_pre(h_model: str, canon_params: str,
                  input_hashes: Sequence[str]) -> str:
    """``task_hash`` for callers that already hold ``canonical(P)`` — the
    DAG memoizes the stripped-params canonical once per operator so the
    ready-promotion hot path does not re-serialize it per instance."""
    return digest("task", h_model, canon_params, *input_hashes)


# Resource hints that do not change the *semantics* of the computation are
# excluded from H_exec's parameter digest (the paper: H_exec "deliberately
# omits the input hashes"; resource hints only matter via resource_class).
_RESOURCE_HINT_KEYS = frozenset({
    "resource_class", "min_vram_gb", "gpu_class", "priority", "slo_ms",
    "tenant", "deadline_s", "affinity", "anti_affinity",
})


def strip_resource_hints(params: Mapping[str, Any] | None) -> dict:
    return {k: v for k, v in (params or {}).items()
            if k not in _RESOURCE_HINT_KEYS}


def exec_signature(h_model: str, params: Mapping[str, Any] | None,
                   resource_class: str) -> str:
    """H_exec — batch compatibility: same model+hyperparams+resource class,
    inputs deliberately omitted."""
    return digest("exec", h_model, canonical(strip_resource_hints(params)),
                  resource_class)


def exec_signature_pre(h_model: str, canon_params: str,
                       resource_class: str) -> str:
    """``exec_signature`` over a pre-canonicalized stripped-params string
    (see ``task_hash_pre``)."""
    return digest("exec", h_model, canon_params, resource_class)


def content_hash(data: bytes) -> str:
    """CAS artifact name: hash of the bytes themselves."""
    return digest("cas", data)
