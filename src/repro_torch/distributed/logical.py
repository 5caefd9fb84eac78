"""Logical-axis activation sharding (counterpart of
``repro/distributed/logical.py``).

Model code may name an activation's axes logically (``constrain(h,
"batch", "seq", "embed")``); ``install`` maps the logical names to the
axes of a ``DeviceMesh`` for the current thread. With no policy installed,
or on a plain tensor, ``constrain`` is a no-op; on a ``DTensor`` it
redistributes to the placements the rules give. The port's model code
runs on local tensors, so it pins no activation this way: the policy also
carries the mesh's ``"model"`` process group (``model_group``), over which
``tensor_parallel`` runs the dense and vlm families' collectives where the
reference pins its activations.

``P``, the stand-in for ``jax.sharding.PartitionSpec``, and
``placements``, which turns a spec into DTensor placements, live here
because this module imports nothing of the models: ``sharding`` imports
both from here.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any

from torch.distributed.tensor import DTensor, Replicate, Shard

_state = threading.local()


class P(tuple):
    """A partition spec: one entry per tensor dim, each a mesh axis name,
    a tuple of names (the dim sharded over all of them, the first major)
    or None (not sharded). A one-name tuple is stored as the name, as
    ``PartitionSpec`` normalises it, so specs compare entry for entry with
    the reference's."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def placements(mesh, spec: P) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: mesh dim j is
    ``Shard(i)`` where ``spec[i]`` names axis j, else ``Replicate()``. A
    dim sharded over several axes needs them in the mesh's order (DTensor
    shards a dim over mesh dims major to minor, as a spec entry lists
    them)."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else entry or ()
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: axes {axes} out of the mesh's order "
                             f"{names}")
        for j in dims:
            out[j] = Shard(i)
    return out


DEFAULT_RULES = {
    "batch": None,        # filled with ("pod","data")/("data",) at install
    "seq": None,
    "embed": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "experts": "model",
    "state": None,
    "q_seq": "model",     # S^2 score tensors: query dim over model
    "seq_res": "model",   # sequence-parallel residuals (training trunks)
}


def install(mesh, rules: dict[str, Any] | None = None) -> None:
    """Maps the logical names to ``mesh``'s axes for this thread."""
    r = dict(DEFAULT_RULES)
    r["batch"] = (("pod", "data") if "pod" in mesh.mesh_dim_names
                  else ("data",))
    if rules:
        r.update(rules)
    _state.mesh = mesh
    _state.rules = r
    _state.group = (mesh.get_group("model")
                    if "model" in mesh.mesh_dim_names else None)


def clear() -> None:
    _state.mesh = None
    _state.rules = None
    _state.group = None


@contextlib.contextmanager
def policy(mesh, rules: dict[str, Any] | None = None):
    """``install`` for the block; on exit the policy installed before it,
    if any, is back."""
    before = (getattr(_state, "mesh", None), getattr(_state, "rules", None),
              getattr(_state, "group", None))
    install(mesh, rules)
    try:
        yield
    finally:
        _state.mesh, _state.rules, _state.group = before


def active() -> bool:
    return getattr(_state, "mesh", None) is not None


def current_mesh():
    return getattr(_state, "mesh", None)


def model_group():
    """The installed mesh's ``"model"`` process group, or None (no policy,
    or a mesh without that axis)."""
    return getattr(_state, "group", None)


def constrain(x, *logical_axes: str | None):
    """Pins a DTensor's placements by logical axis names (None = a
    replicated dim); a plain tensor, or any tensor with no policy
    installed, is returned as it is."""
    mesh = getattr(_state, "mesh", None)
    if mesh is None or not isinstance(x, DTensor):
        return x
    rules = _state.rules
    spec = P(*(rules.get(a) if a else None for a in logical_axes))
    return x.redistribute(mesh, placements(mesh, spec))
