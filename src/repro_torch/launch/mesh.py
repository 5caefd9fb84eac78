"""Production mesh builders (counterpart of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module starts no
process group and touches no device.

Mesh axes, over the ranks of the current process group:
  single-pod : (data=16, model=16)            — 256 H100s (32 nodes of 8)
  multi-pod  : (pod=2, data=16, model=16)     — 512 H100s (64 nodes of 8)

"pod" is pure data parallelism across the two halves (gradient all-reduce
crosses them), plus extra parameter sharding for the 1T-parameter cells.

``fake_world(n)`` is the counterpart of the reference's
``--xla_force_host_platform_device_count``: a process group of ``n``
ranks in which this process is rank 0 (or ``rank``) and every collective
returns at once without moving data (PyTorch's ``"fake"`` backend), so one
process builds and counts one rank's step of a 256- or 512-rank job.
"""
from __future__ import annotations

import contextlib
import importlib.util

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

_FAKE_PG = "torch.testing._internal.distributed.fake_pg"


def _device_type() -> str:
    """The ranks' device: the card under NCCL, else the CPU (gloo, and
    the fake group of a dry run, whose tensors are on ``meta``)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_test_mesh(n_devices: int | None = None):
    """Small mesh over the current group's ranks (unit tests: 8 gloo
    ranks)."""
    n = n_devices or dist.get_world_size()
    model = 2 if n % 2 == 0 else 1
    return init_device_mesh(_device_type(), (n // model, model),
                            mesh_dim_names=("data", "model"))


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that shard the batch dimension."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def n_chips(mesh) -> int:
    return mesh.size()


def fake_pg_available() -> bool:
    """Whether this PyTorch ships the ``"fake"`` process-group backend."""
    return importlib.util.find_spec(_FAKE_PG) is not None


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A ``"fake"`` process group of ``n`` ranks, this process ``rank``
    (0 by default: a q_seq plan's heaviest rank is the last along
    ``"model"``), for the duration of the block; destroyed on exit."""
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world needs no process group started")
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} is not one of {n}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
        # DTensor caches its sharding decisions by mesh, and the meshes of
        # two worlds compare equal while a rank's groups are named after
        # the rank (rank 15's data group "16", rank 0's "1"): a decision
        # cached here would name a group the next world lacks
        _clear_sharding_prop_cache()
