"""Data plane: stateless workers behaving as persistent serving lanes.

A worker is logically stateless — all durable data lives in the CAS — but
*operationally* warm: it keeps model weights / adapters / recent artifacts
resident, which the control plane rewards through ``G_loc`` (Eq. 1). Each
worker maintains live admission queues ``Q_j(H_exec)`` into which the control
plane continuously streams compatible slices of work.
"""
from __future__ import annotations

import enum
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any

from .cost_model import CostMeter, DeviceClass, model_bytes
from .dag import OperatorSpec


class WorkerState(enum.Enum):
    PROVISIONING = "provisioning"
    ACTIVE = "active"
    DRAINING = "draining"
    DEAD = "dead"


@dataclass
class TaskInstance:
    """One (dag, operator) occurrence — the consumer-side unit."""
    dag_id: str
    op_name: str
    tenant: str = "default"    # owning tenant (admission metering / fair share)
    #: absolute workflow deadline (submitted_at + deadline_s metadata), or
    #: None — admission folds this into fair share as an EDF-flavored boost
    deadline_at: float | None = None


@dataclass
class ExecutionGroup:
    """All ready operators across DAGs that share one H_task (dedup unit).

    Executed at most once; the artifact fans out to every consumer. Additional
    consumers may attach while the group is queued or running.
    """
    h_task: str
    h_exec: str
    spec: OperatorSpec                      # representative spec
    input_hashes: tuple[str, ...]
    consumers: list[TaskInstance] = field(default_factory=list)
    ready_at: float = 0.0
    dispatch_at: float | None = None
    #: tenants recorded at first dispatch — the billing fallback when every
    #: consumer cancels mid-flight (work that ran must still be charged)
    dispatch_tenants: tuple[str, ...] = ()
    attempts: int = 0
    running_on: set[str] = field(default_factory=set)   # workers (speculation)
    done: bool = False

    @property
    def fanout(self) -> int:
        return len(self.consumers)


@dataclass
class DispatchBatch:
    """One admitted slice: groups sharing H_exec, microbatched on a worker."""
    batch_id: int
    h_exec: str
    groups: list[ExecutionGroup]
    worker_id: str
    admitted_at: float
    speculative: bool = False

    @property
    def size(self) -> int:
        return len(self.groups)


class ResidentSet:
    """LRU of models resident in a worker's VRAM (weights stay hot)."""

    def __init__(self, vram_gb: float) -> None:
        self.vram_gb = vram_gb
        self._models: OrderedDict[str, float] = OrderedDict()  # h_model -> GB
        self._used = 0.0                     # running total of resident GB

    def has(self, h_model: str) -> bool:
        return h_model in self._models

    def touch(self, h_model: str, size_gb: float) -> list[str]:
        """Make resident; returns evicted h_models. A model larger than the
        weight budget is refused outright — evicting everything would still
        not fit, and admitting it anyway would push ``used_gb`` past the
        budget and let ``G_loc`` reward an impossible placement."""
        evicted: list[str] = []
        if h_model in self._models:
            self._models.move_to_end(h_model)
            return evicted
        budget = self.vram_gb * 0.9
        if size_gb > budget:
            return evicted
        while self._models and self._used + size_gb > budget:
            old, gb = self._models.popitem(last=False)
            self._used -= gb
            evicted.append(old)
        if not self._models:
            self._used = 0.0                 # kill float drift at empty
        self._models[h_model] = size_gb
        self._used += size_gb
        return evicted

    @property
    def used_gb(self) -> float:
        return self._used


class Worker:
    """A stateless executor lane on one device (or one sharded mesh slice)."""

    MAX_QUEUED_SLICES = 2   # keep admission continuous, not bulk-assigned

    def __init__(self, worker_id: str, dev: DeviceClass, *, now: float,
                 perf_noise: float = 1.0, backend: str = "sim") -> None:
        self.worker_id = worker_id
        self.dev = dev
        self.state = WorkerState.PROVISIONING
        self.resident = ResidentSet(dev.vram_gb)
        self.local_cache: set[str] = set()       # artifact hashes on local disk
        self.queues: dict[str, deque[DispatchBatch]] = {}
        self.current: DispatchBatch | None = None
        self.busy_until = now
        self.last_heartbeat = now
        self.meter = CostMeter(dev, provisioned_at=now)
        self.perf_noise = perf_noise             # worker-specific speed jitter
        self.backend = backend
        self.idle_since: float | None = None
        self.served_execs: set[str] = set()      # H_execs this lane is hot for
        self._queued = 0                         # invariant: sum(len(q) for q)
        #: round-robin cursor over ``queues`` — keys in service order; the
        #: lane at the front serves next and rotates to the back
        self._lane_order: deque[str] = deque()

    # -- admission -----------------------------------------------------------
    def queued_slices(self) -> int:
        # O(1): the scheduler polls this per candidate per round
        return self._queued + (1 if self.current else 0)

    def can_admit(self) -> bool:
        return (self.state is WorkerState.ACTIVE
                and self.queued_slices() < self.MAX_QUEUED_SLICES)

    def admit(self, batch: DispatchBatch) -> None:
        q = self.queues.get(batch.h_exec)
        if q is None:
            q = self.queues[batch.h_exec] = deque()
            self._lane_order.append(batch.h_exec)
        q.append(batch)
        self._queued += 1
        self.served_execs.add(batch.h_exec)
        self.idle_since = None

    def next_batch(self) -> DispatchBatch | None:
        # true round-robin across lanes (FIFO within a lane): the serving
        # lane rotates to the back, so sustained load on one H_exec cannot
        # starve later-admitted lanes
        order = self._lane_order
        if not order:
            return None
        h_exec = order[0]
        order.rotate(-1)
        q = self.queues[h_exec]
        batch = q.popleft()
        self._queued -= 1
        if not q:
            del self.queues[h_exec]
            order.pop()                      # h_exec just rotated to the back
        return batch

    def drain(self) -> list[DispatchBatch]:
        """Remove all queued (not yet running) slices — used when retiring.
        Lane-affinity state goes with them: a draining/retired lane is no
        longer hot for anything, and stale ``served_execs`` / ``idle_since``
        would keep it ranking in G_loc and the autoscaler's idle scan."""
        out: list[DispatchBatch] = []
        for q in self.queues.values():
            out.extend(q)
        self.queues.clear()
        self._lane_order.clear()
        self._queued = 0
        self.served_execs.clear()
        self.idle_since = None
        return out

    # -- locality ------------------------------------------------------------
    def is_hot_for(self, h_model: str) -> bool:
        return self.resident.has(h_model)

    def make_resident(self, h_model: str, model_id: str) -> None:
        self.resident.touch(h_model, model_bytes(model_id) / 1e9)


class Executor:
    """Runtime that actually performs a batch. Implementations:
    SimExecutor (virtual time, analytic durations) and TorchExecutor (real
    PyTorch compute). Returns one output per group plus resource usage."""

    def execute(self, batch: DispatchBatch, worker: Worker, cas) -> "ExecResult":
        raise NotImplementedError


@dataclass
class ExecResult:
    outputs: list[Any]          # one object per group, in order
    duration_s: float           # excludes model load
    load_s: float               # cold-start component (0 when hot)
    flops: float = 0.0
    energy_j: float | None = None   # None => engine integrates power*time
    failed: bool = False
    failure: str | None = None      # e.g. "resource_shortage"
