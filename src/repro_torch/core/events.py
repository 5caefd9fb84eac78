"""Typed control-plane events + the EventBus (DESIGN.md §7).

Every state transition the engine performs — an operator becoming ready, a
batch dispatching or completing, a worker leasing, failing or retiring, a
workflow finishing — is published as one typed ``FabricEvent`` on the
engine's ``EventBus``. Subscribers derive *all* downstream views from that
single stream:

  * ``Telemetry`` (core/telemetry.py) folds events into the paper's
    aggregate metrics — no handler mutates telemetry fields directly;
  * the ``EventJournal`` (core/journal.py) appends event batches to the CAS
    so a restarted fabric can replay its own history;
  * per-job feeds (fabric/service.py) stream op completions and lineage
    rows to tenants as they land.

Events are flat, JSON-shaped dataclasses: ``to_dict()``/``event_from_dict``
round-trip them for the journal and the HTTP feed. The bus assigns each
published event a monotonically increasing ``seq`` — the global cursor that
feeds and journal replay both key on.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Callable, ClassVar

#: kind -> event class, populated by @register (journal replay / feed decode)
EVENT_TYPES: dict[str, type["FabricEvent"]] = {}

#: per-class field-name tuples/sets, resolved once — ``dataclasses.fields``
#: walks the MRO on every call, far too slow for the publish hot path
_FIELD_NAMES: dict[type, tuple[str, ...]] = {}
_FIELD_SETS: dict[type, frozenset[str]] = {}


def register(cls: type["FabricEvent"]) -> type["FabricEvent"]:
    if cls.kind in EVENT_TYPES:
        raise ValueError(f"duplicate event kind {cls.kind!r}")
    EVENT_TYPES[cls.kind] = cls
    return cls


@dataclass(kw_only=True)
class FabricEvent:
    """Base event: wall/virtual time of the transition + bus sequence."""
    kind: ClassVar[str] = "event"
    time: float = 0.0
    seq: int = -1          # assigned by the bus at publish

    def to_dict(self) -> dict:
        """The event as one flat dict, serialized **once per publish** and
        shared by every subscriber (journal buffer, per-job feeds, replay
        folds). The cache is keyed on ``seq``: a dict built before the bus
        assigned the seq is rebuilt on the next call. Consumers treat the
        dict as frozen — anyone who must mutate copies first (the snapshot
        writer already does)."""
        sd = self.__dict__
        d = sd.get("_dcache")
        if d is not None and d["seq"] == sd["seq"]:
            return d
        cls = type(self)
        names = _FIELD_NAMES.get(cls)
        if names is None:
            names = _FIELD_NAMES[cls] = tuple(f.name for f in fields(cls))
        d = {"kind": self.kind}
        # field values read straight from the instance dict: dataclass
        # __init__ assigns every field there, and a plain dict probe beats
        # getattr's descriptor walk at one call per field per serialization
        for name in names:
            d[name] = sd[name]
        # not a dataclass field: invisible to fields()/__eq__/repr
        sd["_dcache"] = d
        return d


def event_from_dict(d: dict) -> FabricEvent:
    """Inverse of ``to_dict`` — unknown fields are dropped (forward compat:
    a journal written by a newer fabric still replays)."""
    cls = EVENT_TYPES.get(d.get("kind", "event"), FabricEvent)
    names = _FIELD_SETS.get(cls)
    if names is None:
        names = _FIELD_SETS[cls] = frozenset(f.name for f in fields(cls))
    return cls(**{k: v for k, v in d.items() if k in names})


# ---------------------------------------------------------------------------
# workflow lifecycle
# ---------------------------------------------------------------------------
@register
@dataclass(kw_only=True)
class WorkflowSubmitted(FabricEvent):
    """Submission accepted (published by ``Engine.submit`` with the arrival
    time, *before* the arrival event is consumed — the workflow may not be
    in ``engine.dags`` yet). Quota accounting and the journal both key on
    acceptance, so a cancel-before-arrival history is self-contained."""
    kind: ClassVar[str] = "workflow_submitted"
    dag_id: str
    tenant: str
    ops: tuple = ()            # operator names (restore rebuilds op states)
    metadata: dict = None      # type: ignore[assignment]

    def __post_init__(self) -> None:
        self.ops = tuple(self.ops)
        self.metadata = dict(self.metadata or {})


@register
@dataclass(kw_only=True)
class WorkflowCompleted(FabricEvent):
    kind: ClassVar[str] = "workflow_completed"
    dag_id: str
    tenant: str
    latency: float = 0.0
    #: workflow SLO carried from spec metadata (0.0 = none) — telemetry
    #: derives *realized* deadline misses from latency > deadline_s
    deadline_s: float = 0.0


@register
@dataclass(kw_only=True)
class WorkflowCancelled(FabricEvent):
    kind: ClassVar[str] = "workflow_cancelled"
    dag_id: str
    tenant: str


@register
@dataclass(kw_only=True)
class JobRejected(FabricEvent):
    """Service-level: failed admission, never entered the engine."""
    kind: ClassVar[str] = "job_rejected"
    dag_id: str
    tenant: str
    reason: str = ""
    ops: tuple = ()            # operator names (restored record keeps them)

    def __post_init__(self) -> None:
        self.ops = tuple(self.ops)


# ---------------------------------------------------------------------------
# operator lifecycle
# ---------------------------------------------------------------------------
@register
@dataclass(kw_only=True)
class OpReady(FabricEvent):
    """All inputs resolved; the operator entered the ready pool."""
    kind: ClassVar[str] = "op_ready"
    dag_id: str
    tenant: str
    op: str
    h_task: str = ""
    h_exec: str = ""


@register
@dataclass(kw_only=True)
class DedupHit(FabricEvent):
    """An op-instance satisfied without execution. ``source`` is "index"
    (result-index hit, dedup across time); fan-out savings of a shared run
    are carried on ``GroupCompleted`` instead."""
    kind: ClassVar[str] = "dedup_hit"
    dag_id: str
    tenant: str
    op: str
    h_task: str = ""
    source: str = "index"
    savings: int = 1


@register
@dataclass(kw_only=True)
class OpDispatched(FabricEvent):
    """First dispatch of an execution group (re-dispatch after a requeue
    does not re-emit — queue-wait is measured once, like the paper)."""
    kind: ClassVar[str] = "dispatch"
    h_task: str
    h_exec: str
    worker: str
    queue_wait: float = 0.0
    tenants: tuple = ()

    def __post_init__(self) -> None:
        self.tenants = tuple(self.tenants)


@register
@dataclass(kw_only=True)
class OpCompleted(FabricEvent):
    """One (dag, op) instance completed — the per-job lineage row.
    ``executed=False`` means satisfied by another tenant's run or the
    result index."""
    kind: ClassVar[str] = "op_completed"
    dag_id: str
    tenant: str
    op: str
    h_task: str = ""
    output_hash: str = ""
    executed: bool = False
    worker: str | None = None
    input_hashes: tuple = ()

    def __post_init__(self) -> None:
        self.input_hashes = tuple(self.input_hashes)


@register
@dataclass(kw_only=True)
class GroupCompleted(FabricEvent):
    """One physical execution finished (the dedup/batching unit). Carries
    the consumer fan-out and the chargeable cost so journal replay can
    rebuild per-tenant usage accounting."""
    kind: ClassVar[str] = "group_completed"
    h_task: str
    h_exec: str
    worker: str
    duration: float = 0.0
    output_hash: str = ""
    cost: float = 0.0          # $ for this group's share of the batch
    consumers: tuple = ()      # ((dag_id, op, tenant), ...) in consumer order
    #: tenants actually charged, in charge order (consumer tenants, or the
    #: dispatch-time tenants when every consumer cancelled mid-flight)
    billed: tuple = ()

    def __post_init__(self) -> None:
        self.consumers = tuple(tuple(c) for c in self.consumers)
        self.billed = tuple(self.billed)


@register
@dataclass(kw_only=True)
class GroupRequeued(FabricEvent):
    """A dispatched group left its worker without completing (worker crash
    or batch failure): it returned to READY — or was abandoned when every
    consumer cancelled / attempts ran out (``requeued=False``). Either way
    the tenants' in-flight admission slots are released on this event."""
    kind: ClassVar[str] = "group_requeued"
    h_task: str
    h_exec: str = ""
    worker: str = ""
    requeued: bool = True


# ---------------------------------------------------------------------------
# data-plane batches
# ---------------------------------------------------------------------------
@register
@dataclass(kw_only=True)
class BatchStarted(FabricEvent):
    kind: ClassVar[str] = "batch_started"
    worker: str
    h_exec: str
    n_groups: int = 1
    duration: float = 0.0      # predicted/measured service time incl. noise
    load_s: float = 0.0        # cold-start component (0 when hot)
    flops: float = 0.0
    model_id: str = ""


@register
@dataclass(kw_only=True)
class BatchDone(FabricEvent):
    kind: ClassVar[str] = "batch_done"
    worker: str
    h_exec: str
    n_groups: int = 1
    batch_size: int = 1        # sum of consumer fan-out across groups
    duration: float = 0.0


@register
@dataclass(kw_only=True)
class BatchFailed(FabricEvent):
    """Worker-reported failure (e.g. resource_shortage, §5.3)."""
    kind: ClassVar[str] = "batch_failed"
    worker: str
    h_exec: str
    failure: str = ""
    n_groups: int = 1
    duration: float = 0.0


@register
@dataclass(kw_only=True)
class SpeculativeLaunched(FabricEvent):
    kind: ClassVar[str] = "spec_launch"
    h_task: str
    worker: str


@register
@dataclass(kw_only=True)
class SpeculativeDiscarded(FabricEvent):
    """A rival replica already published — discarded by content identity."""
    kind: ClassVar[str] = "spec_discard"
    h_task: str
    worker: str


# ---------------------------------------------------------------------------
# worker-pool lifecycle
# ---------------------------------------------------------------------------
@register
@dataclass(kw_only=True)
class WorkerLeased(FabricEvent):
    kind: ClassVar[str] = "worker_lease"
    worker_id: str
    device_class: str = ""
    backend: str = ""
    ready_at: float = 0.0


@register
@dataclass(kw_only=True)
class LeaseGranted(FabricEvent):
    """A remote worker claimed an offered batch under a fenced lease
    (lease transport only, DESIGN.md §13). ``epoch`` is the transport-wide
    monotone grant counter — any heartbeat/complete carrying a superseded
    lease id is refused, so a worker that vanished and came back cannot
    publish a result for work the control plane already re-dispatched."""
    kind: ClassVar[str] = "lease_granted"
    worker: str
    batch_id: int = 0
    lease_id: str = ""
    epoch: int = 0
    h_exec: str = ""
    n_groups: int = 1


@register
@dataclass(kw_only=True)
class LeaseExpired(FabricEvent):
    """A live lease lapsed without renewal: the holder is presumed dead and
    the batch's groups return to READY through the ``GroupRequeued`` crash
    path. ``held_s`` is wall-clock grant→lapse time (virtual ``time`` on
    the event does not advance while the fabric waits on a remote)."""
    kind: ClassVar[str] = "lease_expired"
    worker: str
    batch_id: int = 0
    lease_id: str = ""
    epoch: int = 0
    held_s: float = 0.0


@register
@dataclass(kw_only=True)
class LeaseRevoked(FabricEvent):
    """The control plane took a placed batch back from a live lane —
    cancellation finally reaching *running* work. The lessee observes the
    revoke on its next heartbeat/complete; a result it still reports is
    discarded under the fence."""
    kind: ClassVar[str] = "lease_revoked"
    worker: str
    batch_id: int = 0
    lease_id: str = ""
    h_exec: str = ""


@register
@dataclass(kw_only=True)
class WorkerFailed(FabricEvent):
    """Watchdog declared the worker dead; RUNNING work returned to READY."""
    kind: ClassVar[str] = "worker_fail"
    worker_id: str
    detect_s: float = 0.0      # crash -> detection latency
    requeued: int = 0


@register
@dataclass(kw_only=True)
class WorkerRetired(FabricEvent):
    kind: ClassVar[str] = "worker_retire"
    worker_id: str


@register
@dataclass(kw_only=True)
class ScaleDecision(FabricEvent):
    """One autoscaler tick: the documented 4-tuple scaling-trace sample."""
    kind: ClassVar[str] = "scale_decision"
    active_workers: int = 0
    pending_depth: int = 0
    arriving_rate: float = 0.0     # workflow arrivals/s since the last tick
    leased: int = 0
    retired: int = 0


@register
@dataclass(kw_only=True)
class StallDetected(FabricEvent):
    """Starvation guard tripped: pending work no lane can ever serve."""
    kind: ClassVar[str] = "stall"
    pending: int = 0


@register
@dataclass(kw_only=True)
class CostSnapshot(FabricEvent):
    """Finalize-time roll-up of worker meters ($ / J are integrals, not
    transitions — snapshotted so telemetry stays event-derived)."""
    kind: ClassVar[str] = "cost_snapshot"
    total_cost: float = 0.0
    total_energy_j: float = 0.0


# ---------------------------------------------------------------------------
class EventBus:
    """Synchronous fan-out of control-plane events to subscribers.

    ``publish`` assigns each event a monotone global ``seq`` — the cursor
    contract: a reader that remembers the last seq it saw can resume with
    strictly-greater seqs and miss nothing, including across a journal
    replay (``advance_past`` keeps new seqs beyond replayed history).
    """

    def __init__(self) -> None:
        self._subs: list[Callable[[FabricEvent], None]] = []
        self._snapshot: tuple[Callable[[FabricEvent], None], ...] = ()
        self._next = 0

    def subscribe(self, fn: Callable[[FabricEvent], None]) -> Callable:
        self._subs.append(fn)
        self._snapshot = tuple(self._subs)
        return fn

    def unsubscribe(self, fn: Callable[[FabricEvent], None]) -> None:
        if fn in self._subs:
            self._subs.remove(fn)
            self._snapshot = tuple(self._subs)

    def publish(self, ev: FabricEvent) -> FabricEvent:
        seq = ev.seq
        if seq < 0:
            seq = ev.seq = self._next
        if seq >= self._next:
            self._next = seq + 1
        # iterate an immutable snapshot (rebuilt on (un)subscribe, never per
        # publish): a handler that mutates the subscription list mid-fan-out
        # sees the change on the NEXT publish, same as the list-copy it
        # replaces — without one list allocation per event
        for fn in self._snapshot:
            fn(ev)
        return ev

    def advance_past(self, seq: int) -> None:
        """Ensure future seqs are > ``seq`` (used after journal replay)."""
        self._next = max(self._next, seq + 1)
