"""Dispatch transports: the seam between control plane and data plane.

The port's copy of ``repro/core/transport.py``, whole: both transports and
the wire codecs, so the two packages' workers and services speak one wire.

``FlowMeshEngine._start_next`` hands every admitted ``DispatchBatch`` to a
``Transport`` instead of calling its executor directly. Two implementations:

  * ``InProcessTransport`` — executes synchronously through the engine's
    executor, exactly as the engine always did. ``dispatch`` returns the
    ``ExecResult``; virtual time, RNG consumption, and event order are
    byte-identical to the pre-transport engine, which is what keeps the
    tier-1 suite (and every journal/trace equality proof) deterministic.
  * ``LeaseTransport`` — the out-of-process data plane (DESIGN.md §13).
    ``dispatch`` parks the batch as an *offer* for the target lane and
    returns None; a real worker process (``python -m
    repro_torch.launch.worker_main``) long-polls
    ``POST /worker/lease``, claims the offer under a heartbeat-renewed,
    epoch-fenced lease, executes with its own executor, and reports back
    through ``POST /worker/complete``. Liveness is wall-clock: ``tick()``
    (driven from ``FabricService.pump``) expires lapsed leases and silent
    lanes, returning their groups to READY through the engine's existing
    ``GroupRequeued`` crash path — journaled, so replay, followers, and
    traces agree without knowing leases exist.

Lease fencing mirrors the journal's ref fencing one level down: every
grant takes the next value of a transport-wide monotone epoch counter, and
any heartbeat/complete carrying a lease id that is no longer current is
refused (``FencedLease``) — a worker that vanished and came back cannot
publish a result for work the control plane already re-dispatched.
"""
from __future__ import annotations

import base64
import time

from . import events as E
from .cost_model import DEVICE_CLASSES
from .dag import OperatorSpec, OpType
from .worker import (DispatchBatch, ExecResult, ExecutionGroup, Executor,
                     Worker, WorkerState)


class UnknownWorker(Exception):
    """The lane is not registered (or its engine worker is no longer
    ACTIVE) — the worker process must re-register before polling again."""


class FencedLease(Exception):
    """The presented lease is not the lane's current one: it expired, was
    superseded, or belongs to a lane the control plane already failed.
    Results arriving under a fenced lease are discarded — the groups were
    requeued and may already be running elsewhere."""


class Transport:
    """Where a dispatched batch executes.

    ``dispatch`` either returns an ``ExecResult`` (the batch ran
    synchronously, in-process semantics) or ``None`` (the batch was handed
    to a remote lessee; the engine parks the lane until the transport calls
    ``engine.remote_batch_done`` / ``engine.remote_lane_lost``)."""

    #: True when dispatch hands work to out-of-process lessees — the
    #: service skips bootstrap lanes and workers join by registration
    remote = False

    def bind(self, engine) -> None:
        self.engine = engine

    def dispatch(self, batch: DispatchBatch, worker: Worker,
                 cas) -> ExecResult | None:
        raise NotImplementedError

    def revoke(self, worker: Worker) -> str | None:
        """Cancel the batch currently placed on ``worker``. Returns the
        revoked lease id ("" for a still-unclaimed offer) when this
        transport owned that batch and took it back — the engine then
        finishes its groups — or None when it cannot (in-process batches
        run to completion)."""
        return None

    def tick(self) -> None:
        """Wall-clock liveness pass; no-op for synchronous transports."""

    def status(self) -> dict:
        return {"transport": type(self).__name__, "remote": self.remote}


class InProcessTransport(Transport):
    """Synchronous execution through the engine's executor — the default,
    and deliberately revoke-incapable: an in-process batch runs to
    completion (its ``batch_done`` is already queued in virtual time), so
    cancellation keeps today's run-to-completion semantics and the tier-1
    traces stay bit-identical."""

    def __init__(self, executor: Executor) -> None:
        self.executor = executor

    def dispatch(self, batch, worker, cas):
        return self.executor.execute(batch, worker, cas)


# ---------------------------------------------------------------------------
# wire format (HTTP data plane)
# ---------------------------------------------------------------------------
_SPEC_WIRE_FIELDS = ("name", "model_id", "revision", "resource_class",
                     "tokens_in", "tokens_out", "train_tokens")


def spec_to_wire(spec: OperatorSpec) -> dict:
    d = {k: getattr(spec, k) for k in _SPEC_WIRE_FIELDS}
    d["op_type"] = spec.op_type.value
    d["adapters"] = list(spec.adapters)
    d["params"] = spec.params
    return d


def spec_from_wire(d: dict) -> OperatorSpec:
    """Rebuild an executor-sufficient spec. ``inputs`` stay empty: identity
    (H_task/H_exec) was computed control-plane-side and travels on the
    group; the worker only needs the execution-relevant fields."""
    return OperatorSpec(
        name=d["name"], op_type=OpType(d["op_type"]),
        model_id=d["model_id"], revision=d["revision"],
        adapters=tuple(d["adapters"]), params=dict(d["params"]),
        inputs=[], resource_class=d["resource_class"],
        tokens_in=d["tokens_in"], tokens_out=d["tokens_out"],
        train_tokens=d["train_tokens"])


def batch_to_wire(batch: DispatchBatch) -> dict:
    return {
        "batch_id": batch.batch_id,
        "h_exec": batch.h_exec,
        "worker_id": batch.worker_id,
        "admitted_at": batch.admitted_at,
        "speculative": batch.speculative,
        "groups": [{
            "h_task": g.h_task, "h_exec": g.h_exec,
            "input_hashes": list(g.input_hashes),
            "spec": spec_to_wire(g.spec),
        } for g in batch.groups],
    }


def batch_from_wire(d: dict) -> DispatchBatch:
    groups = [ExecutionGroup(
        h_task=g["h_task"], h_exec=g["h_exec"],
        spec=spec_from_wire(g["spec"]),
        input_hashes=tuple(g["input_hashes"])) for g in d["groups"]]
    return DispatchBatch(
        batch_id=d["batch_id"], h_exec=d["h_exec"], groups=groups,
        worker_id=d["worker_id"], admitted_at=d["admitted_at"],
        speculative=d["speculative"])


def result_to_wire(r: ExecResult) -> dict:
    # outputs are raw bytes (CAS blobs): base64 keeps the control-plane
    # publish path (`cas.publish(bytes)`) identical for local and remote
    return {
        "outputs": [base64.b64encode(
            o if isinstance(o, bytes) else str(o).encode()).decode()
            for o in r.outputs],
        "duration_s": r.duration_s, "load_s": r.load_s, "flops": r.flops,
        "energy_j": r.energy_j, "failed": r.failed, "failure": r.failure,
    }


def result_from_wire(d: dict) -> ExecResult:
    return ExecResult(
        outputs=[base64.b64decode(o) for o in d["outputs"]],
        duration_s=d["duration_s"], load_s=d["load_s"], flops=d["flops"],
        energy_j=d["energy_j"], failed=d["failed"], failure=d["failure"])


# ---------------------------------------------------------------------------
class _Lane:
    """One registered remote worker process (wall-clock liveness)."""
    __slots__ = ("worker_id", "device_class", "last_seen")

    def __init__(self, worker_id: str, device_class: str,
                 last_seen: float) -> None:
        self.worker_id = worker_id
        self.device_class = device_class
        self.last_seen = last_seen


class _Lease:
    __slots__ = ("lease_id", "epoch", "batch", "worker_id", "deadline",
                 "granted", "revoked")

    def __init__(self, lease_id: str, epoch: int, batch: DispatchBatch,
                 worker_id: str, deadline: float, granted: float) -> None:
        self.lease_id = lease_id
        self.epoch = epoch
        self.batch = batch
        self.worker_id = worker_id
        self.deadline = deadline
        self.granted = granted
        self.revoked = False


class LeaseTransport(Transport):
    """HTTP long-poll data plane: offers, fenced leases, wall-clock TTLs.

    All methods run under the service lock (HTTP handler threads and the
    pump thread serialize through it), so no internal locking is needed.
    ``clock`` is injectable for deterministic lease-lifecycle tests.
    """

    remote = True

    def __init__(self, *, lease_ttl_s: float = 10.0,
                 lane_ttl_s: float | None = None,
                 heartbeat_s: float | None = None,
                 clock=time.monotonic) -> None:
        self.lease_ttl_s = lease_ttl_s
        #: a lane with no lease must check in (poll/heartbeat) this often
        #: or it is declared dead — covers workers that die while idle or
        #: with an undelivered offer parked on them
        self.lane_ttl_s = lane_ttl_s if lane_ttl_s is not None \
            else 1.5 * lease_ttl_s
        #: renewal interval advertised to workers at registration
        self.heartbeat_s = heartbeat_s if heartbeat_s is not None \
            else lease_ttl_s / 4.0
        self.clock = clock
        self.engine = None
        self.lanes: dict[str, _Lane] = {}
        self.offers: dict[str, DispatchBatch] = {}
        self.leases: dict[str, _Lease] = {}
        #: transport-wide fencing epoch: bumped per grant, so lease ids are
        #: totally ordered and a stale holder can never impersonate the
        #: current one (same shape as the journal's ref epochs, §10)
        self.epoch = 0

    # ---------------------------------------------------- engine-facing ----
    def dispatch(self, batch, worker, cas):
        self.offers[worker.worker_id] = batch
        return None

    def revoke(self, worker) -> str | None:
        wid = worker.worker_id
        if self.offers.pop(wid, None) is not None:
            return ""                       # never granted: just take it back
        lease = self.leases.get(wid)
        if lease is not None and not lease.revoked:
            lease.revoked = True
            # the worker has one TTL to observe the revoke (heartbeat or
            # complete); heartbeats no longer renew a revoked lease
            lease.deadline = self.clock() + self.lease_ttl_s
            return lease.lease_id
        return None

    def tick(self) -> None:
        eng = self.engine
        if eng is None:
            return
        now = self.clock()
        for wid in list(self.lanes):
            lease = self.leases.get(wid)
            if lease is not None:
                if now < lease.deadline:
                    continue
                del self.leases[wid]
                if not lease.revoked:
                    # a revoked lease's groups were already finished at
                    # revoke time; only a live lapse narrates an expiry
                    eng._emit(E.LeaseExpired(
                        worker=wid, batch_id=lease.batch.batch_id,
                        lease_id=lease.lease_id, epoch=lease.epoch,
                        held_s=now - lease.granted))
                self._drop_lane(wid)
                eng.remote_lane_lost(wid)
            elif now - self.lanes[wid].last_seen > self.lane_ttl_s:
                # silent lane death: idle worker gone, or an offer the
                # worker never came back to claim
                self._drop_lane(wid)
                eng.remote_lane_lost(wid)

    def _drop_lane(self, wid: str) -> None:
        self.lanes.pop(wid, None)
        self.offers.pop(wid, None)
        self.leases.pop(wid, None)

    # ---------------------------------------------------- worker-facing ----
    def register(self, worker_id: str, device_class: str) -> dict:
        if device_class not in DEVICE_CLASSES:
            raise KeyError(device_class)
        # the engine may suffix the id (a crashed lane's name is taken by
        # its DEAD record) — the worker adopts whatever comes back
        wid = self.engine.register_remote_worker(worker_id, device_class)
        self.lanes[wid] = _Lane(wid, device_class, self.clock())
        return {"worker_id": wid, "heartbeat_s": self.heartbeat_s,
                "lease_ttl_s": self.lease_ttl_s}

    def poll(self, worker_id: str) -> dict | None:
        """Claim the lane's pending offer (if any) under a fresh lease.
        Every poll — empty or not — refreshes lane liveness, so a worker
        blocked in a long-poll never trips the lane TTL."""
        lane = self.lanes.get(worker_id)
        if lane is None:
            raise UnknownWorker(worker_id)
        eng = self.engine
        w = eng.workers.get(worker_id)
        if w is None or w.state is not WorkerState.ACTIVE:
            # autoscaler-retired or failed while the worker was away
            self._drop_lane(worker_id)
            raise UnknownWorker(worker_id)
        now = self.clock()
        lane.last_seen = now
        # an engine-side check-in too: the virtual watchdog must not fail a
        # lane whose only liveness signal arrives over the wire
        w.last_heartbeat = eng.now
        if worker_id in self.leases:
            # a worker polling while the control plane thinks it holds a
            # lease has lost its own state (restart): fail the lane so its
            # batch requeues, and make the worker start over
            self._drop_lane(worker_id)
            eng.remote_lane_lost(worker_id)
            raise UnknownWorker(worker_id)
        batch = self.offers.pop(worker_id, None)
        if batch is None:
            return None
        self.epoch += 1
        lease = _Lease(
            lease_id=f"{worker_id}/{batch.batch_id}/{self.epoch}",
            epoch=self.epoch, batch=batch, worker_id=worker_id,
            deadline=now + self.lease_ttl_s, granted=now)
        self.leases[worker_id] = lease
        eng._emit(E.LeaseGranted(
            worker=worker_id, batch_id=batch.batch_id,
            lease_id=lease.lease_id, epoch=lease.epoch,
            h_exec=batch.h_exec, n_groups=len(batch.groups)))
        return {"lease_id": lease.lease_id, "epoch": lease.epoch,
                "heartbeat_s": self.heartbeat_s,
                "batch": batch_to_wire(batch)}

    def _current_lease(self, worker_id: str, lease_id: str) -> _Lease:
        lane = self.lanes.get(worker_id)
        lease = self.leases.get(worker_id)
        if lane is None or lease is None or lease.lease_id != lease_id:
            raise FencedLease(lease_id)
        lane.last_seen = self.clock()
        w = self.engine.workers.get(worker_id)
        if w is not None:
            w.last_heartbeat = self.engine.now
        return lease

    def heartbeat(self, worker_id: str, lease_id: str) -> dict:
        lease = self._current_lease(worker_id, lease_id)
        if lease.revoked:
            # the ack the revoke path waits for: the lease dies here, the
            # lane stays live for new work
            del self.leases[worker_id]
            return {"ok": False, "revoked": True}
        lease.deadline = self.clock() + self.lease_ttl_s
        return {"ok": True, "revoked": False}

    def complete(self, worker_id: str, lease_id: str,
                 result_wire: dict) -> dict:
        lease = self._current_lease(worker_id, lease_id)
        del self.leases[worker_id]
        if lease.revoked:
            return {"ok": False, "revoked": True}
        eng = self.engine
        w = eng.workers.get(worker_id)
        if w is None or w.current is None \
                or w.current.batch_id != lease.batch.batch_id:
            raise FencedLease(lease_id)
        # lease.batch is the engine's own DispatchBatch object (consumers,
        # dispatch_tenants, speculation state intact) — the wire only
        # carries the result back
        eng.remote_batch_done(w, lease.batch, result_from_wire(result_wire))
        return {"ok": True, "revoked": False}

    # -------------------------------------------------------------- obs ----
    def status(self) -> dict:
        return {
            "transport": "lease", "remote": True, "epoch": self.epoch,
            "lease_ttl_s": self.lease_ttl_s, "lane_ttl_s": self.lane_ttl_s,
            "lanes": sorted(self.lanes),
            "offers": {wid: b.batch_id for wid, b in self.offers.items()},
            "leases": [{
                "worker": l.worker_id, "lease_id": l.lease_id,
                "epoch": l.epoch, "batch_id": l.batch.batch_id,
                "revoked": l.revoked,
            } for l in self.leases.values()],
        }
