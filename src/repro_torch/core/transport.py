"""Dispatch transports: the seam between control plane and data plane.

``FlowMeshEngine._start_next`` hands every admitted ``DispatchBatch`` to a
``Transport`` instead of calling its executor directly. The port has one
implementation so far, ``InProcessTransport``: it executes synchronously
through the engine's executor, so virtual time, RNG consumption, and event
order are the reference's. The reference's ``LeaseTransport`` (real worker
processes long-polling for leased batches, DESIGN.md §13) waits for the
port's out-of-process worker; the wire codecs it speaks are here.
"""
from __future__ import annotations

import base64

from .dag import OperatorSpec, OpType
from .worker import (DispatchBatch, ExecResult, ExecutionGroup, Executor,
                     Worker)


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
