"""FlowMesh engine: global control plane + elastic data plane.

One discrete-event engine drives both simulated (virtual-time, analytic cost)
and real (PyTorch compute, measured durations) execution — the control-plane
logic (consolidation, Eq. 1 scheduling, continuous admission, watchdog
recovery, speculation, autoscaling) is byte-identical across modes and across
scheduler policies, which is what makes the baseline comparisons fair.

The engine is **event-sourced** (DESIGN.md §7): every state transition is
published as a typed event on ``self.bus``; ``Telemetry`` derives all of its
aggregates as a bus subscriber, and further subscribers (the CAS journal,
per-job feeds) hang off the same stream. Handlers never poke telemetry
fields directly — the event log *is* the control plane's history.
"""
from __future__ import annotations

import heapq
import itertools
import random
import statistics
from dataclasses import dataclass, field
from typing import Any

from . import events as E
from .autoscaler import Autoscaler, AutoscalerConfig
from .backends import KubernetesBackend, Provisioner
from .cas import CAS
from .consolidation import ReadyPool
from .cost_model import DEVICE_CLASSES
from .dag import OpState, OperatorSpec, OpType, WorkflowDAG
from .events import EventBus
from .scheduler import (FlowMeshScheduler, SchedulerPolicy, feasible,
                        next_batch_id, vram_needed_gb)
from .telemetry import Telemetry
from .transport import InProcessTransport, Transport
from .worker import (DispatchBatch, ExecResult, ExecutionGroup, Executor,
                     Worker, WorkerState)


# ---------------------------------------------------------------------------
@dataclass(order=True)
class _Event:
    time: float
    seq: int
    kind: str = field(compare=False)
    payload: Any = field(compare=False, default=None)


@dataclass
class EngineConfig:
    heartbeat_s: float = 10.0
    watchdog_s: float = 30.0          # paper: detection after one full period
    speculation: bool = True
    spec_check_s: float = 15.0
    spec_factor: float = 2.5          # replicate when > factor * median
    max_attempts: int = 4
    #: admission coalescing window: same-instant ready ops form one slice
    dispatch_window_s: float = 0.25
    #: virtual-time stall guard: abort if no progress for this long
    stall_limit_s: float = 1800.0
    #: ring-buffer size for telemetry distribution fields (None = full
    #: history; set for never-restarting service deployments)
    telemetry_window: int | None = None
    #: fabric-level retention (a ``repro_torch.fabric.replay.RetentionPolicy``).
    #: Carried here so one config object provisions a whole service
    #: deployment; the engine itself never reads it — ``FabricService``
    #: resolves it with precedence: explicit arg > this field > default
    retention: Any = None
    seed: int = 0


class FlowMeshEngine:
    def __init__(self, *, policy: SchedulerPolicy | None = None,
                 executor: Executor, cas: CAS | None = None,
                 backend: Provisioner | None = None,
                 autoscaler: AutoscalerConfig | None = None,
                 config: EngineConfig | None = None,
                 admission: Any | None = None,
                 transport: Transport | None = None) -> None:
        self.policy = policy or FlowMeshScheduler()
        self.executor = executor
        #: where dispatched batches execute (DESIGN.md §13). The default
        #: in-process transport calls ``executor.execute`` synchronously —
        #: byte-identical to the pre-transport engine; a remote transport
        #: returns None from dispatch and calls back ``remote_batch_done``
        #: / ``remote_lane_lost`` when the lessee reports (or vanishes)
        self.transport = transport if transport is not None \
            else InProcessTransport(executor)
        self.transport.bind(self)
        # identity check, not truthiness: an *empty* CAS is falsy (len == 0),
        # and `cas or CAS()` would silently swap a fresh DiskCAS for an
        # in-memory store — artifacts (and the journal's replay contract)
        # would never reach disk
        self.cas = cas if cas is not None else CAS()
        self.backend = backend or KubernetesBackend()
        self.cfg = config or EngineConfig()
        self.autoscaler = Autoscaler(autoscaler or AutoscalerConfig(),
                                     self.backend)
        #: optional multi-tenant gate (see fabric.admission): filters/orders
        #: the ready pool before Eq. 1 scheduling. All of its *accounting*
        #: is event-derived — it is a bus subscriber, never called
        #: imperatively for usage mutations (one write path, DESIGN.md §8)
        self.admission = None
        self.rng = random.Random(self.cfg.seed)

        self.now = 0.0
        self._seq = itertools.count()
        self._events: list[_Event] = []
        self.dags: dict[str, WorkflowDAG] = {}
        self.pool = ReadyPool()
        self.workers: dict[str, Worker] = {}
        self.result_index: dict[str, str] = {}     # H_task -> output hash
        #: H_task -> dedup hit count, fed by DedupHit(source="index") events;
        #: retention uses it to keep frequently-re-derived results over
        #: merely-recent ones (LFU/recency hybrid — see replay.trim_result_index)
        self.result_index_hits: dict[str, int] = {}
        #: the control plane's single observable output stream; telemetry,
        #: journal, and job feeds are all subscribers
        self.bus = EventBus()
        self.telemetry = Telemetry(window=self.cfg.telemetry_window)
        self.bus.subscribe(self.telemetry.on_event)
        self.attach_admission(admission)
        self._arrivals_in_window = 0               # since last autoscale tick
        self._last_scale_t = 0.0
        self._service_times: dict[str, list[float]] = {}   # h_exec -> durations
        self._unfinished = 0
        self._inflight_batches = 0                 # batch_done events queued
        #: worker ids whose current batch is held by a remote lessee (no
        #: batch_done queued yet) + matching counters: ``_awaiting_remote``
        #: keeps ``step`` from spinning recurring timers up to the stall
        #: limit while the only pending work runs on a wall clock, and
        #: ``_real_events`` counts queued non-timer events so anything that
        #: *can* make progress still does
        self._remote_waiting: set[str] = set()
        self._awaiting_remote = 0
        self._real_events = 0
        self._armed: set[str] = set()              # recurring timers in-flight
        self._arrival_horizon = 0.0
        self._dispatch_pending = False
        self._last_progress = 0.0
        self.stalled = False
        self.cancelled: set[str] = set()           # dag_ids cancelled

    # ------------------------------------------------------------- events --
    _TIMER_KINDS = frozenset({"heartbeat", "watchdog", "spec_check",
                              "autoscale"})

    def _push(self, t: float, kind: str, payload: Any = None) -> None:
        if kind not in self._TIMER_KINDS:
            self._real_events += 1
        heapq.heappush(self._events, _Event(t, next(self._seq), kind, payload))

    def _emit(self, event: E.FabricEvent) -> E.FabricEvent:
        """Publish one control-plane event, stamped with the current time."""
        event.time = self.now
        return self.bus.publish(event)

    def attach_admission(self, admission: Any | None) -> None:
        """Install (or replace) the multi-tenant admission gate and wire its
        accounting to the bus — subscribing is what makes the controller's
        live bookkeeping and journal replay share exactly one body."""
        if self.admission is not None and self.admission is not admission:
            self.bus.unsubscribe(self.admission.on_event)
        self.admission = admission
        if admission is not None:
            self.bus.unsubscribe(admission.on_event)    # never twice
            self.bus.subscribe(admission.on_event)

    # ---------------------------------------------------------- public API --
    def bootstrap_workers(self, device_classes: list[str], *,
                          backend_name: str = "static") -> list[str]:
        """Provision a static pool, ACTIVE at t=0 (used by fixed-pool
        experiments and the elasticity-disabled ablation)."""
        ids = []
        for cls in device_classes:
            dev = DEVICE_CLASSES[cls]
            wid = f"{backend_name}-{cls}-{len(self.workers)}"
            w = Worker(wid, dev, now=self.now,
                       perf_noise=self.rng.uniform(0.92, 1.12),
                       backend=backend_name)
            w.state = WorkerState.ACTIVE
            w.idle_since = self.now
            self.workers[wid] = w
            ids.append(wid)
        return ids

    def submit(self, dag: WorkflowDAG, at: float = 0.0) -> None:
        if self.policy.monolithic:
            dag = self._monolithize(dag)
        at = max(at, self.now)        # live fabric: no arrivals in the past
        dag.submitted_at = at
        self._unfinished += 1
        self._arrival_horizon = max(self._arrival_horizon, at)
        # the submission is journaled history from the moment it is accepted
        # (not when the arrival event is consumed): quota accounting — an
        # event-bus subscriber — must see it before the next admission check,
        # and a cancel-before-arrival must leave a self-contained journal
        self.bus.publish(E.WorkflowSubmitted(
            time=at, dag_id=dag.dag_id, tenant=dag.tenant,
            ops=tuple(dag.ops), metadata=dict(dag.metadata)))
        self._push(at, "arrival", dag)

    def inject_crash(self, worker_id_or_index, at: float) -> None:
        self._push(at, "crash", worker_id_or_index)

    # -- continuous operation: the fabric drives the engine incrementally ----
    _RECURRING = {"heartbeat": "heartbeat_s", "watchdog": "watchdog_s",
                  "spec_check": "spec_check_s"}

    def _arm(self, kind: str) -> None:
        """Schedule one recurring timer event unless already in-flight."""
        if kind in self._armed:
            return
        if kind == "autoscale":
            period = self.autoscaler.cfg.tick_s
        else:
            period = getattr(self.cfg, self._RECURRING[kind])
        self._armed.add(kind)
        self._push(self.now + period, kind)

    def _arm_recurring(self) -> None:
        self._arm("heartbeat")
        self._arm("watchdog")
        # with a remote data plane, capacity is real worker processes
        # joining by registration — the autoscaler's simulated backend
        # leases would park offers on lanes no process will ever serve
        if not self.transport.remote:
            self._arm("autoscale")
        if self.cfg.speculation:
            self._arm("spec_check")

    @property
    def idle(self) -> bool:
        """True when no admitted workflow still has outstanding work AND no
        batch is mid-flight — a cancellation can zero out ``_unfinished``
        while a worker is still executing, and that run must still be
        drained (its result published, its usage billed)."""
        return (self._unfinished == 0 and self.now >= self._arrival_horizon
                and self._inflight_batches == 0)

    def step(self, until: float | None = None) -> bool:
        """Process exactly one event in virtual time.

        Returns False (and leaves the event queue untouched) when there is
        nothing to process — no events, the next event lies beyond
        ``until``, or pending work has made no progress for longer than the
        stall limit (starvation: work no lane can ever serve). This is the
        primitive the FabricService pumps: workflows can be submitted,
        cancelled, and queried between any two steps.
        """
        if not self._events:
            return False
        ev = self._events[0]
        if until is not None and ev.time > until:
            return False
        if not self._real_events and (
                self._awaiting_remote
                or (self.transport.remote and self._unfinished)):
            # every queued event is a recurring timer and the pending work
            # waits on the wall clock — a remote lessee executing, an offer
            # parked for a long-poll, or no lane registered yet. Hold
            # virtual time still (progress arrives via the transport)
            # instead of spinning timers up to the stall limit.
            return False
        if (self._unfinished and not self._real_events and
                ev.time - self._last_progress > self.cfg.stall_limit_s):
            # starvation means NOTHING real is coming: when a genuine event
            # (e.g. a batch_done for a training batch longer than the stall
            # limit) is queued behind the timers, declaring a stall here
            # would wedge the engine forever — the timer at the heap head
            # would never pop, so the real event could never be reached
            if not self.stalled:           # emit once per stall onset
                self.stalled = True
                self._emit(E.StallDetected(pending=self._unfinished))
            return False
        heapq.heappop(self._events)
        if ev.kind not in self._TIMER_KINDS:
            self._real_events -= 1
        self.now = max(self.now, ev.time)
        if ev.kind in self._RECURRING or ev.kind == "autoscale":
            self._armed.discard(ev.kind)
        getattr(self, f"_on_{ev.kind}")(ev.payload)
        return True

    def run_until_idle(self, until: float | None = None) -> Telemetry:
        """Drive the engine until all admitted work is done (or ``until``).

        Unlike the batch-era ``run()``-then-exit loop, this leaves the engine
        live: new submissions re-arm the recurring timers and a subsequent
        ``run_until_idle()``/``step()`` picks up exactly where time stopped.
        """
        self._arm_recurring()
        while self._events:
            if self.idle:
                break
            if not self.step(until):
                break
        self._finalize()
        return self.telemetry

    def run(self, until: float | None = None) -> Telemetry:
        """Back-compat alias: batch callers submit everything then run."""
        return self.run_until_idle(until)

    def cancel(self, dag_id: str) -> bool:
        """Cancel a workflow: detach its pending consumers; in-flight shared
        groups keep running for their other consumers (isolation, §3)."""
        dag = self.dags.get(dag_id)
        if dag is None:
            # not yet arrived: find the queued arrival event
            for ev in self._events:
                if ev.kind == "arrival" and ev.payload.dag_id == dag_id:
                    dag = ev.payload
                    break
        if dag is None or dag.done or dag_id in self.cancelled:
            return False
        self.cancelled.add(dag_id)
        self.pool.detach_dag(dag_id)
        self._unfinished -= 1
        self._last_progress = self.now
        self.stalled = False       # real progress clears a prior starvation
        self._emit(E.WorkflowCancelled(dag_id=dag_id, tenant=dag.tenant))
        self._revoke_orphans()
        return True

    def _revoke_orphans(self) -> None:
        """After a cancel, take back *running* batches no consumer wants
        anymore. Only a transport that can revoke does (the lease transport
        fences the lessee; its late result is discarded) — the in-process
        transport declines, keeping the historical run-to-completion
        semantics and the billing fallback via ``dispatch_tenants``."""
        for w in list(self.workers.values()):
            batch = w.current
            if batch is None or w.state is not WorkerState.ACTIVE:
                continue
            if any(g.done or g.consumers for g in batch.groups):
                continue           # some group still has a live consumer
            lease_id = self.transport.revoke(w)
            if lease_id is None:
                continue
            if w.worker_id in self._remote_waiting:
                self._remote_waiting.discard(w.worker_id)
                self._awaiting_remote -= 1
                self._inflight_batches -= 1
            self._emit(E.LeaseRevoked(
                worker=w.worker_id, batch_id=batch.batch_id,
                lease_id=lease_id, h_exec=batch.h_exec))
            for g in batch.groups:
                g.running_on.discard(w.worker_id)
                if not g.done and not g.running_on:
                    # nobody left to serve: finish (not requeue) and release
                    # the tenants' in-flight admission slots
                    self.pool.finish(g)
                    self._emit(E.GroupRequeued(
                        h_task=g.h_task, h_exec=g.h_exec,
                        worker=w.worker_id, requeued=False))
            w.current = None
            self._start_next(w)

    # ------------------------------------------------------------ handlers --
    def _on_arrival(self, dag: WorkflowDAG) -> None:
        if dag.dag_id in self.cancelled:
            # cancelled before arrival processed; the suppression marker has
            # served its purpose once the queued event is consumed
            self.cancelled.discard(dag.dag_id)
            return
        self.dags[dag.dag_id] = dag
        self._last_progress = self.now
        self.stalled = False       # real progress clears a prior starvation
        self._arrivals_in_window += 1
        self._arm_recurring()            # service mode: timers may have lapsed
        self._refresh_and_offer(dag)
        self._schedule_dispatch()

    def _on_worker_ready(self, wid: str) -> None:
        w = self.workers.get(wid)
        if w is None or w.state is WorkerState.DEAD:
            return
        w.state = WorkerState.ACTIVE
        w.idle_since = self.now
        # NOT progress: a fresh lease serves nothing by itself, and counting
        # it would let an autoscaler leasing for starved (e.g. quota-held)
        # work reset the stall guard forever
        self.autoscaler.pending_leases = max(0, self.autoscaler.pending_leases - 1)
        self._schedule_dispatch()

    def _on_heartbeat(self, _=None) -> None:
        for w in self.workers.values():
            if w.state in (WorkerState.ACTIVE, WorkerState.DRAINING) and \
                    not getattr(w, "crashed", False):
                w.last_heartbeat = self.now
        if self._unfinished:
            self._arm("heartbeat")

    def _on_crash(self, which) -> None:
        w = None
        if isinstance(which, int):
            active = [x for x in self.workers.values()
                      if x.state is WorkerState.ACTIVE]
            # fault injection prefers a BUSY worker (a crash of an idle node
            # loses nothing; the paper's scenario kills one mid-flight)
            busy = [x for x in active if x.current is not None]
            pool = busy or active
            if pool:
                w = pool[which % len(pool)]
        else:
            w = self.workers.get(which)
        if w is None:
            return
        w.crashed = True
        w.crashed_at = self.now   # heartbeats stop; watchdog will detect

    def _on_watchdog(self, _=None) -> None:
        for w in list(self.workers.values()):
            if w.state is not WorkerState.ACTIVE:
                continue
            if self.now - w.last_heartbeat >= self.cfg.watchdog_s:
                self._fail_worker(w)
        if self._unfinished:
            self._arm("watchdog")
        self._schedule_dispatch()

    def _fail_worker(self, w: Worker) -> None:
        """Crash path: atomically return RUNNING work to READY (§3.3)."""
        crashed_at = getattr(w, "crashed_at", self.now)
        w.state = WorkerState.DEAD
        w.meter.retired_at = self.now
        requeued = 0
        batches = w.drain()
        if w.current is not None:
            batches.append(w.current)
            w.current = None
        for b in batches:
            for g in b.groups:
                g.running_on.discard(w.worker_id)
                if not g.done and not g.running_on:
                    if g.consumers:
                        self.pool.requeue(g)
                        requeued += 1
                    else:
                        # every consumer cancelled mid-flight: abandon the
                        # ghost instead of requeueing work nobody wants
                        self.pool.finish(g)
                    # releases the tenants' in-flight admission slots
                    self._emit(E.GroupRequeued(
                        h_task=g.h_task, h_exec=g.h_exec,
                        worker=w.worker_id, requeued=bool(g.consumers)))
        self._emit(E.WorkerFailed(worker_id=w.worker_id,
                                  detect_s=self.now - crashed_at,
                                  requeued=requeued))
        self.backend.terminate(w.worker_id, self.now)

    def _on_autoscale(self, _=None) -> None:
        pending = self.pool.pending_by_exec()
        if self.admission and pending:
            # scale for dispatchable work only: quota-held operators must not
            # drive lease-after-lease for capacity they may never use
            pending = self.admission.filter_pending(pending, self.now,
                                                    count_holds=False)
        oldest = min((g.ready_at for gs in pending.values() for g in gs),
                     default=float("inf")) if self.admission else \
            self.pool.oldest_wait
        age = (self.now - oldest) if oldest != float("inf") else 0.0
        decision = self.autoscaler.decide(
            now=self.now, pending=pending, workers=self.workers.values(),
            oldest_wait_age=age)
        for offer in decision.leases:
            wid, ready_at = self.backend.lease(offer, self.now)
            w = Worker(wid, offer.dev, now=self.now,
                       perf_noise=self.rng.uniform(0.92, 1.12),
                       backend=self.backend.name)
            self.workers[wid] = w
            self.autoscaler.pending_leases += 1
            self._push(ready_at, "worker_ready", wid)
            self._emit(E.WorkerLeased(worker_id=wid,
                                      device_class=offer.dev.name,
                                      backend=self.backend.name,
                                      ready_at=ready_at))
        retired = 0
        for wid in decision.retire:
            w = self.workers.get(wid)
            if w and w.state is WorkerState.ACTIVE and w.current is None:
                w.state = WorkerState.DEAD
                w.meter.retired_at = self.now
                self.backend.terminate(wid, self.now)
                self._emit(E.WorkerRetired(worker_id=wid))
                retired += 1
        n_active = sum(1 for w in self.workers.values()
                       if w.state is WorkerState.ACTIVE)
        elapsed = self.now - self._last_scale_t
        rate = self._arrivals_in_window / elapsed if elapsed > 0 else 0.0
        self._arrivals_in_window = 0
        self._last_scale_t = self.now
        self._emit(E.ScaleDecision(
            active_workers=n_active, pending_depth=self.pool.depth,
            arriving_rate=rate, leased=len(decision.leases), retired=retired))
        if self._unfinished:
            self._arm("autoscale")

    def _on_spec_check(self, _=None) -> None:
        for g in self.pool.running_groups():
            h = g.h_exec
            hist = self._service_times.get(h)
            if not hist or len(g.running_on) >= 2 or g.dispatch_at is None:
                continue
            med = statistics.median(hist)
            if self.now - g.dispatch_at > self.cfg.spec_factor * med + 5.0:
                self._launch_replica(g)
        if self._unfinished and self.cfg.speculation:
            self._arm("spec_check")

    def _launch_replica(self, g: ExecutionGroup) -> None:
        cands = [w for w in self.workers.values()
                 if w.can_admit() and w.worker_id not in g.running_on
                 and feasible(g.spec, w)]
        if not cands:
            return
        w = max(cands, key=lambda w: w.dev.flops * (2.0 if w.is_hot_for(
            g.spec.h_model) else 1.0))
        batch = DispatchBatch(batch_id=next_batch_id(), h_exec=g.h_exec,
                              groups=[g],
                              worker_id=w.worker_id, admitted_at=self.now,
                              speculative=True)
        g.running_on.add(w.worker_id)
        g.attempts += 1
        self._emit(E.SpeculativeLaunched(h_task=g.h_task,
                                         worker=w.worker_id))
        w.admit(batch)
        if w.current is None:
            self._start_next(w)

    # ------------------------------------------------------- dispatch path --
    def _refresh_and_offer(self, dag: WorkflowDAG) -> None:
        for name in dag.refresh_ready(self.cas):
            self._emit(E.OpReady(
                dag_id=dag.dag_id, tenant=dag.tenant, op=name,
                h_task=dag.h_task[name], h_exec=dag.ops[name].h_exec()))
            self._offer(dag, name)

    def _offer(self, dag: WorkflowDAG, op_name: str) -> None:
        disp, group = self.pool.offer(
            dag, op_name, now=self.now, result_index=self.result_index,
            dedup=self.policy.dedup)
        if disp == "cached":
            # instant completion from the result index (dedup across time)
            h_task = dag.h_task[op_name]
            out = self.result_index[h_task]
            # hit bump + recency touch (pop/reinsert keeps dict order =
            # recency order); replay folds the same update off DedupHit
            self.result_index_hits[h_task] = \
                self.result_index_hits.get(h_task, 0) + 1
            self.result_index.pop(h_task, None)
            self.result_index[h_task] = out
            self._emit(E.DedupHit(
                dag_id=dag.dag_id, tenant=dag.tenant, op=op_name,
                h_task=h_task, source="index", savings=1))
            dag.state[op_name] = OpState.COMPLETED
            dag.complete(op_name, out, executed=False, worker=None,
                         now=self.now)
            self._emit(E.OpCompleted(
                dag_id=dag.dag_id, tenant=dag.tenant, op=op_name,
                h_task=dag.h_task[op_name], output_hash=out, executed=False,
                worker=None, input_hashes=dag.input_hashes.get(op_name, ())))
            self._after_complete(dag)

    def _after_complete(self, dag: WorkflowDAG) -> None:
        if dag.done:
            self._unfinished -= 1
            self._emit(E.WorkflowCompleted(
                dag_id=dag.dag_id, tenant=dag.tenant,
                latency=dag.latency or 0.0,
                deadline_s=float(dag.metadata.get("deadline_s") or 0.0)))
        else:
            self._refresh_and_offer(dag)

    def _schedule_dispatch(self) -> None:
        if not self._dispatch_pending:
            self._dispatch_pending = True
            self._push(self.now + self.cfg.dispatch_window_s, "dispatch")

    def _on_dispatch(self, _=None) -> None:
        self._dispatch_pending = False
        self._try_dispatch()

    def _try_dispatch(self) -> None:
        pending = self.pool.pending_by_exec()
        if self.admission and pending:
            # multi-tenant gate: quota holds + weighted fair-share ordering,
            # applied at the ready-pool boundary before Eq. 1 scheduling
            pending = self.admission.filter_pending(pending, self.now)
        if not pending:
            return
        active = [w for w in self.workers.values()
                  if w.state is WorkerState.ACTIVE
                  and not getattr(w, "crashed", False)]
        proposals = self.policy.schedule(pending, active, self.now)
        for p in proposals:
            batch = p.to_batch(self.now)
            for g in p.groups:
                if g.dispatch_at is None:
                    g.dispatch_tenants = tuple(sorted({c.tenant
                                                       for c in g.consumers}))
                    self._emit(E.OpDispatched(
                        h_task=g.h_task, h_exec=g.h_exec,
                        worker=p.worker.worker_id,
                        queue_wait=self.now - g.ready_at,
                        tenants=g.dispatch_tenants))
                g.dispatch_at = self.now
                g.running_on.add(p.worker.worker_id)
                g.attempts += 1
            p.worker.admit(batch)
            if p.worker.current is None:
                self._start_next(p.worker)

    def _start_next(self, w: Worker) -> None:
        batch = w.next_batch()
        if batch is None:
            w.current = None
            w.idle_since = self.now
            return
        w.current = batch
        result = self.transport.dispatch(batch, w, self.cas)
        if result is None:
            # handed to a remote lessee: the lane stays busy (idle stays
            # False through _inflight_batches) until the transport calls
            # back remote_batch_done or remote_lane_lost
            self._remote_waiting.add(w.worker_id)
            self._awaiting_remote += 1
            self._inflight_batches += 1
            return
        self._begin_batch(w, batch, result)

    def _begin_batch(self, w: Worker, batch: DispatchBatch,
                     result: ExecResult) -> None:
        """Fold an execution result into the virtual timeline: BatchStarted
        now, ``batch_done`` queued at now + duration. Identical for local
        and remote execution, which is what keeps every dispatch-side
        invariant (billing fallback, speculation, dedup fan-out, watchdog)
        transport-independent."""
        spec = batch.groups[0].spec
        dur = (result.duration_s + result.load_s) * w.perf_noise
        self._emit(E.BatchStarted(
            worker=w.worker_id, h_exec=batch.h_exec,
            n_groups=len(batch.groups), duration=dur, load_s=result.load_s,
            flops=result.flops, model_id=spec.model_id))
        if spec.model_id and not result.failed:
            w.make_resident(spec.h_model, spec.model_id)
        for g in batch.groups:
            w.local_cache.update(g.input_hashes)
        w.meter.note_active(dur)
        w.busy_until = self.now + dur
        self._inflight_batches += 1
        self._push(w.busy_until, "batch_done", (w.worker_id, batch, result, dur))

    # ---------------------------------------------- remote data plane -------
    def register_remote_worker(self, worker_id: str, device_class: str, *,
                               backend: str = "remote") -> str:
        """A remote worker process joined the data plane. Returns the lane
        id actually assigned — a crashed lane's name stays on its DEAD
        record (its meter still owes cost at finalize), so a reincarnation
        gets a suffixed id the client must adopt."""
        dev = DEVICE_CLASSES[device_class]
        wid = worker_id
        n = 0
        while True:
            existing = self.workers.get(wid)
            if existing is None:
                break
            if existing.state is WorkerState.ACTIVE \
                    and existing.backend == backend:
                return wid         # idempotent re-register of a live lane
            n += 1
            wid = f"{worker_id}~{n}"
        w = Worker(wid, dev, now=self.now, perf_noise=1.0, backend=backend)
        w.state = WorkerState.ACTIVE
        w.idle_since = self.now
        self.workers[wid] = w
        # fresh capacity IS progress: pending work declared starved while
        # the data plane was empty becomes servable again
        self._last_progress = self.now
        self.stalled = False
        self._emit(E.WorkerLeased(worker_id=wid, device_class=device_class,
                                  backend=backend, ready_at=self.now))
        self._schedule_dispatch()
        return wid

    def remote_batch_done(self, w: Worker, batch: DispatchBatch,
                          result: ExecResult) -> None:
        """Transport callback: the lessee reported its result (already
        fence-checked). Rejoins the virtual timeline exactly where an
        in-process execute would have."""
        if w.worker_id in self._remote_waiting:
            self._remote_waiting.discard(w.worker_id)
            self._awaiting_remote -= 1
            self._inflight_batches -= 1
        self._begin_batch(w, batch, result)

    def remote_lane_lost(self, wid: str) -> None:
        """Transport callback: a lease lapsed or a lane went silent. Same
        crash path as the virtual watchdog — RUNNING work returns to READY
        via ``GroupRequeued``, journaled like any other failure."""
        w = self.workers.get(wid)
        if w is None or w.state is WorkerState.DEAD:
            return
        if wid in self._remote_waiting:
            self._remote_waiting.discard(wid)
            self._awaiting_remote -= 1
            self._inflight_batches -= 1
        self._fail_worker(w)
        self._schedule_dispatch()

    def _on_batch_done(self, payload) -> None:
        wid, batch, result, dur = payload
        self._inflight_batches -= 1
        self._last_progress = self.now
        self.stalled = False       # real progress clears a prior starvation
        w = self.workers.get(wid)
        if w is None or w.state is WorkerState.DEAD:
            return   # worker failed mid-flight; groups were requeued
        spec = batch.groups[0].spec

        if result.failed:
            # e.g. wrong resource spec: worker proactively reports shortage;
            # control plane corrects the demand hint and resubmits (§5.3)
            self._emit(E.BatchFailed(
                worker=wid, h_exec=batch.h_exec, failure=result.failure or "",
                n_groups=len(batch.groups), duration=dur))
            for g in batch.groups:
                g.running_on.discard(wid)
                if result.failure == "resource_shortage":
                    actual = g.spec.params.get("actual_vram_gb")
                    if actual:
                        g.spec.params["min_vram_gb"] = float(actual)
                if not g.done and not g.running_on:
                    retryable = g.consumers and g.attempts < self.cfg.max_attempts
                    if retryable:
                        self.pool.requeue(g)
                    else:
                        # attempts exhausted, or cancelled out from under the
                        # failure: abandon rather than retry for nobody
                        self.pool.finish(g)
                    # requeued or permanently dropped: either way the group
                    # no longer occupies the tenants' in-flight caps
                    self._emit(E.GroupRequeued(
                        h_task=g.h_task, h_exec=g.h_exec, worker=wid,
                        requeued=bool(retryable)))
            w.current = None
            self._start_next(w)
            self._schedule_dispatch()
            return

        self._service_times.setdefault(batch.h_exec, []).append(dur)
        self._emit(E.BatchDone(
            worker=wid, h_exec=batch.h_exec, n_groups=len(batch.groups),
            batch_size=sum(g.fanout for g in batch.groups), duration=dur))
        cost_share = dur * w.dev.price_hr / 3600.0 / max(1, len(batch.groups))
        for g, out in zip(batch.groups, result.outputs):
            key, won = self.cas.publish(out)
            w.local_cache.add(key)
            if g.done:
                # a speculative rival already published — discard by identity
                self._emit(E.SpeculativeDiscarded(h_task=g.h_task,
                                                  worker=wid))
                continue
            g.running_on.discard(wid)
            # re-insert so dict order is last-write: the fabric's retention
            # trim (and the replay fold, which mirrors this) evicts the
            # stalest entry, not whichever happened to be written first
            self.result_index.pop(g.h_task, None)
            self.result_index[g.h_task] = key
            self.pool.finish(g)
            # bill the consumers (shared work, shared bill) — or, when every
            # consumer cancelled mid-flight, the tenants recorded at dispatch
            # (the run still happened on their behalf). The event carries the
            # final list; the admission subscriber charges from it, live and
            # on replay alike.
            billed = [c.tenant for c in g.consumers] or list(g.dispatch_tenants)
            self._emit(E.GroupCompleted(
                h_task=g.h_task, h_exec=g.h_exec, worker=wid, duration=dur,
                output_hash=key, cost=cost_share,
                consumers=tuple((c.dag_id, c.op_name, c.tenant)
                                for c in g.consumers),
                billed=tuple(billed)))
            # ordered dedup: refresh consumer DAGs in consumer order, not in
            # set-hash order — dag ids are strings, and hash-ordered
            # iteration would make the schedule depend on the process hash
            # seed and on how many DAGs existed before this run
            touched = dict.fromkeys(inst.dag_id for inst in g.consumers)
            for inst in g.consumers:
                dag = self.dags[inst.dag_id]
                dag.complete(inst.op_name, key,
                             executed=(inst is g.consumers[0]),
                             worker=wid, now=self.now)
                self._emit(E.OpCompleted(
                    dag_id=inst.dag_id, tenant=inst.tenant, op=inst.op_name,
                    h_task=g.h_task, output_hash=key,
                    executed=(inst is g.consumers[0]), worker=wid,
                    input_hashes=g.input_hashes))
            for d in touched:
                self._after_complete(self.dags[d])
        w.current = None
        self._start_next(w)
        self._schedule_dispatch()

    # ------------------------------------------------------------ finalize --
    def cost_energy(self) -> tuple[float, float]:
        """Current ($, joules) meter integrals across every worker lifetime,
        up to virtual ``now``. Read-only: usable mid-flight by a pump-driven
        service (``GET /health``), where ``run_until_idle``'s finalize
        snapshot never fires."""
        cost = energy = 0.0
        for w in self.workers.values():
            d, j = w.meter.totals(self.now)
            cost += d
            energy += j
        return cost, energy

    def _finalize(self) -> None:
        cost, energy = self.cost_energy()
        # $ and J are meter integrals, not transitions: snapshotted through
        # the bus so telemetry stays purely event-derived
        self._emit(E.CostSnapshot(total_cost=cost, total_energy_j=energy))

    # ----------------------------------------------------------- MF helper --
    def _monolithize(self, dag: WorkflowDAG) -> WorkflowDAG:
        """MF baseline: the whole workflow as ONE opaque block-resource job."""
        ops = dag._topo_order()
        serial = [{
            "op_type": o.op_type.value, "model_id": o.model_id,
            "tokens_in": o.tokens_in, "tokens_out": o.tokens_out,
            "train_tokens": o.train_tokens,
            "lora": bool(o.params.get("lora", False)),
        } for o in ops]
        vram = max((vram_needed_gb(o) for o in ops), default=0.0)
        rank = {"cpu": 0, "gpu.small": 1, "gpu.medium": 2, "gpu.large": 3,
                "gpu.xlarge": 4}
        rc = max((o.resource_class for o in ops),
                 key=lambda r: rank.get(r, 0), default="gpu.small")
        biggest = max(ops, key=lambda o: vram_needed_gb(o))
        mono = OperatorSpec(
            name="__mono__", op_type=OpType.AGGREGATE,
            model_id=biggest.model_id, params={
                "monolithic_ops": serial, "min_vram_gb": vram,
                # unique per dag: monolithic jobs are opaque, never dedup
                "dag": dag.dag_id,
            },
            inputs=[f"workload:{dag.dag_id}"], resource_class=rc)
        return WorkflowDAG([mono], tenant=dag.tenant,
                           dag_id=dag.dag_id, submitted_at=dag.submitted_at,
                           metadata=dag.metadata)
