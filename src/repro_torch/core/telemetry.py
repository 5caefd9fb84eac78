"""Fabric-wide metrics: latency, queueing, cost, energy, CDP/EDP (§5.2).

CDP = (Total Cost / #Tasks) * AvgTime ; EDP analogously with energy —
following Roloff et al. 2017 as cited by the paper.

Telemetry is an **EventBus subscriber** (DESIGN.md §7): every aggregate is
derived from the typed event stream via ``on_event`` — engine handlers never
mutate these fields directly. That makes the metrics exactly as trustworthy
as the event log (the same stream the journal persists and job feeds serve),
and it is what keeps baseline comparisons fair: all policies flow through
one derivation.

Two retention modes:

  * unbounded (default, ``window=None``): full per-op/per-DAG history —
    benchmarks slice these lists directly;
  * ring-buffer (``window=N``): distribution fields keep only the most
    recent N samples (``summary()`` becomes a rolling summary) while scalar
    counters stay cumulative — for never-restarting service deployments
    whose history would otherwise grow linearly forever.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from . import events as ev


@dataclass
class Telemetry:
    #: ring-buffer size for distribution fields; None = unbounded history
    window: int | None = None
    # per-DAG ("task" in the paper's metric = one workflow)
    dag_latencies: list[float] = field(default_factory=list)
    dag_completions: list[float] = field(default_factory=list)   # times
    # per-operator
    op_queue_waits: list[float] = field(default_factory=list)
    op_service_times: list[float] = field(default_factory=list)
    # SLO outcomes: *realized* deadline misses (completed workflows whose
    # latency exceeded their deadline_s metadata), not predictions — the
    # counterpart of the job view's `predicted_miss` estimate
    deadline_misses: int = 0
    deadline_completions: int = 0   # completed workflows that carried an SLO
    # consolidation
    executions: int = 0
    dedup_savings: int = 0          # op-instances satisfied without execution
    batch_sizes: list[int] = field(default_factory=list)
    model_loads: int = 0
    hot_hits: int = 0
    speculative_launches: int = 0
    speculative_discards: int = 0
    retries: int = 0
    failures_detected: list[tuple[float, str, float]] = field(default_factory=list)
    # $ / J (finalized from worker meters at end of run)
    total_cost: float = 0.0
    total_energy_j: float = 0.0
    total_flops: float = 0.0
    # autoscaler trace: (t, active_workers, pending_depth, arriving_rate)
    scaling_trace: list[tuple[float, int, int, float]] = field(
        default_factory=list)
    # per-tenant workflow latencies (the fabric's usage API reads these)
    tenant_latencies: dict[str, list[float]] = field(default_factory=dict)

    _RING_FIELDS = ("dag_latencies", "dag_completions", "op_queue_waits",
                    "op_service_times", "batch_sizes", "failures_detected",
                    "scaling_trace")

    def __post_init__(self) -> None:
        if self.window is not None:
            for name in self._RING_FIELDS:
                setattr(self, name, deque(getattr(self, name),
                                          maxlen=self.window))

    def _tenant_bucket(self, tenant: str) -> list[float]:
        xs = self.tenant_latencies.get(tenant)
        if xs is None:
            xs = (deque(maxlen=self.window) if self.window is not None
                  else [])
            self.tenant_latencies[tenant] = xs
        return xs

    # ------------------------------------------------- event derivation --
    def on_event(self, e: ev.FabricEvent) -> None:
        """Fold one control-plane event into the aggregates."""
        handler = self._HANDLERS.get(e.kind)
        if handler is not None:
            handler(self, e)

    def _on_workflow_completed(self, e: ev.WorkflowCompleted) -> None:
        self.dag_latencies.append(e.latency)
        self.dag_completions.append(e.time)
        self._tenant_bucket(e.tenant).append(e.latency)
        if e.deadline_s > 0:
            self.deadline_completions += 1
            if e.latency > e.deadline_s:
                self.deadline_misses += 1

    def _on_dedup_hit(self, e: ev.DedupHit) -> None:
        self.dedup_savings += e.savings

    def _on_dispatch(self, e: ev.OpDispatched) -> None:
        self.op_queue_waits.append(e.queue_wait)

    def _on_batch_started(self, e: ev.BatchStarted) -> None:
        if e.load_s > 0:
            self.model_loads += 1
        elif e.model_id:
            self.hot_hits += 1
        self.total_flops += e.flops

    def _on_batch_done(self, e: ev.BatchDone) -> None:
        self.executions += 1
        self.batch_sizes.append(e.batch_size)

    def _on_batch_failed(self, e: ev.BatchFailed) -> None:
        self.retries += e.n_groups
        self.failures_detected.append(
            (e.time, f"{e.worker}:{e.failure}", e.duration))

    def _on_group_completed(self, e: ev.GroupCompleted) -> None:
        self.op_service_times.append(e.duration)
        savings = len(e.consumers) - 1
        if savings > 0:
            self.dedup_savings += savings

    def _on_worker_fail(self, e: ev.WorkerFailed) -> None:
        self.failures_detected.append((e.time, e.worker_id, e.detect_s))
        self.retries += e.requeued

    def _on_spec_launch(self, e: ev.SpeculativeLaunched) -> None:
        self.speculative_launches += 1

    def _on_spec_discard(self, e: ev.SpeculativeDiscarded) -> None:
        self.speculative_discards += 1

    def _on_scale_decision(self, e: ev.ScaleDecision) -> None:
        self.scaling_trace.append(
            (e.time, e.active_workers, e.pending_depth, e.arriving_rate))

    def _on_cost_snapshot(self, e: ev.CostSnapshot) -> None:
        self.total_cost = e.total_cost
        self.total_energy_j = e.total_energy_j

    _HANDLERS = {
        "workflow_completed": _on_workflow_completed,
        "dedup_hit": _on_dedup_hit,
        "dispatch": _on_dispatch,
        "batch_started": _on_batch_started,
        "batch_done": _on_batch_done,
        "batch_failed": _on_batch_failed,
        "group_completed": _on_group_completed,
        "worker_fail": _on_worker_fail,
        "spec_launch": _on_spec_launch,
        "spec_discard": _on_spec_discard,
        "scale_decision": _on_scale_decision,
        "cost_snapshot": _on_cost_snapshot,
    }

    # ------------------------------------------------------------------
    @property
    def n_tasks(self) -> int:
        return len(self.dag_latencies)

    @property
    def avg_latency(self) -> float:
        return (sum(self.dag_latencies) / len(self.dag_latencies)
                if self.dag_latencies else 0.0)

    @property
    def p95_latency(self) -> float:
        return self.percentile(self.dag_latencies, 0.95)

    @property
    def avg_queue_wait(self) -> float:
        return (sum(self.op_queue_waits) / len(self.op_queue_waits)
                if self.op_queue_waits else 0.0)

    @property
    def cdp(self) -> float:
        if not self.n_tasks:
            return 0.0
        return (self.total_cost / self.n_tasks) * self.avg_latency

    @property
    def edp(self) -> float:
        if not self.n_tasks:
            return 0.0
        return (self.total_energy_j / self.n_tasks) * self.avg_latency

    def throughput_per_min(self, horizon_s: float) -> float:
        return 60.0 * self.n_tasks / horizon_s if horizon_s > 0 else 0.0

    @staticmethod
    def percentile(xs, q: float) -> float:
        """Nearest-rank percentile, q in [0, 1]."""
        if not xs:
            return 0.0
        ys = sorted(xs)
        return ys[min(len(ys) - 1, int(q * len(ys)))]

    def summary(self) -> dict:
        return {
            "tasks": self.n_tasks,
            "avg_latency_s": round(self.avg_latency, 2),
            "p95_latency_s": round(self.p95_latency, 2),
            "avg_queue_wait_s": round(self.avg_queue_wait, 2),
            "total_cost_usd": round(self.total_cost, 4),
            "total_energy_kj": round(self.total_energy_j / 1e3, 2),
            "cdp": round(self.cdp, 4),
            "edp_kjs": round(self.edp / 1e3, 2),
            "executions": self.executions,
            "dedup_savings": self.dedup_savings,
            "mean_batch": round(sum(self.batch_sizes) / len(self.batch_sizes), 2)
                          if self.batch_sizes else 0.0,
            "model_loads": self.model_loads,
            "hot_hits": self.hot_hits,
            "retries": self.retries,
            "spec_launches": self.speculative_launches,
            "deadline_misses": self.deadline_misses,
            "deadline_completions": self.deadline_completions,
        }
