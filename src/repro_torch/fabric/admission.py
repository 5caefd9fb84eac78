"""Multi-tenant admission control at the ready-pool boundary.

Two mechanisms, both applied *before* Eq. 1 scheduling ever sees an operator:

  * **quotas** — per-tenant caps: ``max_active_workflows`` and a GPU-dollar
    budget gate new submissions (hard reject, HTTP 429 at the API layer);
    ``max_inflight_ops`` holds a tenant's ready operators in the pool once
    too many of their ops are already running (work is delayed, not lost).
  * **weighted fair share** — within each compatible set S(H_exec), ready
    groups are reordered by the owning tenant's virtual time
    (charged spend / weight), so a light tenant is not starved behind a
    heavy tenant's backlog (LLM-Mesh-style elastic sharing).

The controller also meters per-tenant usage: ops run vs. deduped, dollar
spend (cost of executed batches split across every consumer tenant — shared
work is shared cost), and workflow latency percentiles.

**All accounting is event-derived** (DESIGN.md §8): the controller is an
``EventBus`` subscriber, and ``on_event`` is the *single* write path for
usage state — the live fabric publishes events at every transition, and
journal replay feeds the very same handler, so restored accounting cannot
drift from what the live fabric computed. The engine stays tenant-agnostic:
the only imperative surface is ``admit_workflow`` (a read-only quota check)
and ``filter_pending`` (quota holds + fair-share ordering at the ready-pool
boundary).
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import asdict, dataclass

from repro_torch.core.worker import ExecutionGroup
from repro_torch.core.dag import WorkflowDAG


@dataclass
class TenantQuota:
    """Per-tenant limits; ``None`` means unlimited."""
    max_inflight_ops: int | None = None      # dispatch-time hold
    max_active_workflows: int | None = None  # submission-time reject
    budget_usd: float | None = None          # submission-time reject
    weight: float = 1.0                      # fair-share weight


@dataclass
class TenantUsage:
    submitted: int = 0
    rejected: int = 0
    completed: int = 0
    cancelled: int = 0
    active_workflows: int = 0
    ops_executed: int = 0        # this tenant's instance ran the computation
    ops_deduped: int = 0         # satisfied by another tenant's run / cache
    inflight_ops: int = 0        # dispatched, not yet finished
    held_ops: int = 0            # cumulative quota holds at the pool boundary
    spend_usd: float = 0.0       # charged share of executed batch cost
    gpu_seconds: float = 0.0     # charged share of executed batch time
    vtime: float = 0.0           # weighted virtual time (fair-share clock)


class QuotaExceeded(Exception):
    def __init__(self, tenant: str, reason: str) -> None:
        self.tenant = tenant
        self.reason = reason
        super().__init__(f"tenant {tenant!r}: {reason}")


class AdmissionController:
    #: EDF-flavored deadline pressure: a group whose nearest consumer
    #: deadline has ``slack`` seconds left is ordered as if its tenant's
    #: virtual time were ``deadline_boost / max(1, slack)`` smaller. Bounded
    #: (slack clamped at 1 s) so a hopeless deadline cannot permanently
    #: outrank every other tenant's clock. The 0.5 default comes from the
    #: scenario-engine calibration sweep over scenarios/burst_deadline.yaml
    #: (DESIGN.md §15): the smallest value reaching a 100% SLO hit rate on
    #: every sweep seed with no overall p95 penalty (0.05 left ~1% misses;
    #: ≥5 starts taxing the no-deadline tenants' tail).
    def __init__(self, default_quota: TenantQuota | None = None, *,
                 deadline_boost: float = 0.5) -> None:
        self.deadline_boost = deadline_boost
        self.default_quota = default_quota or TenantQuota()
        self.quotas: dict[str, TenantQuota] = {}
        self.usage: dict[str, TenantUsage] = defaultdict(TenantUsage)
        #: dispatch-time tenant attribution awaiting completion/requeue:
        #: h_task -> FIFO of tenant lists (one entry per live dispatch; the
        #: pool keeps at most one live group per h_task, the FIFO is a
        #: belt-and-braces guard for dedup-disabled baselines)
        self._counted: dict[str, list[list[str]]] = {}
        #: monotone fair-share clock floor (survives idle windows)
        self._vtime_floor = 0.0

    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        self.quotas[tenant] = quota

    def quota(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self.default_quota)

    # ---------------------------------------------------- submission gate --
    def admit_workflow(self, dag: WorkflowDAG) -> None:
        """Raise ``QuotaExceeded`` if the tenant may not submit right now.

        Read-only: the accounting consequences (submitted/rejected counts,
        active-workflow tracking) flow from the ``workflow_submitted`` /
        ``job_rejected`` events the caller publishes on the outcome."""
        q, u = self.quota(dag.tenant), self.usage[dag.tenant]
        if (q.max_active_workflows is not None
                and u.active_workflows >= q.max_active_workflows):
            raise QuotaExceeded(
                dag.tenant, f"max_active_workflows={q.max_active_workflows} "
                f"reached ({u.active_workflows} active)")
        if q.budget_usd is not None and u.spend_usd >= q.budget_usd:
            raise QuotaExceeded(
                dag.tenant, f"budget exhausted "
                f"(${u.spend_usd:.4f} of ${q.budget_usd:.4f})")

    # --------------------------------------------- the single write path ----
    def on_event(self, e) -> None:
        """Fold one control-plane event into per-tenant usage accounting.

        THE write path: the live bus and journal replay (including the
        snapshot fold in ``EventJournal.compact``) all call this one body —
        there is no imperative accounting hook left to diverge from it."""
        kind = e.kind
        if kind == "workflow_submitted":
            self._workflow_started(e.tenant)
        elif kind == "workflow_completed":
            self._workflow_done(e.tenant)
        elif kind == "workflow_cancelled":
            self._workflow_cancelled(e.tenant)
        elif kind == "job_rejected":
            self.usage[e.tenant].rejected += 1
        elif kind == "dedup_hit":
            self.usage[e.tenant].ops_deduped += e.savings
        elif kind == "dispatch":
            # one physical op per group: count each tenant once, no matter
            # how many of their workflow instances dedup onto it — this
            # mirrors the per-group headroom charge in filter_pending, so
            # one dispatch round cannot overshoot max_inflight_ops
            for t in e.tenants:
                self.usage[t].inflight_ops += 1
            self._counted.setdefault(e.h_task, []).append(list(e.tenants))
        elif kind == "group_requeued":
            self._uncount(e.h_task)
        elif kind == "group_completed":
            self._uncount(e.h_task)
            self._charge(list(e.billed), e.cost, e.duration)

    def _workflow_started(self, tenant: str) -> None:
        u = self.usage[tenant]
        if u.active_workflows == 0:
            # WFQ start-time rule: a joining (or returning) tenant enters at
            # the system virtual time, not at zero — otherwise a newcomer
            # outranks every incumbent until it has matched their lifetime
            # spend, starving them for the whole catch-up period
            u.vtime = max(u.vtime, self._system_vtime())
        u.submitted += 1
        u.active_workflows += 1

    def _workflow_done(self, tenant: str) -> None:
        u = self.usage[tenant]
        u.active_workflows = max(0, u.active_workflows - 1)
        u.completed += 1

    def _workflow_cancelled(self, tenant: str) -> None:
        u = self.usage[tenant]
        u.active_workflows = max(0, u.active_workflows - 1)
        u.cancelled += 1

    def _uncount(self, h_task: str) -> None:
        stack = self._counted.get(h_task)
        if not stack:
            return        # re-dispatch after requeue was never re-counted
        for t in stack.pop(0):
            self.usage[t].inflight_ops = max(
                0, self.usage[t].inflight_ops - 1)
        if not stack:
            del self._counted[h_task]

    def _charge(self, tenants: list[str], cost: float,
                duration: float) -> None:
        """Accounting core: credit the first consumer with the run, every
        later consumer with a dedup save, and split the cost across all
        consumer instances (shared work, shared bill)."""
        if not tenants:
            return
        share = cost / len(tenants)
        t_share = duration / len(tenants)
        for i, t in enumerate(tenants):
            u = self.usage[t]
            if i == 0:
                u.ops_executed += 1
            else:
                u.ops_deduped += 1
            u.spend_usd += share
            u.gpu_seconds += t_share
            # epsilon keeps zero-cost (CPU) ops from being free under fair
            # share; weight scales how fast the tenant's clock advances
            u.vtime += (share + 1e-6) / max(self.quota(t).weight, 1e-9)
        # refresh the monotone fair-share floor while service is observable
        self._system_vtime()

    # ------------------------------------------------ ready-pool boundary --
    def _vtime(self, tenant: str) -> float:
        """Weighted virtual time: service consumed per unit of entitlement
        since the tenant joined. Smaller -> scheduled sooner."""
        return self.usage[tenant].vtime

    def _system_vtime(self) -> float:
        """The fair-share clock: the least-served active tenant's vtime,
        with a monotone floor so the clock survives idle windows — a tenant
        joining while everyone happens to be idle must not enter at zero and
        outrank every returning incumbent."""
        active = [u.vtime for u in self.usage.values()
                  if u.active_workflows > 0 or u.inflight_ops > 0]
        if active:
            self._vtime_floor = max(self._vtime_floor, min(active))
        return self._vtime_floor

    def filter_pending(self, pending: dict[str, list[ExecutionGroup]],
                       now: float, *, count_holds: bool = True,
                       ) -> dict[str, list[ExecutionGroup]]:
        """Quota holds + fair-share reorder, per compatible set.

        Each tenant may expose at most ``max_inflight_ops - inflight`` groups
        to the scheduler per round (headroom is consumed as groups become
        visible, so one round cannot overshoot the cap). A shared group is
        held only when *every* consumer tenant is out of headroom — shared
        work proceeds as long as one consumer can pay for it (holding it
        would punish the under-cap tenant for sharing).

        ``held_ops`` is metered here directly: a hold is a scheduling
        decision, not a journaled state transition — like ``inflight_ops``
        it is runtime-only and deliberately absent from replayed history.
        """
        tenants_of = {id(g): {c.tenant for c in g.consumers}
                      for groups in pending.values() for g in groups}
        vtime = {t: self._vtime(t)
                 for ts in tenants_of.values() for t in ts}
        headroom: dict[str, int | None] = {}     # None => unlimited
        for t in vtime:
            cap = self.quota(t).max_inflight_ops
            headroom[t] = (None if cap is None
                           else max(0, cap - self.usage[t].inflight_ops))
        out: dict[str, list[ExecutionGroup]] = {}
        for h_exec, groups in pending.items():
            ordered = sorted(groups, key=lambda g: (
                min((vtime[c.tenant] for c in g.consumers), default=0.0)
                - self._edf_boost(g, now),
                g.ready_at))
            visible: list[ExecutionGroup] = []
            for g in ordered:
                ts = tenants_of[id(g)]
                if ts and all(headroom[t] == 0 for t in ts):
                    if count_holds:      # autoscaler peeks without metering
                        for t in ts:
                            self.usage[t].held_ops += 1
                    continue
                visible.append(g)
                for t in ts:
                    if headroom[t] is not None:
                        headroom[t] = max(0, headroom[t] - 1)
            if visible:
                out[h_exec] = visible
        return out

    def _edf_boost(self, g: ExecutionGroup, now: float) -> float:
        """Deadline pressure for a group: earliest consumer deadline wins
        (SLO-aware admission — specs carry ``deadline_s`` into DAG metadata
        and the ready pool stamps it onto each TaskInstance)."""
        deadline = min((c.deadline_at for c in g.consumers
                        if c.deadline_at is not None), default=None)
        if deadline is None:
            return 0.0
        return self.deadline_boost / max(1.0, deadline - now)

    # ---------------------------------------------------- restore support --
    def replay_interrupted(self, tenant: str) -> None:
        """A job that was live when the fabric died: its workflow state is
        unrecoverable (in-flight engine state is not journaled), so the
        restored record is closed out as cancelled."""
        self._workflow_cancelled(tenant)

    def reset_transients(self) -> None:
        """Drop in-flight scheduling state after a restore: the groups it
        tracks died with the old process and will never complete — keeping
        their counts would permanently eat into ``max_inflight_ops``."""
        self._counted.clear()
        for u in self.usage.values():
            u.inflight_ops = 0

    # ---------------------------------------------- operator configuration --
    def dump_config(self) -> dict:
        """Quota *configuration* (not usage history) as a JSON-shaped blob —
        the admission half of the persisted operator document (DESIGN.md §9).
        The complement of ``dump_state``: config is what restore/compaction
        must re-apply, state is what the fold rebuilds."""
        return {
            "deadline_boost": self.deadline_boost,
            "default_quota": asdict(self.default_quota),
            "quotas": {t: asdict(q) for t, q in self.quotas.items()},
        }

    def load_config(self, blob: dict) -> None:
        """Apply a persisted operator document's quota configuration."""
        self.deadline_boost = blob.get("deadline_boost", self.deadline_boost)
        if "default_quota" in blob:
            self.default_quota = TenantQuota(**blob["default_quota"])
        self.quotas = {t: TenantQuota(**d)
                       for t, d in blob.get("quotas", {}).items()}

    # -------------------------------------------- snapshot serialization --
    def dump_state(self) -> dict:
        """Usage accounting as a JSON-shaped blob for journal snapshots.

        Includes the dispatch attributions (``_counted``) so a snapshot cut
        mid-flight folds the tail's completions exactly like full replay
        would. Quotas are operator config, not history — they are NOT
        serialized (re-apply them before restoring, DESIGN.md §7)."""
        return {
            "usage": {t: asdict(u) for t, u in self.usage.items()},
            "vtime_floor": self._vtime_floor,
            "counted": {h: [list(ts) for ts in stack]
                        for h, stack in self._counted.items()},
        }

    def load_state(self, blob: dict) -> None:
        self.usage.clear()
        for t, d in blob["usage"].items():
            self.usage[t] = TenantUsage(**d)
        self._vtime_floor = blob["vtime_floor"]
        self._counted = {h: [list(ts) for ts in stack]
                         for h, stack in blob["counted"].items()}

    # ----------------------------------------------------------- reporting --
    def usage_snapshot(self, tenant: str) -> dict:
        # read-only: must not insert into the defaultdict, or arbitrary ids
        # queried through the usage API would grow controller state forever
        q = self.quota(tenant)
        u = self.usage.get(tenant) or TenantUsage()
        return {
            "tenant": tenant,
            "workflows": {
                "submitted": u.submitted, "completed": u.completed,
                "rejected": u.rejected, "cancelled": u.cancelled,
                "active": u.active_workflows,
            },
            "ops": {
                "executed": u.ops_executed, "deduped": u.ops_deduped,
                "inflight": u.inflight_ops, "held": u.held_ops,
            },
            "spend": {
                "usd": round(u.spend_usd, 6),
                "gpu_seconds": round(u.gpu_seconds, 3),
                "budget_usd": q.budget_usd,
            },
            "fair_share": {"weight": q.weight, "vtime": round(u.vtime, 9)},
        }
