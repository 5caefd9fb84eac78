"""Cross-DAG consolidation: the ready-operator pool.

Two gates from the paper (§3):
  * exact-match H_task  -> unification by identity (dedup): at most one
    execution, artifact fanned out to every consumer DAG;
  * compatible-match H_exec -> consolidation by execution signature: different
    inputs, same executor/params/resource class -> joint batched run.

The pool is the control plane's single global stream of ready operators.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

from .dag import WorkflowDAG
from .worker import ExecutionGroup, TaskInstance


@dataclass
class PoolStats:
    ops_arrived: int = 0
    dedup_joins: int = 0       # ops absorbed into an existing group
    cache_skips: int = 0       # ops satisfied instantly from the result index
    groups_created: int = 0
    # per-tenant views of the same counters (fabric usage API)
    arrived_by_tenant: dict[str, int] = field(default_factory=dict)
    joins_by_tenant: dict[str, int] = field(default_factory=dict)

    def _bump(self, d: dict[str, int], tenant: str) -> None:
        d[tenant] = d.get(tenant, 0) + 1


class ReadyPool:
    """Pooled ready-operator queue across all tenant DAGs."""

    def __init__(self) -> None:
        self._by_task: dict[str, ExecutionGroup] = {}
        self._by_exec: dict[str, list[ExecutionGroup]] = defaultdict(list)
        self.stats = PoolStats()

    # ------------------------------------------------------------------
    def offer(self, dag: WorkflowDAG, op_name: str, *, now: float,
              result_index: dict[str, str], dedup: bool = True,
              ) -> tuple[str, ExecutionGroup | None]:
        """Add a newly-READY operator. Returns (disposition, group):

        - ("cached", None): output already known -> caller completes the op
          immediately (dedup across time — "skips it entirely").
        - ("joined", g):   absorbed into a pending/running group with the same
          H_task (dedup across concurrent tenants).
        - ("queued", g):   new ExecutionGroup created.
        """
        self.stats.ops_arrived += 1
        self.stats._bump(self.stats.arrived_by_tenant, dag.tenant)
        spec = dag.ops[op_name]
        h_task = dag.h_task[op_name]
        deadline_s = dag.metadata.get("deadline_s")
        inst = TaskInstance(dag.dag_id, op_name, dag.tenant,
                            deadline_at=(dag.submitted_at + float(deadline_s)
                                         if deadline_s else None))

        if dedup and h_task in result_index:
            self.stats.cache_skips += 1
            return "cached", None

        if dedup and h_task in self._by_task:
            g = self._by_task[h_task]
            g.consumers.append(inst)
            self.stats.dedup_joins += 1
            self.stats._bump(self.stats.joins_by_tenant, dag.tenant)
            return "joined", g

        g = ExecutionGroup(
            h_task=h_task if dedup else f"{h_task}:{dag.dag_id}:{op_name}",
            h_exec=spec.h_exec(), spec=spec,
            input_hashes=dag.input_hashes[op_name],
            consumers=[inst], ready_at=now)
        self._by_task[g.h_task] = g
        self._by_exec[g.h_exec].append(g)
        self.stats.groups_created += 1
        return "queued", g

    # ------------------------------------------------------------------
    def pending_by_exec(self) -> dict[str, list[ExecutionGroup]]:
        """S(H_exec): batch-compatible sets of not-yet-dispatched groups.

        Groups are FIFO-ordered by ready time; an admission controller may
        reorder each list (fair share) before the policy slices batches.
        """
        out: dict[str, list[ExecutionGroup]] = {}
        for h_exec, groups in self._by_exec.items():
            ready = [g for g in groups if g.dispatch_at is None and not g.done]
            if ready:
                ready.sort(key=lambda g: g.ready_at)
                out[h_exec] = ready
        return out

    def detach_dag(self, dag_id: str) -> list[ExecutionGroup]:
        """Workflow cancellation: drop the DAG's task instances from every
        group. Groups left with no consumers that are not yet running are
        abandoned (removed from the pool); running groups finish for their
        remaining consumers — or publish to the result index unconsumed."""
        abandoned: list[ExecutionGroup] = []
        for groups in list(self._by_exec.values()):
            for g in list(groups):
                if g.done or not any(c.dag_id == dag_id for c in g.consumers):
                    continue
                g.consumers = [c for c in g.consumers if c.dag_id != dag_id]
                if not g.consumers and g.dispatch_at is None:
                    self.finish(g)       # never dispatched: fully abandoned
                    abandoned.append(g)
        return abandoned

    def running_groups(self) -> list[ExecutionGroup]:
        return [g for gs in self._by_exec.values() for g in gs
                if g.dispatch_at is not None and not g.done]

    def requeue(self, group: ExecutionGroup) -> None:
        """Return a RUNNING group to READY (worker crash / failure path)."""
        group.dispatch_at = None
        group.running_on.clear()

    def finish(self, group: ExecutionGroup) -> None:
        group.done = True
        self._by_task.pop(group.h_task, None)
        lst = self._by_exec.get(group.h_exec)
        if lst is not None:
            try:
                lst.remove(group)
            except ValueError:
                pass
            if not lst:
                del self._by_exec[group.h_exec]

    def get_group(self, h_task: str) -> ExecutionGroup | None:
        return self._by_task.get(h_task)

    @property
    def depth(self) -> int:
        return sum(len([g for g in gs if g.dispatch_at is None and not g.done])
                   for gs in self._by_exec.values())

    @property
    def oldest_wait(self) -> float:
        """Age proxy used by the autoscaler's SLO-pressure signal."""
        pending = [g.ready_at for gs in self._by_exec.values() for g in gs
                   if g.dispatch_at is None and not g.done]
        return min(pending) if pending else float("inf")
