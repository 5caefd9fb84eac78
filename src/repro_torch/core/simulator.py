"""Virtual-time executor: analytic ground truth for cluster-scale benchmarks.

Durations/energy come from the shared cost model (the scheduler uses the same
estimator, modulated by per-worker noise it cannot see — so scheduling is
realistic, not oracle). Outputs are deterministic functions of H_task, which
is what makes speculative duplicates collapse by content identity in the CAS.
"""
from __future__ import annotations

import random

from .cost_model import load_time_s, model_vram_gb
from .scheduler import estimate_exec
from .worker import DispatchBatch, ExecResult, Executor, Worker


class SimExecutor(Executor):
    def __init__(self, seed: int = 0) -> None:
        self.rng = random.Random(seed)

    # ------------------------------------------------------------------
    def execute(self, batch: DispatchBatch, worker: Worker, cas) -> ExecResult:
        spec = batch.groups[0].spec

        # ---- §5.3 wrong-resource-spec fault: proactive failure report ----
        actual = spec.params.get("actual_vram_gb")
        if actual and float(actual) > worker.dev.vram_gb:
            detect = 2.0 + 0.35 * min(
                load_time_s(spec.model_id, worker.dev) if spec.model_id else 4.0,
                20.0)
            return ExecResult(outputs=[], duration_s=detect, load_s=0.0,
                              failed=True, failure="resource_shortage")

        mono = spec.params.get("monolithic_ops")
        if mono:
            return self._execute_monolithic(batch, worker, mono)

        hot = (not spec.model_id) or worker.is_hot_for(spec.h_model)
        dur, load_s, flops = estimate_exec(
            spec, len(batch.groups), worker.dev, hot=hot)
        dur *= self.rng.uniform(0.97, 1.06)     # service-time jitter
        outputs = [f"out:{g.h_task}".encode() for g in batch.groups]
        return ExecResult(outputs=outputs, duration_s=dur, load_s=load_s,
                          flops=flops)

    # ------------------------------------------------------------------
    def _execute_monolithic(self, batch, worker, serial_ops) -> ExecResult:
        """MF baseline: the whole workflow runs serially inside one opaque
        block allocation — including every internal model switch."""
        from .dag import OperatorSpec, OpType
        total = load_total = flops_total = 0.0
        current_model: str | None = None
        for o in serial_ops:
            spec = OperatorSpec(
                name="_", op_type=OpType(o["op_type"]),
                model_id=o["model_id"], tokens_in=o["tokens_in"],
                tokens_out=o["tokens_out"], train_tokens=o["train_tokens"],
                params={"lora": o["lora"]})
            hot = (not spec.model_id) or spec.model_id == current_model
            dur, load_s, flops = estimate_exec(spec, 1, worker.dev, hot=hot)
            if spec.model_id:
                current_model = spec.model_id
            total += dur
            load_total += load_s
            flops_total += flops
        total *= self.rng.uniform(0.97, 1.06)
        g = batch.groups[0]
        return ExecResult(outputs=[f"mono:{g.h_task}".encode()],
                          duration_s=total, load_s=load_total,
                          flops=flops_total)


class FaultInjector:
    """Declarative fault plans for the robustness experiments (§5.3)."""

    @staticmethod
    def crash_worker(engine, *, at_s: float, index: int = 0) -> None:
        engine.inject_crash(index, at_s)

    @staticmethod
    def understate_vram(dag, op_name: str, *, claimed_gb: float) -> None:
        """Tenant under-specifies GPU memory; record the true need so the
        simulated worker can detect the shortage at run time."""
        spec = dag.ops[op_name]
        true_need = model_vram_gb(
            spec.model_id, training=spec.op_type.value in ("sft", "dpo", "ppo"),
            lora=bool(spec.params.get("lora")))
        spec.params["min_vram_gb"] = claimed_gb
        spec.params["actual_vram_gb"] = true_need
        # the tenant's (wrong) hint REPLACES the class-derived requirement
        spec.resource_class = "gpu.small"

