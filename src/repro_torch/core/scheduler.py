"""Control-plane scheduling policies.

FlowMeshScheduler implements the paper's single scalar utility (Eq. 1):

    U(j, B) = w_t * T_eff(j, B) - w_c * C(j) + w_l * G_loc(j, B)

over feasible (worker, batch) candidates, where B is the next slice of the
compatible set S(H_exec) to admit into worker j's live queue Q_j(H_exec).
Baseline policies (first-fit / static routing / round-robin) share the same
interface so the engine code is identical across systems.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Callable, Sequence

from .cost_model import (DEVICE_CLASSES, DeviceClass, RESOURCE_CLASSES,
                         cpu_op_time_s, inference_time_s, load_time_s,
                         model_vram_gb, train_time_s)
from .dag import BATCHABLE_TYPES, TRAINING_TYPES, OpType, OperatorSpec
from .worker import DispatchBatch, ExecutionGroup, Worker

_batch_seq = itertools.count()


def next_batch_id() -> int:
    """Allocate a globally-unique ``DispatchBatch`` id. The lease transport
    keys leases on batch id, so *every* admitted batch — speculative
    replicas included — must be distinguishable on the wire."""
    return next(_batch_seq)


# ---------------------------------------------------------------------------
# Shared work estimator (also used by SimExecutor as simulation ground truth)
# ---------------------------------------------------------------------------
def estimate_exec(spec: OperatorSpec, batch: int, dev: DeviceClass, *,
                  hot: bool) -> tuple[float, float, float]:
    """Predict (duration_s, load_s, flops) of a batch of ``batch`` compatible
    operators on device class ``dev``."""
    load_s = 0.0
    if spec.model_id and not hot:
        load_s = load_time_s(spec.model_id, dev)
    #: per-RUN overhead (scheduler round-trip, tokenization, engine admission)
    #: — paid once per batched run, so consolidation amortizes it
    overhead = 3.0 if spec.model_id else 0.0
    if spec.op_type in BATCHABLE_TYPES:
        dur, flops, _ = inference_time_s(
            spec.model_id, dev, batch=batch,
            tokens_in=spec.tokens_in, tokens_out=spec.tokens_out)
    elif spec.op_type in TRAINING_TYPES:
        lora = bool(spec.params.get("lora", False))
        dur, flops = train_time_s(
            spec.model_id, dev, tokens=spec.train_tokens * max(1, batch),
            lora=lora)
        # PPO-style stages interleave rollout+update; add inference share
        if spec.op_type is OpType.PPO:
            gdur, gflops, _ = inference_time_s(
                spec.model_id, dev, batch=max(1, batch),
                tokens_in=spec.tokens_in, tokens_out=spec.tokens_out)
            dur, flops = dur + gdur, flops + gflops
    else:  # CPU-side ops: tool calls, data prep, aggregation
        dur, flops = cpu_op_time_s(spec.op_type.value, batch), 0.0
    return dur + overhead, load_s, flops


#: (model_id, training, lora) -> model_vram_gb result. The hint path stays
#: uncached — ``min_vram_gb`` is mutated at runtime on resource_shortage.
_VRAM_CACHE: dict[tuple[str, bool, bool], float] = {}

#: (op_type, model_id, tokens_in, tokens_out, train_tokens, lora, batch,
#:  dev, hot) -> estimate_exec result. estimate_exec is pure in exactly
#: these inputs; the cache returns the very floats computed on first call,
#: so memoized utilities are bit-identical to recomputed ones.
_EXEC_CACHE: dict[tuple, tuple[float, float, float]] = {}
_EXEC_CACHE_MAX = 65536


def _estimate_cached(spec: OperatorSpec, batch: int, dev: DeviceClass,
                     hot: bool) -> tuple[float, float, float]:
    key = (spec.op_type, spec.model_id, spec.tokens_in, spec.tokens_out,
           spec.train_tokens, bool(spec.params.get("lora", False)),
           batch, dev.name, hot)
    r = _EXEC_CACHE.get(key)
    if r is None:
        if len(_EXEC_CACHE) > _EXEC_CACHE_MAX:
            _EXEC_CACHE.clear()
        r = _EXEC_CACHE[key] = estimate_exec(spec, batch, dev, hot=hot)
    return r


def vram_needed_gb(spec: OperatorSpec) -> float:
    if not spec.model_id:
        return 0.0
    # honor the tenant's (possibly wrong!) hint when present — §5.3 robustness
    hint = spec.params.get("min_vram_gb")
    if hint is not None:
        return float(hint)
    key = (spec.model_id, spec.op_type in TRAINING_TYPES,
           bool(spec.params.get("lora", False)))
    v = _VRAM_CACHE.get(key)
    if v is None:
        v = _VRAM_CACHE[key] = model_vram_gb(key[0], training=key[1],
                                             lora=key[2])
    return v


def feasible(spec: OperatorSpec, worker: Worker) -> bool:
    dev = worker.dev
    min_vram = RESOURCE_CLASSES.get(spec.resource_class, 0.0)
    if spec.resource_class != "cpu" or spec.model_id:
        if dev.vram_gb < max(min_vram, vram_needed_gb(spec)):
            return False
    aff = spec.params.get("affinity")
    if aff and dev.name not in aff and worker.backend not in aff:
        return False
    anti = spec.params.get("anti_affinity")
    if anti and (dev.name in anti or worker.backend in anti):
        return False
    return True


# ---------------------------------------------------------------------------
@dataclass
class Proposal:
    worker: Worker
    h_exec: str
    groups: list[ExecutionGroup]
    utility: float
    speculative: bool = False

    def to_batch(self, now: float) -> DispatchBatch:
        return DispatchBatch(batch_id=next_batch_id(), h_exec=self.h_exec,
                             groups=self.groups, worker_id=self.worker.worker_id,
                             admitted_at=now, speculative=self.speculative)


class SchedulerPolicy:
    """Interface. ``dedup``/``max_batch`` gate consolidation for baselines."""
    name = "base"
    dedup = True
    monolithic = False

    def max_batch(self, spec: OperatorSpec) -> int:
        return int(spec.params.get("max_batch", 24))

    def schedule(self, pending: dict[str, list[ExecutionGroup]],
                 workers: Sequence[Worker], now: float) -> list[Proposal]:
        raise NotImplementedError


_MAX_PRICE = max(d.price_hr for d in DEVICE_CLASSES.values())


class FlowMeshScheduler(SchedulerPolicy):
    """Decompose + consolidate, utility-driven (the paper's system)."""
    name = "flowmesh"
    dedup = True

    def __init__(self, w_t: float = 1.0, w_c: float = 0.5, w_l: float = 0.5,
                 *, reference_dev: DeviceClass | None = None) -> None:
        self.w_t, self.w_c, self.w_l = w_t, w_c, w_l
        self.ref = reference_dev or DEVICE_CLASSES["h100-nvl-94g"]

    # -- Eq. 1 terms ---------------------------------------------------------
    def t_eff(self, spec: OperatorSpec, batch: int, w: Worker, hot: bool) -> float:
        dur, load_s, _ = estimate_exec(spec, batch, w.dev, hot=hot)
        ref_dur, _, _ = estimate_exec(spec, batch, self.ref, hot=True)
        total = dur + load_s
        return (ref_dur / total) if total > 0 else 1.0   # normalized throughput

    @staticmethod
    def c(w: Worker) -> float:
        return w.dev.price_hr / _MAX_PRICE

    @staticmethod
    def g_loc(spec: OperatorSpec, groups: list[ExecutionGroup], w: Worker) -> float:
        gain = 0.0
        if not spec.model_id or w.is_hot_for(spec.h_model):
            gain += 1.0
        hashes = [h for g in groups for h in g.input_hashes]
        if hashes:
            cached = sum(1 for h in hashes if h in w.local_cache)
            gain += 0.25 * cached / len(hashes)
        if spec.h_exec() in w.served_execs:
            gain += 0.25      # hot lane: runtime state (KV/adapters) resident
        return gain

    def utility(self, spec: OperatorSpec, groups: list[ExecutionGroup],
                w: Worker) -> float:
        hot = (not spec.model_id) or w.is_hot_for(spec.h_model)
        return (self.w_t * self.t_eff(spec, len(groups), w, hot)
                - self.w_c * self.c(w)
                + self.w_l * self.g_loc(spec, groups, w))

    # -- candidate enumeration -----------------------------------------------
    def schedule_reference(self, pending, workers, now):
        """Naive O(rounds * pools * workers) rescan. Kept verbatim as the
        correctness oracle for the indexed ``schedule`` below — the
        differential property test asserts both produce identical proposal
        sequences on arbitrary pools/fleets."""
        proposals: list[Proposal] = []
        admittable = [w for w in workers if w.can_admit()]
        # mutable view of remaining capacity per worker this round
        slots = {w.worker_id: (w.MAX_QUEUED_SLICES - w.queued_slices())
                 for w in admittable}
        remaining = {h: list(gs) for h, gs in pending.items()}
        while True:
            best: Proposal | None = None
            for h_exec, groups in remaining.items():
                if not groups:
                    continue
                spec = groups[0].spec
                cap = self.max_batch(spec)
                # pool order is FIFO by ready time; admission control may have
                # reordered for fair share — the slice respects that order
                batch = groups[:cap]
                for w in admittable:
                    if slots[w.worker_id] <= 0 or not feasible(spec, w):
                        continue
                    u = self.utility(spec, batch, w)
                    if best is None or u > best.utility:
                        best = Proposal(w, h_exec, batch, u)
            if best is None:
                break
            proposals.append(best)
            slots[best.worker.worker_id] -= 1
            rem = remaining[best.h_exec]
            for g in best.groups:
                rem.remove(g)
        return proposals

    def _utility_fast(self, spec: OperatorSpec, n: int, hashes: list[str],
                      w: Worker, hx: str) -> float:
        """Bit-identical to ``utility(spec, batch, w)`` with the per-bucket
        invariants hoisted: ``n = len(batch)``, ``hashes`` pre-flattened,
        ``hx = spec.h_exec()``. Every float op replicates the reference's
        order of evaluation exactly, so memoization cannot perturb ties."""
        hot = (not spec.model_id) or w.is_hot_for(spec.h_model)
        dur, load_s, _ = _estimate_cached(spec, n, w.dev, hot)
        ref_dur, _, _ = _estimate_cached(spec, n, self.ref, True)
        total = dur + load_s
        t = (ref_dur / total) if total > 0 else 1.0
        gain = 0.0
        if not spec.model_id or w.is_hot_for(spec.h_model):
            gain += 1.0
        if hashes:
            lc = w.local_cache
            cached = 0
            for ih in hashes:
                if ih in lc:
                    cached += 1
            gain += 0.25 * cached / len(hashes)
        if hx in w.served_execs:
            gain += 0.25
        return (self.w_t * t
                - self.w_c * (w.dev.price_hr / _MAX_PRICE)
                + self.w_l * gain)

    def schedule(self, pending, workers, now):
        """Indexed best-candidate selection.

        The reference rescans every (pool, worker) pair per proposal even
        though a proposal only perturbs ONE pool's front slice and ONE
        worker's slot count. Here each candidate is a max-heap entry
        ``(-utility, exec_rank, worker_rank, version, h_exec, worker)``;
        after a proposal, only the dirtied bucket is eagerly recomputed and
        re-pushed under a bumped version (utility can rise when the front
        slice changes, so lazy invalidation would strand too-low stale
        entries). Stale versions and slot-exhausted workers are discarded
        at pop. Tie-breaking matches the reference exactly: strict ``>``
        keeps the first maximum in (pool dict order, admittable order) —
        the heap realizes the same order via (exec_rank, worker_rank),
        which is unique per pair, so comparison never reaches the
        non-comparable trailing fields."""
        cls = type(self)
        if (cls.utility is not FlowMeshScheduler.utility
                or cls.t_eff is not FlowMeshScheduler.t_eff
                or cls.g_loc is not FlowMeshScheduler.g_loc
                or cls.c is not FlowMeshScheduler.c
                or cls.max_batch is not FlowMeshScheduler.max_batch):
            # a subclass changed the objective — the index's hoisted
            # arithmetic no longer mirrors it; fall back to the oracle
            return self.schedule_reference(pending, workers, now)
        admittable = [w for w in workers if w.can_admit()]
        slots = {w.worker_id: (w.MAX_QUEUED_SLICES - w.queued_slices())
                 for w in admittable}
        remaining = {h: list(gs) for h, gs in pending.items()}
        exec_rank = {h: i for i, h in enumerate(remaining)}
        version = dict.fromkeys(remaining, 0)
        feas: dict[tuple[str, str], bool] = {}
        heap: list = []
        proposals: list[Proposal] = []

        def push_bucket(h: str) -> None:
            groups = remaining[h]
            if not groups:
                return
            spec = groups[0].spec
            batch = groups[:self.max_batch(spec)]
            n = len(batch)
            hashes = [ih for g in batch for ih in g.input_hashes]
            hx = spec.h_exec()
            er, ver = exec_rank[h], version[h]
            for wi, w in enumerate(admittable):
                if slots[w.worker_id] <= 0:
                    continue
                key = (h, w.worker_id)
                ok = feas.get(key)
                if ok is None:
                    ok = feas[key] = feasible(spec, w)
                if not ok:
                    continue
                u = self._utility_fast(spec, n, hashes, w, hx)
                heapq.heappush(heap, (-u, er, wi, ver, h, w))

        for h in remaining:
            push_bucket(h)
        while heap:
            nu, er, wi, ver, h, w = heapq.heappop(heap)
            if ver != version[h] or slots[w.worker_id] <= 0:
                continue            # stale bucket / exhausted worker
            groups = remaining[h]
            batch = groups[:self.max_batch(groups[0].spec)]
            proposals.append(Proposal(w, h, batch, -nu))
            slots[w.worker_id] -= 1
            del groups[:len(batch)]
            version[h] += 1
            push_bucket(h)
        return proposals


class RoundRobinScheduler(SchedulerPolicy):
    """DR baseline: decompose + round-robin, no consolidation, no batching."""
    name = "round_robin"
    dedup = False

    def __init__(self) -> None:
        self._rr = 0

    def max_batch(self, spec: OperatorSpec) -> int:
        return 1

    def schedule(self, pending, workers, now):
        proposals = []
        admittable = [w for w in workers if w.can_admit()]
        if not admittable:
            return proposals
        slots = {w.worker_id: (w.MAX_QUEUED_SLICES - w.queued_slices())
                 for w in admittable}
        flat = [g for gs in pending.values() for g in gs]
        flat.sort(key=lambda g: g.ready_at)
        for g in flat:
            placed = False
            for k in range(len(admittable)):
                w = admittable[(self._rr + k) % len(admittable)]
                if slots[w.worker_id] > 0 and feasible(g.spec, w):
                    proposals.append(Proposal(w, g.h_exec, [g], 0.0))
                    slots[w.worker_id] -= 1
                    self._rr = (self._rr + k + 1) % len(admittable)
                    placed = True
                    break
            if not placed:
                continue
        return proposals


#: op-type -> designated worker role for the DS (JellyBean-style) baseline
_STATIC_ROLES: dict[OpType, str] = {
    OpType.GENERATE: "inference", OpType.SCORE: "inference",
    OpType.EVAL: "inference", OpType.SFT: "training", OpType.DPO: "training",
    OpType.PPO: "training", OpType.TOOL: "aux", OpType.DATA_PREP: "aux",
    OpType.AGGREGATE: "aux",
}


def static_role_of(worker: Worker) -> str:
    """DS designates workers by class: big-VRAM -> training, GPUs -> inference,
    CPU -> aux. Fixed for the worker's lifetime (static routing)."""
    if worker.dev.vram_gb >= 80:
        return "training"
    if worker.dev.vram_gb > 0:
        return "inference"
    return "aux"


class StaticRoutingScheduler(SchedulerPolicy):
    """DS baseline: decompose + static functional routing (JellyBean)."""
    name = "static"
    dedup = False

    def max_batch(self, spec: OperatorSpec) -> int:
        return 1

    def schedule(self, pending, workers, now):
        proposals = []
        slots = {w.worker_id: (w.MAX_QUEUED_SLICES - w.queued_slices())
                 for w in workers if w.can_admit()}
        flat = sorted((g for gs in pending.values() for g in gs),
                      key=lambda g: g.ready_at)
        for g in flat:
            role = _STATIC_ROLES.get(g.spec.op_type, "aux")
            # least-loaded designated worker that is feasible
            cands = [w for w in workers
                     if w.can_admit() and slots.get(w.worker_id, 0) > 0
                     and static_role_of(w) == role and feasible(g.spec, w)]
            if not cands:
                # aux ops may fall back to any feasible worker (JellyBean
                # co-locates lightweight ops); GPU ops must wait
                if role == "aux":
                    cands = [w for w in workers
                             if w.can_admit() and slots.get(w.worker_id, 0) > 0
                             and feasible(g.spec, w)]
                if not cands:
                    continue
            w = min(cands, key=lambda w: w.queued_slices())
            proposals.append(Proposal(w, g.h_exec, [g], 0.0))
            slots[w.worker_id] -= 1
        return proposals


class FirstFitScheduler(SchedulerPolicy):
    """MF baseline: Monolithic + First-Fit. The engine submits each workflow
    as ONE opaque operator (no decomposition); this policy just first-fits it
    onto the first feasible idle worker."""
    name = "first_fit"
    dedup = False
    monolithic = True

    def max_batch(self, spec: OperatorSpec) -> int:
        return 1

    def schedule(self, pending, workers, now):
        proposals = []
        busy: set[str] = set()
        flat = sorted((g for gs in pending.values() for g in gs),
                      key=lambda g: g.ready_at)
        for g in flat:
            for w in workers:   # first fit, stable order
                if (w.worker_id not in busy and w.can_admit()
                        and w.queued_slices() == 0 and feasible(g.spec, w)):
                    proposals.append(Proposal(w, g.h_exec, [g], 0.0))
                    busy.add(w.worker_id)
                    break
        return proposals


POLICIES: dict[str, Callable[[], SchedulerPolicy]] = {
    "flowmesh": FlowMeshScheduler,
    "mf": FirstFitScheduler,
    "ds": StaticRoutingScheduler,
    "dr": RoundRobinScheduler,
}
