"""Workflow DAG abstraction.

Each tenant workflow is compiled into its own DAG of fine-grained operators
(generation, scoring, SFT/DPO/PPO steps, eval, data prep, tool calls...).
The DAG stays a first-class isolated object — FlowMesh unifies *executions*,
never the graphs themselves (§3, "Provenance and Isolation").

An operator's inputs are either external literals (hashed into the CAS at
submission) or references to upstream operator outputs. ``H_task`` is therefore
only defined once every upstream output hash is known — identity captures the
full input lineage, exactly as in the paper.
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

from . import identity


class OpState(enum.Enum):
    PENDING = "pending"       # upstream outputs not yet available
    READY = "ready"           # all inputs resolved; eligible for scheduling
    RUNNING = "running"
    COMPLETED = "completed"


class OpType(str, enum.Enum):
    GENERATE = "generate"         # LLM inference / rollout generation
    SCORE = "score"               # reward-model inference
    SFT = "sft"                   # supervised fine-tuning stage
    DPO = "dpo"                   # direct preference optimization stage
    PPO = "ppo"                   # PPO policy update stage
    EVAL = "eval"                 # evaluation pass
    DATA_PREP = "data_prep"       # CPU-bound data transformation
    TOOL = "tool"                 # external tool call (search, code exec)
    AGGREGATE = "aggregate"       # collect/filter/merge artifacts


# Op types that run on an LLM executor and are continuously batchable.
BATCHABLE_TYPES = {OpType.GENERATE, OpType.SCORE, OpType.EVAL}
# Op types that are training steps (stateful executor, microbatchable).
TRAINING_TYPES = {OpType.SFT, OpType.DPO, OpType.PPO}

# Process-wide digest memos. Identity hashes are pure functions of their
# key, and a fabric sees the same few (model, params, inputs) combinations
# across thousands of submitted workflows — without these, every DAG
# instance re-pays the sha256 per operator. Bounded: cleared wholesale at
# the cap (correctness never depends on an entry being present).
_HASH_CACHE_MAX = 65536
_MODEL_HASH_CACHE: dict[tuple, str] = {}
_EXEC_SIG_CACHE: dict[tuple, str] = {}
_TASK_HASH_CACHE: dict[tuple, str] = {}


def _memo_digest(cache: dict, key: tuple, fn, *args) -> str:
    v = cache.get(key)
    if v is None:
        if len(cache) >= _HASH_CACHE_MAX:
            cache.clear()
        v = cache[key] = fn(*args)
    return v


@dataclass(frozen=True)
class Ref:
    """Reference to an upstream operator's output within the same DAG."""
    op: str


@dataclass
class OperatorSpec:
    """Static description of one operator. ``params`` carries hyperparameters
    AND resource hints (resource hints are stripped out of H_exec)."""
    name: str
    op_type: OpType
    model_id: str = ""                 # "" for pure-CPU ops (tool, data_prep)
    revision: str = "main"
    adapters: tuple[str, ...] = ()
    params: dict = field(default_factory=dict)
    inputs: list = field(default_factory=list)   # list[Ref | Any literal]
    resource_class: str = "gpu.small"
    # work sizing used by the cost model / T_eff estimator:
    tokens_in: int = 256
    tokens_out: int = 128
    train_tokens: int = 0              # for SFT/DPO/PPO stages

    # Both hashes are memoized: the scheduler hot path evaluates them per
    # candidate. The memo key carries every non-params identity input, so
    # pre-submit field mutation (benchmarks rewrite model_id /
    # resource_class) invalidates it; params are deliberately absent from
    # the key because the only post-submit params mutation in the system
    # is the ``min_vram_gb`` resource hint, which H_exec strips anyway.
    @property
    def h_model(self) -> str:
        key = (self.model_id, self.revision, self.adapters)
        c = self.__dict__.get("_hm")
        if c is not None and c[0] == key:
            return c[1]
        v = _memo_digest(_MODEL_HASH_CACHE, key, identity.model_hash, *key)
        self.__dict__["_hm"] = (key, v)
        return v

    def _type_prefix(self) -> str:
        """Memoized ``"<op_type>:<H_model>"`` digest prefix. Enum ``.value``
        routes through ``DynamicClassAttribute`` on every access, so the
        scheduler-visible hot paths (H_exec, ready promotion) cache the
        rendered prefix keyed on the current H_model."""
        hm = self.h_model
        c = self.__dict__.get("_pf")
        if c is not None and c[0] == hm:
            return c[1]
        v = f"{self.op_type.value}:{hm}"
        self.__dict__["_pf"] = (hm, v)
        return v

    def _canon_params(self) -> str:
        """Memoized ``canonical(strip_resource_hints(params))`` — shared by
        H_exec and H_task. Unkeyed on purpose: like the ``_hx`` key, it
        relies on the invariant that the only post-construction params
        mutation in the system is the ``min_vram_gb`` resource hint, which
        stripping removes before canonicalization anyway."""
        c = self.__dict__.get("_cp")
        if c is None:
            c = self.__dict__["_cp"] = identity.canonical(
                identity.strip_resource_hints(self.params))
        return c

    def h_exec(self) -> str:
        key = (self.op_type, self.model_id, self.revision, self.adapters,
               self.resource_class)
        c = self.__dict__.get("_hx")
        if c is not None and c[0] == key:
            return c[1]
        canon = self._canon_params()
        v = _memo_digest(
            _EXEC_SIG_CACHE, key + (canon,), identity.exec_signature_pre,
            self._type_prefix(), canon, self.resource_class)
        self.__dict__["_hx"] = (key, v)
        return v


_dag_ids = itertools.count()


@dataclass
class Lineage:
    """Per-edge provenance record: exact artifact versions consumed/produced."""
    op: str
    input_hashes: tuple[str, ...]
    output_hash: str
    h_task: str
    executed: bool      # False => satisfied from cache / consolidated run
    worker: str | None
    t_complete: float


class WorkflowDAG:
    """One tenant workflow: operators + dependency edges + per-op state."""

    def __init__(self, ops: Sequence[OperatorSpec], *, tenant: str = "default",
                 dag_id: str | None = None, submitted_at: float = 0.0,
                 metadata: Mapping[str, Any] | None = None,
                 validate: bool = True) -> None:
        self.dag_id = dag_id or f"dag-{next(_dag_ids)}"
        self.tenant = tenant
        self.submitted_at = submitted_at
        self.completed_at: float | None = None
        self.metadata = dict(metadata or {})
        self.ops: dict[str, OperatorSpec] = {}
        for op in ops:
            if op.name in self.ops:
                raise ValueError(f"duplicate operator name {op.name!r}")
            self.ops[op.name] = op
        self.state: dict[str, OpState] = {n: OpState.PENDING for n in self.ops}
        self.output_hash: dict[str, str] = {}
        self.input_hashes: dict[str, tuple[str, ...]] = {}
        self.h_task: dict[str, str] = {}
        self.lineage: list[Lineage] = []
        # validate=False is reserved for callers re-instantiating a graph
        # shape that already passed validation (the spec compiler's plan
        # cache) — edges and acyclicity are properties of the shape alone
        if validate:
            self._validate()

    # ------------------------------------------------------------------
    def _validate(self) -> None:
        for op in self.ops.values():
            for inp in op.inputs:
                if isinstance(inp, Ref) and inp.op not in self.ops:
                    raise ValueError(
                        f"{op.name} references unknown operator {inp.op!r}")
        self._topo_order()   # raises on cycles

    def _topo_order(self) -> list[OperatorSpec]:
        order, temp, perm = [], set(), set()

        def visit(name: str) -> None:
            if name in perm:
                return
            if name in temp:
                raise ValueError("workflow graph contains a cycle")
            temp.add(name)
            for inp in self.ops[name].inputs:
                if isinstance(inp, Ref):
                    visit(inp.op)
            temp.discard(name)
            perm.add(name)
            order.append(self.ops[name])

        for name in self.ops:
            visit(name)
        return order

    def parents(self, name: str) -> list[str]:
        return [i.op for i in self.ops[name].inputs if isinstance(i, Ref)]

    def children(self, name: str) -> list[str]:
        return [o.name for o in self.ops.values()
                if any(isinstance(i, Ref) and i.op == name for i in o.inputs)]

    # ------------------------------------------------------------------
    def resolve_inputs(self, name: str, cas) -> tuple[str, ...] | None:
        """Return the tuple of input content hashes for ``name`` if all
        upstream outputs are available, else None. Literal inputs are hashed
        into the CAS on first touch (submission-time interning)."""
        hashes: list[str] = []
        for inp in self.ops[name].inputs:
            if isinstance(inp, Ref):
                h = self.output_hash.get(inp.op)
                if h is None:
                    return None
                hashes.append(h)
            else:
                hashes.append(cas.put(inp))
        return tuple(hashes)

    def refresh_ready(self, cas) -> list[str]:
        """Promote PENDING ops whose inputs are all resolved to READY and
        compute their H_task. Returns newly-READY op names."""
        newly = []
        for name, st in self.state.items():
            if st is not OpState.PENDING:
                continue
            hashes = self.resolve_inputs(name, cas)
            if hashes is None:
                continue
            op = self.ops[name]
            self.input_hashes[name] = hashes
            canon = op._canon_params()
            prefix = op._type_prefix()
            self.h_task[name] = _memo_digest(
                _TASK_HASH_CACHE, (prefix, canon, hashes),
                identity.task_hash_pre, prefix, canon, hashes)
            self.state[name] = OpState.READY
            newly.append(name)
        return newly

    def complete(self, name: str, output_hash: str, *, executed: bool,
                 worker: str | None, now: float) -> None:
        self.state[name] = OpState.COMPLETED
        self.output_hash[name] = output_hash
        self.lineage.append(Lineage(
            op=name, input_hashes=self.input_hashes.get(name, ()),
            output_hash=output_hash, h_task=self.h_task.get(name, ""),
            executed=executed, worker=worker, t_complete=now))
        if self.done and self.completed_at is None:
            self.completed_at = now

    @property
    def done(self) -> bool:
        return all(s is OpState.COMPLETED for s in self.state.values())

    @property
    def latency(self) -> float | None:
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at

    def replay_order(self) -> list[Lineage]:
        """Retrospective provenance: exact replay schedule of this DAG."""
        return sorted(self.lineage, key=lambda l: l.t_complete)
