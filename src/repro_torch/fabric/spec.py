"""Declarative workflow specs — the fabric's tenant-facing wire format.

A workflow is a plain dict/JSON document (ops, params, edges, tenant,
deadline) that is validated and compiled into a ``WorkflowDAG``. Tenants
never construct ``OperatorSpec`` objects; they POST documents like::

    {
      "name": "nightly-eval",
      "tenant": "acme",
      "deadline_s": 3600,
      "ops": [
        {"name": "prep", "op_type": "data_prep", "inputs": ["gsm8k/shard-0"],
         "resource_class": "cpu"},
        {"name": "eval", "op_type": "eval", "model_id": "llama-3.2-1b",
         "inputs": [{"ref": "prep"}, "gsm8k/holdout"]}
      ]
    }

Input edges are either literals (hashed into the CAS at submission), the
``{"ref": "<op>"}`` object form, or the ``"@<op>"`` string shorthand.

A small library of named templates (rlhf, distill, agent-loop, batch-eval)
covers the common pipeline shapes; ``core.workloads`` renders its synthetic
tenants through the same templates, so the benchmark traffic and the service
traffic share one compilation path.
"""
from __future__ import annotations

import json
from collections.abc import Mapping   # abc fast-path isinstance (hot path)
from typing import Any, Callable

from repro_torch.core.cost_model import RESOURCE_CLASSES
from repro_torch.core.dag import OperatorSpec, OpType, Ref, WorkflowDAG

SPEC_VERSION = 1

_OP_TYPES = {t.value for t in OpType}
#: value -> member, skipping the Enum __call__ machinery per compiled op
_OP_TYPE_MEMBERS = {t.value: t for t in OpType}
_TRAINING = {"sft", "dpo", "ppo"}


class SpecError(ValueError):
    """Raised when a workflow document fails validation/compilation."""

    def __init__(self, errors: list[str]) -> None:
        self.errors = errors
        super().__init__("invalid workflow spec: " + "; ".join(errors))


def default_resource_class(model_id: str, *, training: bool = False) -> str:
    """Resource class heuristic shared by templates and the workload gen."""
    if not model_id:
        return "cpu"
    if training and model_id.endswith("8b"):
        return "gpu.xlarge"
    if training:
        return "gpu.large"
    if model_id.endswith("8b"):
        return "gpu.medium"
    return "gpu.small"


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------
def _check_op(op: Any, idx: int, names: set[str], errors: list[str]) -> None:
    where = f"ops[{idx}]"
    if not isinstance(op, Mapping):
        errors.append(f"{where}: expected an object, got {type(op).__name__}")
        return
    name = op.get("name")
    if not isinstance(name, str) or not name:
        errors.append(f"{where}: missing or empty 'name'")
    elif name in names:
        errors.append(f"{where}: duplicate operator name {name!r}")
    else:
        names.add(name)
    op_type = op.get("op_type")
    if op_type not in _OP_TYPES:
        errors.append(f"{where}: unknown op_type {op_type!r} "
                      f"(expected one of {sorted(_OP_TYPES)})")
    rc = op.get("resource_class")
    if rc is not None and rc not in RESOURCE_CLASSES:
        errors.append(f"{where}: unknown resource_class {rc!r} "
                      f"(expected one of {sorted(RESOURCE_CLASSES)})")
    for field in ("model_id", "revision"):
        v = op.get(field)
        if v is not None and not isinstance(v, str):
            errors.append(f"{where}: {field} must be a string")
    adapters = op.get("adapters")
    if adapters is not None and (
            not isinstance(adapters, (list, tuple))
            or not all(isinstance(a, str) for a in adapters)):
        errors.append(f"{where}: adapters must be a list of strings")
    for field in ("tokens_in", "tokens_out", "train_tokens"):
        v = op.get(field)
        if v is not None and (not isinstance(v, int) or v < 0):
            errors.append(f"{where}: {field} must be a non-negative int")
    params = op.get("params")
    if params is not None and not isinstance(params, Mapping):
        errors.append(f"{where}: params must be an object")
    inputs = op.get("inputs", [])
    if not isinstance(inputs, list):
        errors.append(f"{where}: inputs must be a list")
    if op_type in _TRAINING and not op.get("model_id"):
        errors.append(f"{where}: training op requires a model_id")


def validate_spec(doc: Any) -> list[str]:
    """Return a list of human-readable problems (empty == valid)."""
    errors: list[str] = []
    if not isinstance(doc, Mapping):
        return [f"spec must be an object, got {type(doc).__name__}"]
    version = doc.get("version", SPEC_VERSION)
    if version != SPEC_VERSION:
        errors.append(f"unsupported spec version {version!r}")
    tenant = doc.get("tenant", "default")
    if not isinstance(tenant, str) or not tenant:
        errors.append("tenant must be a non-empty string")
    name = doc.get("name")
    if name is not None and not isinstance(name, str):
        errors.append("name must be a string")
    metadata = doc.get("metadata")
    if metadata is not None and not isinstance(metadata, Mapping):
        errors.append("metadata must be an object")
    deadline = doc.get("deadline_s")
    if deadline is not None and (
            not isinstance(deadline, (int, float)) or deadline <= 0):
        errors.append("deadline_s must be a positive number")
    ops = doc.get("ops")
    if not isinstance(ops, list) or not ops:
        errors.append("spec requires a non-empty 'ops' list")
        return errors
    names: set[str] = set()
    for i, op in enumerate(ops):
        _check_op(op, i, names, errors)
    if errors:
        return errors
    # second pass: edges must reference declared operators
    for i, op in enumerate(ops):
        for inp in op.get("inputs", []):
            ref = _as_ref(inp)
            if ref is not None and ref not in names:
                errors.append(
                    f"ops[{i}] ({op['name']}): input references unknown "
                    f"operator {ref!r}")
    return errors


def _as_ref(inp: Any) -> str | None:
    """Edge forms: {"ref": "op"} or "@op". Literal "@@x" escapes to "@x"."""
    if isinstance(inp, Mapping) and set(inp) == {"ref"}:
        return str(inp["ref"])
    if isinstance(inp, str) and inp.startswith("@") and not inp.startswith("@@"):
        return inp[1:]
    return None


def _as_literal(inp: Any) -> Any:
    if isinstance(inp, str) and inp.startswith("@@"):
        return inp[1:]
    return inp


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------
#: compiled-plan cache: canonical doc JSON -> (tenant, metadata, op protos).
#: A fabric sees the same few document *shapes* thousands of times (template
#: renders, workload generators, resubmissions); validation and parsing are
#: pure functions of the document content, so one content key skips both.
#: Each hit still instantiates FRESH OperatorSpec/WorkflowDAG objects —
#: engine-side state (params mutation, op states) never leaks across jobs.
#: Only plans that produced a valid DAG are cached, so error paths always
#: re-run full validation. Unserializable docs bypass the cache entirely.
_PLAN_CACHE_MAX = 1024
_PLAN_CACHE: dict[str, tuple] = {}


def _plan_key(doc: Mapping) -> str | None:
    try:
        return json.dumps(doc, sort_keys=True, separators=(",", ":"))
    except (TypeError, ValueError):
        return None


def _instantiate(plan: tuple, dag_id: str | None) -> WorkflowDAG:
    tenant, metadata, protos = plan
    ops = [OperatorSpec(
        name=p[0], op_type=p[1], model_id=p[2], revision=p[3], adapters=p[4],
        params=dict(p[5]), inputs=list(p[6]), resource_class=p[7],
        tokens_in=p[8], tokens_out=p[9], train_tokens=p[10])
        for p in protos]
    return WorkflowDAG(ops, tenant=tenant, dag_id=dag_id, metadata=metadata,
                       validate=False)


def compile_spec(doc: Mapping, *, dag_id: str | None = None) -> WorkflowDAG:
    """Validate ``doc`` and compile it into a ``WorkflowDAG``.

    Raises ``SpecError`` on any problem (including dependency cycles, which
    surface from the DAG's own topological check).
    """
    key = _plan_key(doc)
    if key is not None:
        plan = _PLAN_CACHE.get(key)
        if plan is not None:
            return _instantiate(plan, dag_id)
    errors = validate_spec(doc)
    if errors:
        raise SpecError(errors)
    protos: list[tuple] = []
    for op in doc["ops"]:
        op_type = _OP_TYPE_MEMBERS[op["op_type"]]
        model_id = op.get("model_id", "")
        inputs = tuple(
            Ref(r) if (r := _as_ref(i)) is not None else _as_literal(i)
            for i in op.get("inputs", []))
        protos.append((
            op["name"], op_type, model_id, op.get("revision", "main"),
            tuple(op.get("adapters", ())), dict(op.get("params", {})),
            inputs,
            op.get("resource_class") or default_resource_class(
                model_id, training=op["op_type"] in _TRAINING),
            op.get("tokens_in", 256), op.get("tokens_out", 128),
            op.get("train_tokens", 0)))
    metadata = dict(doc.get("metadata", {}))
    if "name" in doc:
        metadata.setdefault("name", doc["name"])
    if "deadline_s" in doc:
        metadata["deadline_s"] = float(doc["deadline_s"])
    plan = (doc.get("tenant", "default"), metadata, tuple(protos))
    try:
        dag = _instantiate(plan, dag_id)
        # the plan's DAG validated on THIS instantiation (validate=False
        # only applies to cache hits re-using a proven shape)
        dag._validate()
    except ValueError as e:          # cycles, duplicate names
        raise SpecError([str(e)]) from e
    if key is not None:
        if len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
            _PLAN_CACHE.clear()
        _PLAN_CACHE[key] = plan
    return dag


# ---------------------------------------------------------------------------
# template library
# ---------------------------------------------------------------------------
def _mb(max_batch: int) -> dict:
    return {"max_batch": max_batch}


def rlhf_template(*, tenant: str = "default", model: str = "llama-3.2-1b",
                  reward_model: str = "reward-1b", shard: str = "gsm8k/shard-0",
                  holdout: str | None = None, lora: bool = True,
                  train_tokens: int = 6_000_000, ppo_tokens: int = 2_400_000,
                  max_batch: int = 12) -> dict:
    """Full RLHF loop: prep -> SFT -> rollout -> reward -> PPO -> eval."""
    holdout = holdout or f"{shard.split('/')[0]}/holdout"
    return {
        "name": "rlhf", "tenant": tenant,
        "metadata": {"kind": "rlhf"},
        "ops": [
            {"name": "prep", "op_type": "data_prep", "inputs": [shard],
             "resource_class": "cpu"},
            {"name": "sft", "op_type": "sft", "model_id": model,
             "params": {"lora": lora, "lr": 1e-5, **_mb(max_batch)},
             "inputs": ["@prep"], "train_tokens": train_tokens},
            {"name": "rollout", "op_type": "generate", "model_id": model,
             "params": _mb(max_batch), "inputs": ["@sft", shard],
             "tokens_in": 512, "tokens_out": 512},
            {"name": "reward", "op_type": "score", "model_id": reward_model,
             "params": _mb(max_batch), "inputs": ["@rollout"],
             "tokens_in": 1024, "tokens_out": 8},
            {"name": "ppo", "op_type": "ppo", "model_id": model,
             "params": {"clip": 0.2, "lr": 1e-6, **_mb(max_batch)},
             "inputs": ["@rollout", "@reward"], "train_tokens": ppo_tokens,
             "tokens_in": 512, "tokens_out": 128},
            {"name": "eval", "op_type": "eval", "model_id": model,
             "params": _mb(max_batch), "inputs": ["@ppo", holdout],
             "tokens_in": 2048, "tokens_out": 128},
        ],
    }


def distill_template(*, tenant: str = "default",
                     teacher: str = "llama-3.1-8b",
                     student: str = "llama-3.2-1b",
                     shard: str = "gsm8k/shard-0", holdout: str | None = None,
                     train_tokens: int = 4_000_000, max_batch: int = 12,
                     ) -> dict:
    """Distillation: teacher generates, filter, student SFT, eval.

    Tenants distilling from the same teacher over the same shard collide on
    the expensive teacher pass — a prime cross-tenant dedup target.
    """
    holdout = holdout or f"{shard.split('/')[0]}/holdout"
    return {
        "name": "distill", "tenant": tenant,
        "metadata": {"kind": "distill"},
        "ops": [
            {"name": "teach", "op_type": "generate", "model_id": teacher,
             "params": _mb(max_batch), "inputs": [shard],
             "tokens_in": 1024, "tokens_out": 1536},
            {"name": "filter", "op_type": "aggregate", "inputs": ["@teach"],
             "resource_class": "cpu"},
            {"name": "sft", "op_type": "sft", "model_id": student,
             "params": {"lora": True, "lr": 2e-5, **_mb(max_batch)},
             "inputs": ["@filter"], "train_tokens": train_tokens},
            {"name": "eval", "op_type": "eval", "model_id": student,
             "params": _mb(max_batch), "inputs": ["@sft", holdout],
             "tokens_in": 2048, "tokens_out": 128},
        ],
    }


def agent_loop_template(*, tenant: str = "default",
                        model: str = "llama-3.2-1b",
                        shard: str = "gsm8k/shard-0", rounds: int = 1,
                        max_batch: int = 24) -> dict:
    """Agentic plan/tool/reflect loop with a final summarize stage."""
    rounds = max(1, int(rounds))
    ops: list[dict] = [
        {"name": "plan", "op_type": "generate", "model_id": model,
         "params": _mb(max_batch), "inputs": [shard],
         "tokens_in": 1024, "tokens_out": 768},
    ]
    prev = "plan"
    for r in range(rounds):
        ops.append({"name": f"tool_{r}", "op_type": "tool",
                    "inputs": [f"@{prev}"], "resource_class": "cpu"})
        is_last = r == rounds - 1
        name = "summarize" if is_last else f"reflect_{r}"
        ops.append({"name": name, "op_type": "generate", "model_id": model,
                    "params": _mb(max_batch), "inputs": [f"@tool_{r}", shard],
                    "tokens_in": 1536, "tokens_out": 768})
        prev = name
    return {"name": "agent-loop", "tenant": tenant,
            "metadata": {"kind": "agent_loop"}, "ops": ops}


def batch_eval_template(*, tenant: str = "default",
                        model: str = "llama-3.2-1b",
                        shards: list[str] | None = None,
                        max_batch: int = 24) -> dict:
    """Fan-out eval over shards with an aggregated report."""
    shards = shards or ["gsm8k/shard-0", "mmlu/shard-0", "truthfulqa/shard-0"]
    ops: list[dict] = []
    for i, shard in enumerate(shards):
        ops.append({"name": f"eval_{i}", "op_type": "eval", "model_id": model,
                    "params": _mb(max_batch), "inputs": [shard],
                    "tokens_in": 2048, "tokens_out": 128})
    ops.append({"name": "report", "op_type": "aggregate",
                "inputs": [f"@eval_{i}" for i in range(len(shards))],
                "resource_class": "cpu"})
    return {"name": "batch-eval", "tenant": tenant,
            "metadata": {"kind": "batch_eval"}, "ops": ops}


TEMPLATES: dict[str, Callable[..., dict]] = {
    "rlhf": rlhf_template,
    "distill": distill_template,
    "agent-loop": agent_loop_template,
    "batch-eval": batch_eval_template,
}


def list_templates() -> dict[str, str]:
    return {name: (fn.__doc__ or "").strip().splitlines()[0]
            for name, fn in TEMPLATES.items()}


def render_template(name: str, **params) -> dict:
    """Instantiate a named template into a plain workflow document."""
    try:
        fn = TEMPLATES[name]
    except KeyError:
        raise SpecError([f"unknown template {name!r} "
                         f"(have {sorted(TEMPLATES)})"]) from None
    return fn(**params)
