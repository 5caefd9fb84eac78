"""The port's control plane against the reference's, on the CPU, in one
process.

Each scenario of ``tests/test_fabric.py`` is built twice from the same
seeds, once from each package's own classes (``OpType`` and the rest are
different classes in the two), and run on each package's
``FlowMeshEngine`` with its ``SimExecutor``. The telemetry summaries, every
DAG's lineage as ``(op, h_task, output_hash, executed)`` and the result
indexes must be equal. Both engines run in one process, so the sets whose
iteration order picks the executing tenant of a shared op order alike; the
process-wide id counters (DAG, worker and batch ids) are restarted before
each run. Identity hashes, ``compile_spec`` of every template and the wire
codecs are compared too.
"""
import itertools
import json
from importlib import import_module
from types import SimpleNamespace

import pytest

PACKAGES = ("repro", "repro_torch")
MODULES = ("autoscaler", "backends", "cas", "control_plane", "cost_model",
           "dag", "events", "identity", "journal", "metrics", "scheduler",
           "simulator", "tracing", "transport", "worker", "workloads")
FABRIC = ("admission", "api", "cluster", "follower", "http", "operator",
          "replay", "service", "spec")


def package(name: str) -> SimpleNamespace:
    """A package's ``core`` and ``fabric`` modules by their short names."""
    ns = SimpleNamespace(**{m: import_module(f"{name}.core.{m}")
                            for m in MODULES})
    for m in FABRIC:
        setattr(ns, m, import_module(f"{name}.fabric.{m}"))
    ns.fabric = import_module(f"{name}.fabric")
    return ns


@pytest.fixture
def packages(monkeypatch):
    """Both packages with their id counters restarted."""
    pkgs = [package(name) for name in PACKAGES]
    for m in pkgs:
        for mod, attr in ((m.dag, "_dag_ids"), (m.backends, "_wid"),
                          (m.scheduler, "_batch_seq")):
            monkeypatch.setattr(mod, attr, itertools.count())
    return pkgs


def small_engine(m, policy=None, elastic=False, max_workers=8, **cfg):
    eng = m.control_plane.FlowMeshEngine(
        policy=policy or m.scheduler.FlowMeshScheduler(),
        executor=m.simulator.SimExecutor(seed=7),
        autoscaler=m.autoscaler.AutoscalerConfig(
            enabled=elastic, max_workers=max_workers, idle_timeout_s=60.0),
        config=m.control_plane.EngineConfig(seed=7, **cfg))
    eng.bootstrap_workers(["h100-nvl-94g", "rtx4090-48g", "rtx4090-24g"])
    return eng


def identical_workflow(m, tag="shared"):
    d = m.dag
    return d.WorkflowDAG([
        d.OperatorSpec("gen", d.OpType.GENERATE, "llama-3.2-1b",
                       inputs=[f"prompt:{tag}"], tokens_in=256,
                       tokens_out=64),
        d.OperatorSpec("score", d.OpType.SCORE, "reward-1b",
                       inputs=[d.Ref("gen")], tokens_in=256, tokens_out=8),
    ])


def identical(m):
    eng = small_engine(m)
    for i in range(5):
        eng.submit(identical_workflow(m), at=float(i))
    return eng


def distinct_inputs(m):
    eng = small_engine(m)
    for i in range(6):
        eng.submit(identical_workflow(m, tag=f"t{i}"), at=0.0)
    return eng


def dedup_across_time(m):
    eng = small_engine(m)
    eng.submit(identical_workflow(m), at=0.0)
    eng.submit(identical_workflow(m), at=500.0)
    return eng


def baseline(name):
    def build(m):
        eng = small_engine(m, policy=m.scheduler.POLICIES[name]())
        for i in range(4):
            eng.submit(identical_workflow(m), at=float(i))
        return eng
    return build


def worker_crash(m):
    eng = small_engine(m, speculation=False)
    gen = m.workloads.WorkloadGen(m.workloads.WorkloadCfg(seed=3))
    for t, dag in gen.make_workload("A", 12, horizon_s=120.0):
        eng.submit(dag, at=t)
    m.simulator.FaultInjector.crash_worker(eng, at_s=10.0, index=0)
    return eng


def understated_vram(m):
    d = m.dag
    eng = small_engine(m, policy=m.scheduler.FlowMeshScheduler(w_c=2.0),
                       speculation=False)
    dag = d.WorkflowDAG([
        d.OperatorSpec("sft", d.OpType.SFT, "llama-3.2-3b",
                       params={"lora": False, "lr": 1e-5},
                       inputs=["data:wrongspec"], train_tokens=500_000,
                       resource_class="gpu.small")])
    m.simulator.FaultInjector.understate_vram(dag, "sft", claimed_gb=8.0)
    eng.submit(dag, at=0.0)
    return eng


def speculative_replica(m):
    eng = small_engine(m, speculation=True, spec_factor=1.5, spec_check_s=5.0)
    straggler = eng.workers[eng.bootstrap_workers(["rtx4090-24g"])[0]]
    straggler.perf_noise = 12.0
    gen = m.workloads.WorkloadGen(m.workloads.WorkloadCfg(seed=5))
    for t, dag in gen.make_workload("A", 16, horizon_s=60.0):
        eng.submit(dag, at=t)
    return eng


def elastic_scale(m):
    eng = m.control_plane.FlowMeshEngine(
        executor=m.simulator.SimExecutor(seed=1),
        backend=m.backends.VastAiBackend(seed=1),
        autoscaler=m.autoscaler.AutoscalerConfig(
            enabled=True, min_workers=1, max_workers=10,
            idle_timeout_s=45.0, tick_s=10.0),
        config=m.control_plane.EngineConfig(seed=1))
    eng.bootstrap_workers(["rtx4090-24g"])
    gen = m.workloads.WorkloadGen(m.workloads.WorkloadCfg(seed=2))
    for t, dag in gen.make_workload("A", 40, horizon_s=400.0):
        eng.submit(dag, at=t)
    return eng


def workload_mix(m):
    eng = small_engine(m)
    gen = m.workloads.WorkloadGen(m.workloads.WorkloadCfg(seed=9))
    for t, dag in gen.make_workload("B", 10, horizon_s=200.0):
        eng.submit(dag, at=t)
    return eng


SCENARIOS = {
    "identical-workflows": identical,
    "distinct-inputs-batched": distinct_inputs,
    "dedup-across-time": dedup_across_time,
    **{f"baseline-{p}": baseline(p) for p in ("mf", "ds", "dr")},
    "worker-crash": worker_crash,
    "understated-vram": understated_vram,
    "speculative-replica": speculative_replica,
    "elastic-vastai": elastic_scale,
    "workload-mix-b": workload_mix,
}


def observed(eng) -> dict:
    tel = eng.run()
    return {
        "summary": tel.summary(),
        "lineage": {dag_id: [(l.op, l.h_task, l.output_hash, l.executed)
                             for l in dag.lineage]
                    for dag_id, dag in eng.dags.items()},
        "result_index": dict(eng.result_index),
        "failures": [tuple(f) for f in tel.failures_detected],
    }


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_matches_the_reference(packages, name):
    ref, port = (observed(SCENARIOS[name](m)) for m in packages)
    assert port["summary"]["tasks"] > 0
    for key in ref:
        assert port[key] == ref[key], key
    if not name.startswith("baseline"):       # the baselines never dedup
        # one execution per H_task, whichever tenant carried it
        executed = [h for rows in port["lineage"].values()
                    for _, h, _, ran in rows if ran]
        assert len(executed) == len(set(executed))


PARAMS = [
    None,
    {},
    {"lr": 1, "beta": 0.1},
    {"lr": 1.0, "beta": 0.1},
    {"b": {"z": [1, 2.5, (3, "x")], "a": {"k": 1.0}}, "a": "s"},
    {"tags": {"b", "a", "c"}, "frozen": frozenset({2, 1})},
    {"tuple": (1, 2), "list": [1, 2], "none": None, "flag": True},
    {"tenant": "acme", "min_vram_gb": 8.0, "priority": 3, "lr": 3e-4},
    {1: "int key", "1": "str key"},
]


@pytest.mark.parametrize("params", PARAMS, ids=range(len(PARAMS)))
def test_identity_hashes_match_the_reference(params):
    ref, port = (import_module(f"{p}.core.identity") for p in PACKAGES)
    h_model = port.model_hash("llama-3.2-1b", "main", ("lora-b", "lora-a"))
    assert h_model == ref.model_hash("llama-3.2-1b", "main",
                                     ("lora-b", "lora-a"))
    inputs = ("a" * 20, "b" * 20)
    assert port.canonical(params) == ref.canonical(params)
    assert port.task_hash(h_model, params, inputs) == \
        ref.task_hash(h_model, params, inputs)
    assert port.exec_signature(h_model, params, "gpu.large") == \
        ref.exec_signature(h_model, params, "gpu.large")
    data = port.canonical(params).encode()
    assert port.content_hash(data) == ref.content_hash(data)
    assert port.digest("prompt", *inputs) == ref.digest("prompt", *inputs)


def test_identity_normalizes_as_the_reference():
    port = import_module("repro_torch.core.identity")
    h = port.model_hash("m")
    assert port.task_hash(h, {"a": 1, "b": 2.0}, ()) == \
        port.task_hash(h, {"b": 2.0, "a": 1}, ())
    assert port.canonical({"s": {"b", "a"}}) == port.canonical({"s": ["a",
                                                                      "b"]})
    assert port.exec_signature(h, {"lr": 1, "tenant": "x"}, "cpu") == \
        port.exec_signature(h, {"lr": 1, "tenant": "y"}, "cpu")


def op_rows(dag) -> list:
    rows = []
    for name, op in sorted(dag.ops.items()):
        rows.append((name, op.op_type.value, op.model_id, op.revision,
                     op.adapters, json.dumps(op.params, sort_keys=True,
                                             default=repr),
                     [("ref", i.op) if type(i).__name__ == "Ref" else i
                      for i in op.inputs],
                     op.resource_class, op.tokens_in, op.tokens_out,
                     op.train_tokens, op.h_model, op.h_exec()))
    return rows


TEMPLATE_NAMES = sorted(import_module("repro.fabric.spec").TEMPLATES)


@pytest.mark.parametrize("template", TEMPLATE_NAMES)
def test_compile_spec_matches_the_reference(packages, template):
    ref, port = packages
    assert sorted(port.spec.TEMPLATES) == TEMPLATE_NAMES
    dags = [m.spec.compile_spec(m.spec.render_template(template,
                                                       tenant="acme"),
                                dag_id="d") for m in packages]
    assert op_rows(dags[1]) == op_rows(dags[0])
    assert [l for l in dags[1].ops] == [l for l in dags[0].ops]
    assert (dags[1].tenant, dags[1].metadata) == (dags[0].tenant,
                                                 dags[0].metadata)


def test_wire_codecs_round_trip(packages):
    ref, port = packages
    batches = []
    for m in packages:
        d, w = m.dag, m.worker
        spec = d.OperatorSpec("gen", d.OpType.GENERATE, "llama-3.2-1b",
                              params={"temperature": 0.0, "lr": 1},
                              inputs=["x"], adapters=("a",))
        groups = [w.ExecutionGroup(h_task=f"{i:020x}", h_exec=spec.h_exec(),
                                   spec=spec, input_hashes=(f"{i:020d}",))
                  for i in range(3)]
        batches.append(w.DispatchBatch(batch_id=4, h_exec=spec.h_exec(),
                                       groups=groups, worker_id="w-1",
                                       admitted_at=2.5, speculative=True))
    wire = port.transport.batch_to_wire(batches[1])
    assert wire == ref.transport.batch_to_wire(batches[0])
    back = port.transport.batch_from_wire(json.loads(json.dumps(wire)))
    assert port.transport.batch_to_wire(back) == wire
    assert back.groups[0].spec.op_type is port.dag.OpType.GENERATE
    result = port.worker.ExecResult(outputs=[b"\x00\xffbytes", "text"],
                                    duration_s=0.25, load_s=0.15, flops=1e9,
                                    energy_j=None, failed=False)
    rw = port.transport.result_to_wire(result)
    assert rw == ref.transport.result_to_wire(ref.worker.ExecResult(
        outputs=[b"\x00\xffbytes", "text"], duration_s=0.25, load_s=0.15,
        flops=1e9))
    back = port.transport.result_from_wire(json.loads(json.dumps(rw)))
    assert back.outputs == [b"\x00\xffbytes", b"text"]
    assert (back.duration_s, back.load_s, back.flops, back.failed) == \
        (0.25, 0.15, 1e9, False)
