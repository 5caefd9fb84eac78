"""The paper's multi-tenant RLHF workflow (Fig. 2: SFT -> rollout -> reward
-> PPO -> eval) on the port's own fabric, with real compute.

    PYTHONPATH=src python -m repro_torch.launch.rlhf
    PYTHONPATH=src python -m repro_torch.launch.rlhf --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.rlhf --reduced --device cpu \
        --service build/flowmesh-service

The counterpart of ``examples/rlhf_pipeline.py``: four tenants submit
RLHF variants over overlapping data (``WorkloadGen(WorkloadCfg(seed=11,
overlap=0.9))``, at t = 0, 1, 2, 3) to a ``FlowMeshEngine`` with two
``rtx4090-24g`` workers and a ``TorchExecutor``; shared stages collide by
H_task and execute once. By default the executor runs full-width
smollm-135m on the card; ``--reduced`` takes the reference executor's tiny
config. Prints each DAG's stages and a ``[fabric]`` JSON line, and raises
unless all four workflows completed every op with exactly one execution
per H_task and some dedup.

``--service DIR`` runs the tenants through the journaled service instead
(``run_service``): a ``FabricService`` over a ``DiskCAS`` in DIR, whose
journal shares the store with the artifacts as ``fabric_cli serve
--journal`` does, driven through its ``FabricAPI``: ``rlhf`` for t0 and t1
on ``gsm8k/shard-0`` (so everything dedups), ``rlhf`` for t2 on
``gsm8k/shard-1`` and ``distill`` for t3 on ``gsm8k/shard-0``. It prints a
``[service]`` line.
"""
from __future__ import annotations

import argparse
import json
import pickle
import statistics
import time
from collections import Counter

from repro_torch.core.cas import DiskCAS
from repro_torch.core.control_plane import EngineConfig, FlowMeshEngine
from repro_torch.core.dag import OpType
from repro_torch.core.journal import EventJournal
from repro_torch.core.torch_executor import TorchExecutor
from repro_torch.core.workloads import WorkloadCfg, WorkloadGen
from repro_torch.fabric.api import FabricAPI
from repro_torch.fabric.service import FabricService
from repro_torch.serve.engine import Request, ServingEngine

N_TENANTS = 4
#: (template, tenant, shard) of the service's tenants
SERVICE_TENANTS = (("rlhf", "t0", "gsm8k/shard-0"),
                   ("rlhf", "t1", "gsm8k/shard-0"),
                   ("rlhf", "t2", "gsm8k/shard-1"),
                   ("distill", "t3", "gsm8k/shard-0"))
assert len(SERVICE_TENANTS) == N_TENANTS


def run_fabric(executor) -> FlowMeshEngine:
    """Four RLHF workflows through a fresh engine on ``executor``."""
    eng = FlowMeshEngine(executor=executor,
                         config=EngineConfig(seed=0, speculation=False))
    eng.bootstrap_workers(["rtx4090-24g", "rtx4090-24g"])
    gen = WorkloadGen(WorkloadCfg(seed=11, overlap=0.9))
    for i in range(N_TENANTS):
        eng.submit(gen.rlhf_full(), at=float(i))
    eng.run()
    return eng


def service(executor, cas_dir) -> FabricService:
    """A fresh journaled service on ``executor``: artifacts and journal in
    one ``DiskCAS`` at ``cas_dir``; the default device classes."""
    cas = DiskCAS(cas_dir)
    return FabricService(executor=executor, cas=cas,
                         journal=EventJournal(cas),
                         config=EngineConfig(seed=0, speculation=False))


def submit_tenants(api, tenants=SERVICE_TENANTS) -> list[str]:
    """POST each tenant's template to ``api`` (a ``FabricAPI`` or a
    ``RemoteAPI``); returns the job ids."""
    jobs = []
    for template, tenant, shard in tenants:
        code, job = api.handle("POST", "/workflows", {
            "template": template,
            "params": {"tenant": tenant, "shard": shard}})
        if code != 201:
            raise AssertionError(f"submit {tenant}: HTTP {code} {job}")
        jobs.append(job["job_id"])
    return jobs


def run_service(executor, cas_dir) -> FabricService:
    """The service's tenants through a fresh journaled service on
    ``executor``, submitted and drained through its ``FabricAPI``."""
    svc = service(executor, cas_dir)
    api = FabricAPI(svc)
    submit_tenants(api)
    code, out = api.handle("POST", "/drain", {})
    if code != 200:
        raise AssertionError(f"drain: HTTP {code} {out}")
    return svc


def check(eng: FlowMeshEngine) -> dict:
    """The example's assertions and the fabric's: every workflow and op
    complete, one execution per H_task, some dedup. Returns the summary."""
    s = eng.telemetry.summary()
    if s["tasks"] != N_TENANTS:
        raise AssertionError(f"{s['tasks']} of {N_TENANTS} workflows done")
    for dag in eng.dags.values():
        if not dag.done or set(dag.output_hash) != set(dag.ops):
            raise AssertionError(f"{dag.dag_id}: ops left incomplete")
    runs = Counter(l.h_task for dag in eng.dags.values()
                   for l in dag.lineage if l.executed)
    every = {l.h_task for dag in eng.dags.values() for l in dag.lineage}
    if set(runs) != every or max(runs.values()) != 1:
        raise AssertionError(f"executions per H_task {dict(runs)}, want one "
                             f"for each of {len(every)}")
    if s["dedup_savings"] <= 0:
        raise AssertionError("no dedup across the overlapping tenants")
    return s


def check_alone(eng: FlowMeshEngine, executor) -> int:
    """Every published GENERATE, SCORE and EVAL payload against its prompt
    run alone through a fresh ``ServingEngine``: cross-tenant dedup hands
    one tenant's output to another, which is sound only if an output does
    not depend on the requests that shared its batch. Returns the number of
    payloads checked; raises on the first that differs."""
    served = (OpType.GENERATE, OpType.SCORE, OpType.EVAL)
    checked = set()
    for dag in eng.dags.values():
        for row in dag.lineage:
            inputs = dag.resolve_inputs(row.op, eng.cas)
            if dag.ops[row.op].op_type not in served or inputs in checked:
                continue
            prompt = executor._prompt_from(inputs)
            alone = ServingEngine(executor.model, executor.params, n_slots=4,
                                  max_len=256)
            req = Request(prompt, max_new_tokens=executor.gen_tokens,
                          temperature=0.0)
            alone.run([req])
            published = pickle.loads(eng.cas.get_bytes(row.output_hash))
            if published["tokens"] != req.generated:
                raise AssertionError(
                    f"{dag.dag_id}/{row.op}: published {published['tokens']}"
                    f", alone {req.generated}")
            checked.add(inputs)
    return len(checked)


def median_op_ms(executor) -> dict:
    return {op: statistics.median(ms) for op, ms in
            sorted(executor.op_ms.items())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true",
                    help="the reference executor's tiny config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--service", metavar="DIR",
                    help="run the service's tenants through a journaled "
                         "FabricService over a DiskCAS in DIR")
    args = ap.parse_args(argv)

    executor = TorchExecutor(seed=0, full_width=not args.reduced,
                             device=args.device)
    t0 = time.perf_counter()
    if args.service:
        svc = run_service(executor, args.service)
        eng = svc.engine
    else:
        eng = run_fabric(executor)
    wall = time.perf_counter() - t0
    s = check(eng)
    for dag in eng.dags.values():
        stages = {l.op: ("ran" if l.executed else "cached")
                  for l in dag.lineage}
        print(f"  {dag.dag_id}: {stages}")
    result = {"arch": executor.cfg.name, "device": str(executor.device),
              "workflows": s["tasks"], "executions": s["executions"],
              "dedup_savings": s["dedup_savings"],
              "mean_batch": s["mean_batch"], "model_loads": s["model_loads"],
              "hot_hits": s["hot_hits"],
              "median_op_ms": median_op_ms(executor), "wall_s": wall}
    if args.service:
        result["jobs"] = {jid: svc.job(jid)["status"] for jid in svc.jobs}
        result["journal"] = svc.journal.chain_stats()
    print(f"[{'service' if args.service else 'fabric'}] "
          f"{json.dumps(result)}")
    return result


if __name__ == "__main__":
    main()
