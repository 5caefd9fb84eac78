"""The paper's multi-tenant RLHF workflow (Fig. 2: SFT -> rollout -> reward
-> PPO -> eval) on the port's own fabric, with real compute.

    PYTHONPATH=src python -m repro_torch.launch.rlhf
    PYTHONPATH=src python -m repro_torch.launch.rlhf --reduced --device cpu

The counterpart of ``examples/rlhf_pipeline.py``: four tenants submit
RLHF variants over overlapping data (``WorkloadGen(WorkloadCfg(seed=11,
overlap=0.9))``, at t = 0, 1, 2, 3) to a ``FlowMeshEngine`` with two
``rtx4090-24g`` workers and a ``TorchExecutor``; shared stages collide by
H_task and execute once. By default the executor runs full-width
smollm-135m on the card; ``--reduced`` takes the reference executor's tiny
config. Prints each DAG's stages and a ``[fabric]`` JSON line, and raises
unless all four workflows completed every op with exactly one execution
per H_task and some dedup.
"""
from __future__ import annotations

import argparse
import json
import pickle
import statistics
import time
from collections import Counter

from repro_torch.core.control_plane import EngineConfig, FlowMeshEngine
from repro_torch.core.dag import OpType
from repro_torch.core.torch_executor import TorchExecutor
from repro_torch.core.workloads import WorkloadCfg, WorkloadGen
from repro_torch.serve.engine import Request, ServingEngine

N_TENANTS = 4


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
    args = ap.parse_args(argv)

    executor = TorchExecutor(seed=0, full_width=not args.reduced,
                             device=args.device)
    t0 = time.perf_counter()
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
    print(f"[fabric] {json.dumps(result)}")
    return result


if __name__ == "__main__":
    main()
