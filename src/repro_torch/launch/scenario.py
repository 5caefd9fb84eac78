"""A digital-twin scenario through the port's fabric, with real compute.

    PYTHONPATH=src python -m repro_torch.launch.scenario scenarios/steady_mix.yaml
    PYTHONPATH=src python -m repro_torch.launch.scenario \
        scenarios/steady_mix.yaml --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.scenario \
        scenarios/steady_mix.yaml --reduced --device cpu --mode open-loop

The counterpart of ``fabric_cli scenario run`` (which runs on
``SimExecutor``) with a ``TorchExecutor`` behind the service, as
``launch.rlhf`` is of ``examples/rlhf_pipeline.py``. The scenario is
compiled by ``repro_torch.scenarios`` and replayed against a fresh
``FabricService(seed=<the scenario's seed>, executor=...)`` with the
reference's defaults (its device classes, admission and speculation):
``--mode virtual`` through ``run_virtual(sc, svc=...)``, schedule seconds
on the engine's virtual clock, which the executor's measured op times
advance; ``--mode open-loop`` through ``run_open_loop`` against the
service behind ``FabricHTTPServer`` on loopback (auto-pumped), driven by a
``RemoteAPI`` client at the document's ``time_scale`` and ``settle_s``.
By default the executor runs full-width smollm-135m on the card;
``--reduced`` takes the reference executor's tiny config. Prints one
``[scenario]`` JSON line (the report, the executor's median wall ms per op
type, the engine's executions and retries) and raises unless every
scheduled job completed with exactly one published output per H_task.
YAML documents need PyYAML; a ``.json`` document loads without it.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

from repro_torch.core.torch_executor import TorchExecutor
from repro_torch.fabric.api import FabricAPI
from repro_torch.fabric.http import FabricHTTPServer, RemoteAPI
from repro_torch.fabric.service import FabricService
from repro_torch.launch.rlhf import median_op_ms
from repro_torch.scenarios import (FaultActions, Scenario, load_scenario,
                                   run_open_loop, run_virtual)

MODES = ("virtual", "open-loop")


def service(executor, seed: int) -> FabricService:
    """A fresh service on ``executor`` with the reference's defaults."""
    return FabricService(seed=seed, executor=executor)


def run(sc: Scenario, svc: FabricService, *, mode: str = "virtual",
        actions: FaultActions | None = None) -> dict:
    """Replays ``sc`` against ``svc`` and returns the report. Open loop
    serves ``svc`` over loopback HTTP for the run and stops the server."""
    if mode == "virtual":
        return run_virtual(sc, svc=svc, actions=actions)
    if mode != "open-loop":
        raise ValueError(f"mode {mode!r}, want one of {MODES}")
    server = FabricHTTPServer(FabricAPI(svc), host="127.0.0.1", port=0,
                              auto_pump=True).start()
    try:
        # a request waits on the server's lock while the pump thread runs a
        # batch: give it longer than the slowest op
        return run_open_loop(sc, RemoteAPI(server.url, timeout_s=300.0),
                             actions=actions)
    finally:
        server.stop()


def check(svc: FabricService, report: dict) -> dict:
    """Every scheduled job completed and every H_task published exactly one
    output, the result index's (speculation may run an op twice; only one
    copy publishes). Returns the engine's counts."""
    jobs = report["jobs"]
    if jobs["completed"] != jobs["submitted"] or not jobs["submitted"]:
        raise AssertionError(f"{report['scenario']}: jobs {jobs}")
    eng = svc.engine
    published = defaultdict(set)
    for dag in eng.dags.values():
        for row in dag.lineage:
            published[row.h_task].add(row.output_hash)
    many = {h: outs for h, outs in published.items()
            if outs != {eng.result_index.get(h)}}
    if many:
        raise AssertionError(f"{len(many)} of {len(published)} H_tasks "
                             f"published other than one output: {many}")
    s = eng.telemetry.summary()
    return {"h_tasks": len(published), "executions": s["executions"],
            "mean_batch": s["mean_batch"], "retries": s["retries"],
            "spec_launches": s["spec_launches"],
            "failures_detected": len(eng.telemetry.failures_detected)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("file", help="a scenario YAML/JSON document")
    ap.add_argument("--mode", choices=MODES, default="virtual")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference executor's tiny config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sc = load_scenario(args.file)
    executor = TorchExecutor(seed=0, full_width=not args.reduced,
                             device=args.device)
    svc = service(executor, sc.seed)
    t0 = time.perf_counter()
    report = run(sc, svc, mode=args.mode)
    wall = time.perf_counter() - t0
    result = {"arch": executor.cfg.name, "device": str(executor.device),
              "report": report, "engine": check(svc, report),
              "median_op_ms": median_op_ms(executor), "wall_s": wall}
    print(f"[scenario] {json.dumps(result)}")
    return result


if __name__ == "__main__":
    main()
