"""The port's digital-twin scenarios against the reference's, on the CPU, in
one process.

Both packages compile every checked-in scenario (``scenarios/*.yaml``) to
equal schedules, also under another seed, and replay them on
``SimExecutor`` to equal reports; the id counters (DAG, worker and batch
ids) are restarted before each run, and only the ``wall`` subtree, which
times the host, is masked. The same holds for the EDF-boost sweep, the
validation errors of malformed documents, the worker-kill and in-process
open-loop cases of ``tests/test_scenarios.py`` and the CLI's ``scenario``
subcommand. The primary-kill case runs on the port with that test's
assertions (it is wall clock, so not compared). ``steady_mix`` through
``launch.scenario`` on a reduced ``TorchExecutor`` on the CPU (the
reference's draws) gives the jobs and dedup blocks of the reference's
service on its ``JaxExecutor``, and every payload it published is the
reference executor's on the same input hashes (train losses up to the
last float bits). The scenario documents ``chip_smoke.py`` holds (the
machine with the card has no PyYAML) equal the files.
"""
import dataclasses
import importlib.util
import itertools
import json
import os
import pathlib
import pickle
import subprocess
import sys
import threading
from importlib import import_module
from types import SimpleNamespace

import numpy as np
import pytest

yaml = pytest.importorskip("yaml")
torch = pytest.importorskip("torch")

from test_torch_executor import executors  # noqa: E402,F401
from test_torch_fabric_core import PACKAGES, package  # noqa: E402
from test_torch_service_rlhf import LOSS_RTOL  # noqa: E402

from repro_torch.launch import scenario  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCENARIO_DIR = ROOT / "scenarios"
SCENARIO_FILES = sorted(SCENARIO_DIR.glob("*.yaml"))
IDS = [p.stem for p in SCENARIO_FILES]
SERVED = {"generate", "score", "eval"}
TRAINING = {"sft", "dpo", "ppo"}
#: the malformed documents of ``tests/test_scenarios.py`` and more
MALFORMED = {
    "bad-blocks": {"name": "bad", "seed": 1, "duration_s": -5,
                   "bogus_top_level": 1,
                   "arrivals": {"process": "weibull", "rate_per_s": 0.1},
                   "tenants": []},
    "bad-template": {"name": "bad-template", "seed": 1, "duration_s": 10,
                     "arrivals": {"process": "poisson", "rate_per_s": 0.5},
                     "tenants": [{"name": "t0", "workload": [
                         {"template": "no-such-template"}]}]},
    "bad-fields": {"version": 2, "name": "", "seed": "x", "duration_s": 5,
                   "time_scale": 0, "arrivals": {
                       "rate_per_s": -1, "max_jobs": 0,
                       "diurnal": {"period_s": 10, "floor": 2},
                       "bursts": [{"at_s": -1}, 3]},
                   "deadlines": {"fraction": 2, "min_s": 9, "max_s": 3},
                   "dedup": {"distinct_inputs": -1},
                   "tenants": [{"name": "a", "weight": 0,
                                "deadline_fraction": 3,
                                "quota": {"bogus": 1},
                                "workload": [{"template": "distill",
                                              "spec": {}}]},
                               {"name": "a", "workload": []}, 7],
                   "faults": [{"kind": "meteor", "at_s": -1}, "x"],
                   "slo": []},
    "bad-spec": {"name": "s", "duration_s": 5,
                 "arrivals": {"rate_per_s": 1},
                 "tenants": [{"name": "t", "workload": [
                     {"spec": {"name": "x", "ops": [
                         {"name": "a", "op_type": "nope"}]}}]}]},
    "bad-params": {"name": "s", "duration_s": 5,
                   "arrivals": {"rate_per_s": 1},
                   "tenants": [{"name": "t", "workload": [
                       {"template": "distill", "params": {"bogus": 1}}]}]},
}


def with_scenarios(name: str) -> SimpleNamespace:
    m = package(name)
    m.scenarios = import_module(f"{name}.scenarios")
    return m


def restart_ids(m, mp) -> None:
    for mod, attr in ((m.dag, "_dag_ids"), (m.backends, "_wid"),
                      (m.scheduler, "_batch_seq")):
        mp.setattr(mod, attr, itertools.count())


@pytest.fixture
def packages(monkeypatch):
    """Both packages, scenarios included; ``fresh(m)`` restarts the id
    counters before a run."""
    pkgs = [with_scenarios(name) for name in PACKAGES]
    return pkgs, lambda m: restart_ids(m, monkeypatch)


def no_wall(report: dict) -> dict:
    return {k: v for k, v in report.items() if k != "wall"}


def schedule(m, path, seed=None):
    arrivals, faults = m.scenarios.load_scenario(path).schedule(seed)
    return ([dataclasses.asdict(a) for a in arrivals],
            [dataclasses.asdict(f) for f in faults])


# ------------------------------------------------------------ schedules --
@pytest.mark.parametrize("path", SCENARIO_FILES, ids=IDS)
def test_schedules_match_the_reference(packages, path):
    pkgs, _ = packages
    sc = pkgs[1].scenarios.load_scenario(path)
    for seed in (None, sc.seed + 1, 1234):
        ref, port = (schedule(m, path, seed) for m in pkgs)
        assert port == ref
    assert port[0], "an empty schedule compares nothing"


@pytest.mark.parametrize("path", SCENARIO_FILES, ids=IDS)
def test_virtual_reports_match_the_reference(packages, path):
    pkgs, fresh = packages
    reports = []
    for m in pkgs:
        fresh(m)
        report = m.scenarios.run_virtual(m.scenarios.load_scenario(path))
        assert tuple(report) == m.scenarios.REPORT_KEYS
        reports.append(no_wall(report))
    ref, port = reports
    assert port == ref
    assert port["jobs"]["submitted"] > 0


def test_edf_boost_sweep_matches_the_reference(packages):
    pkgs, fresh = packages
    rows = []
    for m in pkgs:
        fresh(m)
        sc = m.scenarios.load_scenario(SCENARIO_DIR / "burst_deadline.yaml")
        rows.append(m.scenarios.sweep_edf_boost(sc, [0, 0.05, 0.5, 2]))
    assert rows[1] == rows[0]
    assert [r["deadline_boost"] for r in rows[1]] == [0, 0.05, 0.5, 2]


# ----------------------------------------------------------- validation --
@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_documents_give_the_reference_errors(packages, name):
    errors = []
    for m in packages[0]:
        with pytest.raises(m.scenarios.ScenarioError) as err:
            m.scenarios.compile_scenario(MALFORMED[name])
        errors.append(err.value.errors)
    assert errors[1] == errors[0] and errors[1]


def test_json_scenario_loads_without_yaml(packages, monkeypatch, tmp_path):
    doc = yaml.safe_load((SCENARIO_DIR / "steady_mix.yaml").read_text())
    p = tmp_path / "steady_mix.json"
    p.write_text(json.dumps(doc))
    monkeypatch.setitem(sys.modules, "yaml", None)   # import yaml fails
    ref, port = (m.scenarios for m in packages[0])
    assert [dataclasses.asdict(a) for a in port.load_scenario(p).schedule()[0]] \
        == [dataclasses.asdict(a) for a in ref.load_scenario(p).schedule()[0]]
    messages = []
    for s in (ref, port):
        with pytest.raises(s.ScenarioError) as err:
            s.load_scenario(SCENARIO_DIR / "steady_mix.yaml")
        messages.append(err.value.errors)
    assert messages[1] == messages[0]
    assert "PyYAML is not installed" in messages[1][0]


# --------------------------------------------------------------- faults --
def test_worker_kill_matches_the_reference(packages):
    """``tests/test_scenarios.py``'s worker kill on the virtual fabric."""
    pkgs, fresh = packages
    reports = []
    for m in pkgs:
        fresh(m)
        sc = m.scenarios.load_scenario(SCENARIO_DIR / "worker_preemption.yaml")
        svc = m.service.FabricService(seed=sc.seed)
        lane = sorted(svc.engine.workers)[0]
        fired = []

        def preempt(svc=svc, lane=lane, fired=fired):
            fired.append(lane)
            svc.engine.inject_crash(lane, svc.engine.now)

        report = m.scenarios.run_virtual(
            sc, svc=svc, actions=m.scenarios.FaultActions(
                {"worker-a": preempt}))
        assert fired == [lane]
        assert report["faults"][0]["fired"] is True
        assert report["jobs"]["submitted"] == report["jobs"]["completed"]
        reports.append((no_wall(report), svc.engine.telemetry.summary()))
    assert reports[1] == reports[0]


def test_open_loop_in_process_matches_the_reference(packages):
    """``tests/test_scenarios.py``'s open loop against ``FabricAPI`` with a
    fake clock, on a service pre-warmed with foreign traffic."""
    pkgs, fresh = packages
    reports = []
    for m in pkgs:
        fresh(m)
        path = SCENARIO_DIR / "steady_mix.yaml"
        sc = m.scenarios.load_scenario(path)
        svc = m.service.FabricService(seed=sc.seed)
        api = m.api.FabricAPI(svc)
        warm_doc = dict(sc.schedule(seed=sc.seed + 99)[0][0].doc)
        code, view = api.handle("POST", "/workflows", {"spec": warm_doc})
        assert code == 201, view
        svc.run_until_idle()
        assert svc.usage(warm_doc["tenant"])["ops"]["executed"] > 0
        t = [0.0]

        def fake_sleep(s, svc=svc, t=t):
            svc.run_until_idle()
            t[0] += s

        report = m.scenarios.run_open_loop(
            sc, api, time_scale=0.0, settle_timeout_s=30,
            poll_interval_s=0.25, sleep=fake_sleep, clock=lambda t=t: t[0])
        jobs = report["jobs"]
        assert jobs["submitted"] == jobs["completed"] == 25
        assert report["dedup"]["executed"] + report["dedup"]["deduped"] > 0
        reports.append(no_wall(report))
    assert reports[1] == reports[0]


def test_primary_kill_mid_scenario_on_the_port():
    """``tests/test_scenarios.py``'s primary kill under an auto-promoting
    follower, on the port's classes, with that test's assertions."""
    from repro_torch.core.cas import CAS
    from repro_torch.core.journal import EventJournal
    from repro_torch.fabric import (ClusterAPI, FabricAPI, FabricHTTPServer,
                                    FabricService, FollowerAPI,
                                    FollowerFabric)
    from repro_torch.scenarios import (REPORT_KEYS, FaultActions,
                                       load_scenario, run_open_loop)
    sc = load_scenario(SCENARIO_DIR / "primary_failover.yaml")
    cas = CAS()
    journal = EventJournal(cas, batch_size=3, lease_ttl_s=0.4)
    svc = FabricService(seed=sc.seed, cas=cas, journal=journal)
    pserver = FabricHTTPServer(FabricAPI(svc), pump_interval_s=0.01).start()
    follower = FollowerFabric(cas, batch_size=3, auto_promote=True,
                              lease_ttl_s=0.4)
    fapi = FollowerAPI(follower)
    fserver = FabricHTTPServer(fapi, auto_pump=False, pump_interval_s=0.01)
    fapi.on_promoted = lambda _svc: fserver.enable_pump()
    fserver.start()
    stop = threading.Event()
    tail = threading.Thread(target=follower.tail_loop,
                            args=(stop, fserver.lock),
                            kwargs={"poll_interval_s": 0.01,
                                    "wake_every_s": 0.05}, daemon=True)
    tail.start()

    def kill_primary():
        pserver._stop.set()
        pserver.httpd.shutdown()
        pserver.httpd.server_close()

    try:
        cluster = ClusterAPI(f"{pserver.url},{fserver.url}", timeout_s=10,
                             retry_backoff_s=0.05, write_attempts=60)
        report = run_open_loop(
            sc, cluster, time_scale=0.02, settle_timeout_s=60,
            poll_interval_s=0.05,
            actions=FaultActions({"primary": kill_primary}))
    finally:
        stop.set()
        tail.join(timeout=10)
        fserver.stop()

    assert tuple(report.keys()) == REPORT_KEYS
    assert report["faults"] == [
        {"t": 24.0, "kind": "primary_kill", "target": "primary",
         "fired": True}]
    jobs = report["jobs"]
    assert jobs["submitted"] == len(sc.schedule()[0])
    assert jobs["submitted"] == (jobs["completed"] + jobs["cancelled"]
                                 + jobs["rejected"] + jobs["lost"]
                                 + jobs["unresolved"])
    assert follower.promoted is not None
    assert follower.elections_won == 1
    assert jobs["completed"] >= jobs["submitted"] - 4
    assert jobs["unresolved"] == 0


# ------------------------------------------------------------------ CLI --
def cli(package_name: str, *args) -> tuple[int, str, str]:
    """One CLI run (the port's module or the reference's script)."""
    entry = (["-m", "repro_torch.launch.fabric_cli"]
             if package_name == "repro_torch"
             else [str(ROOT / "scripts" / "fabric_cli.py")])
    out = subprocess.run([sys.executable, *entry, *args], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    return out.returncode, out.stdout, out.stderr


def test_cli_scenario_matches_the_reference(tmp_path):
    steady = str(SCENARIO_DIR / "steady_mix.yaml")
    preempt = str(SCENARIO_DIR / "worker_preemption.yaml")
    for args in (["compile", steady], ["compile", preempt, "--head", "3",
                                       "--scenario-seed", "5"],
                 ["sweep", preempt, "--boosts", "0,0.5"]):
        ref, port = (cli(p, "scenario", *args) for p in PACKAGES)
        assert port == ref and port[0] == 0 and port[1], args
    runs = []
    for p in PACKAGES:
        out = tmp_path / f"{p}.json"
        rc, stdout, _ = cli(p, "scenario", "run", preempt, "--boost", "0.5",
                            "--out", str(out))
        assert rc == 0
        runs.append((no_wall(json.loads(stdout)),
                     no_wall(json.loads(out.read_text()))))
    assert runs[1] == runs[0]
    assert runs[1][0] == runs[1][1]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(MALFORMED["bad-blocks"]))
    ref, port = (cli(p, "scenario", "run", str(bad)) for p in PACKAGES)
    assert port == ref and port[0] == 1
    assert port[2].startswith("INVALID SCENARIO:")


# ------------------------------------------------- real compute, the CPU --
@pytest.fixture(scope="module")
def served(executors):  # noqa: F811
    """``steady_mix`` on (the reference's service on its ``JaxExecutor``,
    ``launch.scenario`` on the port's ``TorchExecutor``), each from
    restarted id counters: [(report, service)] in that order."""
    out = []
    with pytest.MonkeyPatch.context() as mp:
        for name, executor in zip(PACKAGES, executors):
            m = with_scenarios(name)
            restart_ids(m, mp)
            sc = m.scenarios.load_scenario(SCENARIO_DIR / "steady_mix.yaml")
            if name == "repro_torch":
                svc = scenario.service(executor, sc.seed)
                out.append((scenario.run(sc, svc), svc))
                continue
            svc = m.service.FabricService(seed=sc.seed, executor=executor)
            out.append((m.scenarios.run_virtual(sc, svc=svc), svc))
    return out


def test_steady_mix_on_the_torch_executor_matches_the_reference(served):
    (ref, _), (port, svc) = served
    for key in ("jobs", "dedup"):
        assert port[key] == ref[key], key
    assert port["jobs"]["completed"] == 25
    assert port["dedup"]["executed"] + port["dedup"]["deduped"] == 95
    counts = scenario.check(svc, port)
    assert counts["h_tasks"] == port["dedup"]["executed"]


def test_steady_mix_payloads_match_the_reference_executor(served,
                                                           executors):  # noqa: F811,E501
    (_, ref_svc), (_, port_svc) = served
    ref_ex, _ = executors
    r = package("repro")
    lane = r.worker.Worker("w-alone", r.cost_model.DEVICE_CLASSES[
        "rtx4090-24g"], now=0.0)
    ran = {}
    for dag in port_svc.engine.dags.values():
        for row in dag.lineage:
            if row.executed:
                ran[row.h_task] = (row, dag.resolve_inputs(
                    row.op, port_svc.engine.cas))
    kinds = {"served": 0, "trained": 0, "other": 0}
    for h_task, (row, inputs) in sorted(ran.items()):
        got = port_svc.engine.cas.get_bytes(row.output_hash)
        op_type = pickle.loads(got)["op"]
        spec = r.dag.OperatorSpec(row.op, r.dag.OpType(op_type),
                                  "llama-3.2-1b", inputs=["x"])
        group = r.worker.ExecutionGroup(h_task=h_task, h_exec=spec.h_exec(),
                                        spec=spec, input_hashes=inputs)
        batch = r.worker.DispatchBatch(batch_id=0, h_exec=spec.h_exec(),
                                       groups=[group],
                                       worker_id=lane.worker_id,
                                       admitted_at=0.0)
        if op_type in TRAINING:
            # upstream of no train op: the reference ran the same H_task
            want = pickle.loads(ref_svc.engine.cas.get_bytes(
                ref_svc.engine.result_index[h_task]))
            got = pickle.loads(got)
            assert got["inputs"] == want["inputs"]
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=LOSS_RTOL, atol=0)
            kinds["trained"] += 1
            continue
        [want] = ref_ex.execute(batch, lane, port_svc.engine.cas).outputs
        assert got == want, row.op
        kinds["served" if op_type in SERVED else "other"] += 1
    assert kinds["served"] and kinds["trained"] and kinds["other"]
    assert sum(kinds.values()) == len(ran) == 35


# ----------------------------------------------------------- chip_smoke --
def test_chip_smoke_scenarios_are_the_files():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(smoke.SCENARIOS) == {"steady_mix", "worker_preemption"}
    for stem, doc in smoke.SCENARIOS.items():
        assert doc == yaml.safe_load(
            (SCENARIO_DIR / f"{stem}.yaml").read_text()), stem
