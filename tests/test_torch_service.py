"""The port's service layer against the reference's, on the CPU, in one
process: the journal, the trace fold and the metrics registry; restores
across the two packages' stores; the ``FabricAPI`` answers; the HTTP shim.

Both packages run with their id counters restarted (the ``packages``
fixture of ``tests/test_torch_fabric_core.py``), so equal inputs must give
equal event streams, journal chains (the head key included), span trees,
Chrome traces and API bodies. Metrics are wall clock: series names, labels,
counters, gauges and histogram counts are compared, never observed seconds.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from test_torch_fabric_core import (PACKAGES, SCENARIOS, package,  # noqa: F401
                                   packages)

TENANTS = ("acme", "globex", "initech")


# ------------------------------------------------------- journal, trace --
def instrumented(m, created: list):
    """``m``'s engine class with a journal (in-memory CAS, fixed clock,
    segments of 16 events), a trace fold and an event counter subscribed
    to its bus as the service subscribes them."""
    base = m.control_plane.FlowMeshEngine

    class Instrumented(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.registry = m.metrics.MetricsRegistry()
            self.journal = m.journal.EventJournal(
                m.cas.CAS(), batch_size=16, clock=lambda: 0.0)
            self.journal.metrics = self.registry
            self.trace = m.tracing.TraceState()
            events = self.registry.counter(
                "fabric_events_total", "Events published on the engine bus",
                labels=("kind", "tenant"))
            self.bus.subscribe(self.trace.apply)
            self.bus.subscribe(lambda e: events.inc(
                kind=e.kind, tenant=e.__dict__.get("tenant") or "-"))
            self.bus.subscribe(self.journal.on_event)
            created.append(self)

    return Instrumented


def metric_samples(text: str) -> dict:
    """Prometheus exposition -> {series: value}, with the wall-clock values
    (histogram sums and buckets) masked; ``# HELP``/``# TYPE`` kept."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#"):
            out[line] = None
            continue
        series, value = line.rsplit(" ", 1)
        name = series.split("{", 1)[0]
        wall = name.endswith("_sum") or name.endswith("_bucket")
        out[series] = None if wall else float(value)
    return out


def observed(m, name, monkeypatch) -> dict:
    created = []
    monkeypatch.setattr(m.control_plane, "FlowMeshEngine",
                        instrumented(m, created))
    eng = SCENARIOS[name](m)
    eng.run()
    assert created == [eng]
    eng.journal.flush()
    return {
        "events": [e.to_dict() for e in eng.journal.replay()],
        "head": eng.journal.head,
        "chain": eng.journal.chain_stats(),
        "trees": {d: json.dumps(eng.trace.span_tree(d), sort_keys=True)
                  for d in eng.dags},
        "chrome": {d: json.dumps(eng.trace.chrome_trace(d), sort_keys=True)
                   for d in eng.dags},
        "metrics": metric_samples(eng.registry.render()),
    }


@pytest.mark.parametrize("name", SCENARIOS)
def test_journal_trace_and_metrics_match_the_reference(packages, name,
                                                       monkeypatch):
    ref, port = (observed(m, name, monkeypatch) for m in packages)
    assert port["events"] and port["chain"]["segments"] > 1
    assert port["head"] == ref["head"]
    for key in ref:
        assert port[key] == ref[key], key
    assert any('kind="workflow_completed"' in k for k in port["metrics"])


# ------------------------------------------------------------- restore --
def distill(tenant: str, shard: str = "gsm8k/shard-0") -> dict:
    return {"template": "distill", "params": {"tenant": tenant,
                                              "shard": shard}}


def journaled_service(m, cas_dir):
    cas = m.cas.DiskCAS(cas_dir)
    svc = m.service.FabricService(
        seed=7, cas=cas, journal=m.journal.EventJournal(cas, batch_size=8))
    svc.set_quota("acme", m.admission.TenantQuota(max_active_workflows=2))
    return svc


def durable_view(svc) -> dict:
    """What a restore rebuilds: job views, lineage, usage, listings and
    traces of every job, and the result index."""
    return {
        "jobs": {j: svc.job(j) for j in svc.jobs},
        "lineage": {j: svc.lineage(j) for j in svc.jobs},
        "usage": {t: svc.usage(t) for t in TENANTS},
        "list": svc.list_jobs(),
        "trace": {j: json.dumps(svc.trace(j), sort_keys=True)
                  for j in svc.jobs},
        "chrome": {j: json.dumps(svc.trace(j, chrome=True), sort_keys=True)
                   for j in svc.jobs},
        "index": dict(svc.engine.result_index),
    }


def restored(m, cas_dir):
    svc = journaled_service(m, cas_dir)
    stats = svc.restore_from_journal()
    return svc, stats


@pytest.mark.parametrize("compact", [False, True], ids=["chain", "compacted"])
@pytest.mark.parametrize("writer", [0, 1], ids=["ref-writes", "port-writes"])
def test_restore_across_packages(packages, tmp_path, writer, compact):
    """One package journals a run into a ``DiskCAS``; each package restores
    it, and the port's restore equals the reference's."""
    w = packages[writer]
    svc = journaled_service(w, tmp_path)
    api = w.api.FabricAPI(svc)
    for doc in (distill("acme"), distill("globex"),
                distill("acme", "gsm8k/shard-1"),
                distill("acme", "gsm8k/shard-2"),      # 429 on quota
                {"template": "rlhf", "params": {"tenant": "initech"}}):
        api.handle("POST", "/workflows", doc)
    api.handle("POST", "/pump", {"max_steps": 20})
    api.handle("POST", "/workflows", distill("globex", "gsm8k/shard-1"))
    api.handle("POST", "/drain", {})
    if compact:
        assert svc.compact(keep_segments=1)["folded_segments"] > 0
        svc.gc()
    ref, port = (durable_view(restored(m, tmp_path)[0]) for m in packages)
    assert len(port["jobs"]) == 6
    assert {j["status"] for j in port["jobs"].values()} == {"completed",
                                                            "rejected"}
    for key in ref:
        assert port[key] == ref[key], key
    # the writer's live answers that a restore rebuilds
    live = durable_view(svc)
    assert port["lineage"] == live["lineage"]
    assert port["trace"] == live["trace"]
    assert port["index"] == live["index"]
    for t in TENANTS:
        for field in ("workflows", "ops", "spend"):
            assert port["usage"][t][field] == live["usage"][t][field]


# ----------------------------------------------------------------- API --
SPEC = {
    "name": "distill-gsm8k", "tenant": "acme", "deadline_s": 3600,
    "ops": [
        {"name": "teach", "op_type": "generate", "model_id": "llama-3.1-8b",
         "params": {"max_batch": 12}, "inputs": ["gsm8k/shard-0"],
         "tokens_in": 1024, "tokens_out": 1536},
        {"name": "filter", "op_type": "aggregate", "inputs": ["@teach"],
         "resource_class": "cpu"},
        {"name": "sft", "op_type": "sft", "model_id": "llama-3.2-1b",
         "params": {"lora": True, "lr": 2e-5, "max_batch": 12},
         "inputs": ["@filter"], "train_tokens": 4_000_000},
        {"name": "eval", "op_type": "eval", "model_id": "llama-3.2-1b",
         "params": {"max_batch": 12}, "inputs": ["@sft", "gsm8k/holdout"],
         "tokens_in": 2048, "tokens_out": 128},
    ],
}


def api_script(api) -> list:
    """``examples/fabric_service.py``'s flow and the routes of
    ``tests/test_fabric_service.py``: (request, code, body) triples."""
    out = []

    def call(method, path, body=None):
        code, payload = api.handle(method, path, body)
        out.append(((method, path), code, payload))
        return code, payload

    call("GET", "/workflows/templates")
    call("PUT", "/tenants/small-co/quota",
         {"max_active_workflows": 1, "weight": 0.5})
    _, a = call("POST", "/workflows", {"spec": SPEC})
    _, b = call("POST", "/workflows", {"spec": {**SPEC, "tenant": "globex"}})
    call("POST", "/workflows", {"template": "agent-loop",
                                "params": {"tenant": "initech",
                                           "rounds": 2}})
    call("POST", "/pump", {"max_steps": 30})
    call("POST", "/workflows", {"template": "batch-eval",
                                "params": {"tenant": "small-co"}})
    code, _ = call("POST", "/workflows", {"template": "rlhf",
                                          "params": {"tenant": "small-co"}})
    assert code == 429
    _, late = call("POST", "/workflows", {"template": "rlhf",
                                          "params": {"tenant": "initech"}})
    call("POST", "/pump", {"max_steps": 5})
    call("POST", f"/jobs/{late['job_id']}/cancel")
    call("GET", f"/jobs/{a['job_id']}/events?since=-1&limit=5")
    call("POST", "/drain", {})
    for j in (a, b, late):
        for tail in ("", "/lineage", "/events", "/trace",
                     "/trace?format=chrome"):
            call("GET", f"/jobs/{j['job_id']}{tail}")
    for tenant in TENANTS + ("small-co",):
        call("GET", f"/tenants/{tenant}/usage")
    call("GET", "/jobs")
    call("GET", "/jobs?tenant=acme")
    call("GET", "/health")
    call("GET", "/admin/retention")
    call("PUT", "/admin/retention", {"feed_window": 64})
    call("POST", "/admin/compact", {"keep_segments": 1})
    call("POST", "/admin/gc", {})
    call("GET", "/admin/replication")
    call("GET", "/admin/transport")
    call("POST", "/worker/register", {"worker_id": "w",
                                      "device_class": "rtx4090-24g"})
    for bad in (("POST", "/pump", {"max_steps": "10"}),
                ("POST", "/drain", {"until": True}),
                ("POST", "/workflows", {}),
                ("POST", "/workflows", {"template": "nope"}),
                ("GET", "/nope", None), ("DELETE", "/health", None),
                ("GET", "/jobs/unknown", None),
                ("POST", "/jobs/unknown/cancel", None)):
        call(*bad)
    code, metrics = api.handle("GET", "/metrics")
    out.append((("GET", "/metrics"), code, metric_samples(metrics)))
    return out


def masked(triple):
    """JSON-shaped, with the wall-clock fields out: the journal lease's
    remaining time and expiry (``GET /admin/replication``). The metrics'
    seconds are masked by ``metric_samples``."""
    req, code, body = triple
    body = json.loads(json.dumps(body, default=str))
    if req == ("GET", "/admin/replication"):
        body["journal"]["lease"].pop("remaining_s")
        body["journal"]["lease"].pop("expired")
    return req, code, body


def api_service(m, cas_dir):
    cas = m.cas.DiskCAS(cas_dir)
    return m.service.FabricService(seed=0, cas=cas,
                                   journal=m.journal.EventJournal(cas))


def test_api_answers_match_the_reference(packages, tmp_path):
    ref, port = (api_script(m.api.FabricAPI(api_service(m, tmp_path / name)))
                 for m, name in zip(packages, PACKAGES))
    assert len(port) == len(ref) > 40
    for got, want in zip(port, ref):
        assert masked(got) == masked(want), got[0]
    codes = {req: code for req, code, _ in port}
    assert codes[("POST", "/admin/compact")] == 200
    assert codes[("GET", "/nope")] == 404


# ---------------------------------------------------------------- HTTP --
def without_http_series(triple):
    """The shim times each dispatch into the service's registry: its
    ``fabric_http_request_seconds`` series are the only extra ones."""
    req, code, body = masked(triple)
    if req == ("GET", "/metrics"):
        body = {k: v for k, v in body.items()
                if "fabric_http_request_seconds" not in k}
    return req, code, body


def test_http_answers_as_in_process(tmp_path, monkeypatch):
    """The port's ``FabricHTTPServer`` with ``RemoteAPI`` answers the script
    exactly as an in-process ``FabricAPI`` on an equal service does. Each
    request has a 30 s client timeout; the server stops either way."""
    import itertools
    m = package("repro_torch")
    runs = []
    for remote in (False, True):
        for mod, attr in ((m.dag, "_dag_ids"), (m.backends, "_wid"),
                          (m.scheduler, "_batch_seq")):
            monkeypatch.setattr(mod, attr, itertools.count())
        api = m.api.FabricAPI(api_service(m, tmp_path / str(remote)))
        if not remote:
            runs.append(api_script(api))
            continue
        server = m.http.FabricHTTPServer(api, port=0, auto_pump=False)
        server.start()
        try:
            runs.append(api_script(m.http.RemoteAPI(server.url,
                                                    timeout_s=30.0)))
        finally:
            server.stop()
    local, remote = runs
    assert len(remote) == len(local)
    for got, want in zip(remote, local):
        assert without_http_series(got) == without_http_series(want), got[0]


# ----------------------------------------------------------------- CLI --
def cli(package_name: str, *args) -> str:
    """One CLI run (the port's module or the reference's script); stdout."""
    root = pathlib.Path(__file__).resolve().parent.parent
    entry = (["-m", "repro_torch.launch.fabric_cli"]
             if package_name == "repro_torch"
             else [str(root / "scripts" / "fabric_cli.py")])
    out = subprocess.run([sys.executable, *entry, *args], cwd=root,
                         env={**os.environ, "PYTHONPATH": str(root / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_fabric_cli_matches_the_reference(tmp_path):
    """``python -m repro_torch.launch.fabric_cli``: the demo prints what the
    reference CLI prints; a journaled submit restores on the second run,
    and the reference CLI reads the port's store back to the same trace."""
    assert cli("repro_torch", "demo") == cli("repro", "demo")
    assert "scenario" in cli("repro_torch", "--help")
    store = str(tmp_path / "cas")
    first = json.loads(cli("repro_torch", "submit", "--template", "distill",
                           "--param", "tenant=acme", "--journal", store))
    second = cli("repro_torch", "submit", "--template", "distill",
                 "--param", "tenant=globex", "--journal", store)
    assert second.startswith("restored 1 jobs")
    job = first["job"]["job_id"]
    traces = [cli(p, "trace", job, "--journal", store) for p in PACKAGES]
    assert traces[0] == traces[1] and json.loads(traces[1])["spans"]
    assert json.loads(cli("repro_torch", "compact", "--journal", store,
                          "--keep", "0"))["folded_segments"] > 0
    assert json.loads(cli("repro_torch", "gc", "--journal",
                          store))["reclaimed_blobs"] > 0
    assert [cli(p, "trace", job, "--journal", store)
            for p in PACKAGES] == traces
