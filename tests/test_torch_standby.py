"""Warm standby, the cluster client and leased workers, for both packages.

Cases of ``tests/test_follower.py``, ``tests/test_cluster.py`` and
``tests/test_transport.py``, each run once on the reference and once on
the port: a follower tails a journaled primary and equals it at every
segment boundary, then promotes and fences the old primary; the cluster
client redirects a write to the new primary; a worker rides a heartbeat
blip; ``LeaseTransport`` grants, renews, completes, fences an expired
lease (its group requeued) and revokes, under an injected clock. A last
case runs the port's worker entry point as a real process against the
port's HTTP server.
"""
from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import pytest

from test_torch_fabric_core import PACKAGES, package

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEVICES = ("h100-nvl-94g", "rtx4090-24g")


@pytest.fixture(params=PACKAGES)
def m(request):
    return package(request.param)


def spec_doc(tenant: str, tag: str) -> dict:
    return {"tenant": tenant, "ops": [
        {"name": "gen", "op_type": "generate", "model_id": "llama-3.2-1b",
         "inputs": [f"prompt:{tag}"], "tokens_in": 256, "tokens_out": 64},
        {"name": "score", "op_type": "score", "model_id": "reward-1b",
         "inputs": [{"ref": "gen"}], "tokens_in": 256, "tokens_out": 8}]}


def build_service(m, cas, *, transport=None):
    svc = m.service.FabricService(
        seed=7, cas=cas, device_classes=DEVICES,
        journal=m.journal.EventJournal(cas, batch_size=3),
        transport=transport)
    svc.set_quota("acme", m.admission.TenantQuota(max_active_workflows=3,
                                                  weight=2.0))
    return svc


def projection(svc) -> dict:
    """What a follower reproduces of a live primary: feeds and usage less
    the engine-local meters."""
    return {
        "feeds": {j: {k: v for k, v in svc.events(j).items()
                      if k != "status"} for j in sorted(svc.jobs)},
        "usage": {t: {k: v for k, v in svc.usage(t).items()
                      if k not in ("pool", "latency")}
                  for t in sorted({r.tenant for r in svc.jobs.values()})},
    }


# ------------------------------------------------------------ follower --
def test_follower_tails_and_promotes_with_fencing(m, tmp_path):
    primary_cas = m.cas.DiskCAS(str(tmp_path))
    svc = build_service(m, primary_cas)
    follower = m.follower.FollowerFabric(m.cas.DiskCAS(str(tmp_path)),
                                         batch_size=3)
    jobs = []
    for step in (("submit", "acme", "a"), ("pump", 8),
                 ("submit", "globex", "a"), ("drain",), ("compact", 1),
                 ("submit", "initech", "b"), ("drain",)):
        if step[0] == "submit":
            jobs.append(svc.submit(spec_doc(*step[1:]))["job_id"])
        elif step[0] == "pump":
            svc.pump(max_steps=step[1])
        elif step[0] == "compact":
            svc.compact(keep_segments=step[1])
        else:
            svc.run_until_idle()
        svc.journal.flush()
        follower.catch_up()
        assert projection(follower.view) == projection(svc), step
        for jid in jobs:
            want = svc.job(jid)
            if want["status"] == "completed":
                assert follower.view.job(jid) == want, step
            else:
                assert follower.view.job(jid)["status"] == want["status"]
    assert follower.replication_status()["caught_up"]

    head = primary_cas.get_ref(m.journal.HEAD_REF)
    promoted = follower.promote()
    assert promoted.journal.epoch == 1
    assert promoted.lineage(jobs[1]) == svc.lineage(jobs[1])
    with pytest.raises(m.cas.RefFencedError):       # the zombie's flush
        svc.submit(spec_doc("acme", "zombie"))
        svc.run_until_idle()
    assert primary_cas.get_ref(m.journal.HEAD_REF) == head
    job = promoted.submit(spec_doc("acme", "after"))
    promoted.run_until_idle()
    assert promoted.job(job["job_id"])["status"] == "completed"
    assert primary_cas.ref_entry(m.journal.HEAD_REF)[1] == 1


# ------------------------------------------------------- cluster client --
class Flaky:
    """An in-process endpoint that can be switched to a corpse (503)."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.dead = False

    def handle(self, method, path, body=None, headers=None):
        if self.dead:
            return 503, {"error": "unreachable", "detail": ["refused"]}
        return self.inner.handle(method, path, body, headers)


@pytest.mark.parametrize("failure", ["fenced", "unreachable"])
def test_cluster_client_redirects_writes(m, failure):
    cas = m.cas.CAS()
    svc = build_service(m, cas)
    follower = m.follower.FollowerFabric(cas, batch_size=3)
    eps = {"http://p": Flaky(m.api.FabricAPI(svc)),
           "http://f": Flaky(m.follower.FollowerAPI(follower))}
    cluster = m.cluster.ClusterAPI("http://p,http://f",
                                   make_api=eps.__getitem__,
                                   sleep=lambda s: None)
    code, _ = cluster.handle("POST", "/workflows",
                             {"spec": spec_doc("acme", "w1")})
    assert code == 201 and cluster.primary_url == "http://p"
    svc.run_until_idle()
    follower.catch_up()
    code, listed = cluster.handle("GET", "/jobs")       # a replica read
    assert code == 200 and len(listed["jobs"]) == 1
    assert eps["http://f"].inner.handle("POST", "/workflows", {
        "spec": spec_doc("acme", "x")})[0] == 409       # read-only
    follower.promote()
    if failure == "fenced":
        svc.fenced = True            # what the zombie's pump observes
    else:
        eps["http://p"].dead = True
    code, job = cluster.handle("POST", "/workflows",
                               {"spec": spec_doc("acme", "w2")})
    assert code == 201, job
    assert cluster.primary_url == "http://f"
    assert cluster.resolutions >= 2


# -------------------------------------------------------------- worker --
def worker_main(name: str):
    if name == "repro_torch":
        from repro_torch.launch import worker_main as wm
        return wm
    spec = importlib.util.spec_from_file_location(
        "reference_worker_main", ROOT / "scripts" / "worker_main.py")
    wm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wm)
    return wm


class Scripted:
    """Per-path response queues, then 200 ok."""

    def __init__(self) -> None:
        self.scripts: dict[str, list] = {}
        self.calls: list[str] = []

    def handle(self, method, path, body=None, headers=None):
        self.calls.append(path)
        queue = self.scripts.get(path)
        return queue.pop(0) if queue else (200, {"ok": True})


@pytest.mark.parametrize("name", PACKAGES)
def test_worker_rides_a_heartbeat_blip(name):
    api = Scripted()
    api.scripts["/worker/heartbeat"] = [(503, {"error": "unreachable"}),
                                        (500, {"error": "internal_error"}),
                                        (409, {"error": "fenced"})]
    wp = worker_main(name).WorkerProcess("http://unused", "w1",
                                         "h100-nvl-94g", api=api)
    wp.heartbeat_s, wp.lease_ttl_s = 0.01, 5.0
    stop, lost = threading.Event(), threading.Event()
    t = threading.Thread(target=wp._heartbeat_loop, args=("L1", stop, lost),
                         daemon=True)
    t.start()
    lost.wait(0.3)
    stop.set()
    t.join(timeout=10)
    assert not lost.is_set()
    assert api.calls.count("/worker/heartbeat") >= 4


# -------------------------------------------------------------- leases --
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def remote_service(m, *, ttl):
    clock = FakeClock()
    transport = m.transport.LeaseTransport(lease_ttl_s=ttl, clock=clock)
    svc = build_service(m, m.cas.CAS(), transport=transport)
    kinds: list[str] = []
    svc.engine.bus.subscribe(lambda e: kinds.append(e.kind))
    return svc, transport, clock, kinds


def shell(m, wid):
    w = m.worker.Worker(wid, m.cost_model.DEVICE_CLASSES["h100-nvl-94g"],
                        now=0.0)
    w.state = m.worker.WorkerState.ACTIVE
    return w


def execute_lease(m, lease, lane):
    """What the worker entry point does with a granted lease, inline."""
    batch = m.transport.batch_from_wire(lease["batch"])
    result = m.simulator.SimExecutor(seed=0).execute(batch, lane, None)
    spec = batch.groups[0].spec
    if spec.model_id and not result.failed:
        lane.make_resident(spec.h_model, spec.model_id)
    return m.transport.result_to_wire(result)


def drive_to_terminal(m, svc, t, jid, wid) -> str:
    lane = shell(m, wid)
    for _ in range(20):
        svc.pump()
        status = svc.job(jid)["status"]
        if status in m.service.TERMINAL_STATUSES:
            return status
        lease = t.poll(wid)
        if lease is not None:
            t.complete(wid, lease["lease_id"], execute_lease(m, lease, lane))
    raise AssertionError(f"{jid} never went terminal")


def replay_view(m, svc) -> str:
    """The journal-folded surface (jobs, lineage, feeds, traces)."""
    return json.dumps({j: (svc.job(j), svc.lineage(j), svc.events(j),
                           svc.trace(j)) for j in sorted(svc.jobs)},
                      sort_keys=True, default=str)


def restore(m, cas):
    svc = m.service.FabricService(seed=7, cas=cas, device_classes=DEVICES,
                                  journal=m.journal.EventJournal(
                                      cas, batch_size=3))
    svc.set_quota("acme", m.admission.TenantQuota(max_active_workflows=3,
                                                  weight=2.0))
    svc.restore_from_journal()
    return svc


def test_lease_register_poll_heartbeat_complete(m):
    svc, t, clock, kinds = remote_service(m, ttl=10.0)
    assert svc.engine.workers == {}          # lanes join by registering
    assert t.register("w1", "h100-nvl-94g")["worker_id"] == "w1"
    jid = svc.submit(spec_doc("acme", "life"))["job_id"]
    svc.pump()
    assert "w1" in t.offers
    lease = t.poll("w1")
    assert lease["epoch"] == 1 and "lease_granted" in kinds
    clock.t = 8.0
    t.tick()
    assert t.heartbeat("w1", lease["lease_id"]) == {"ok": True,
                                                    "revoked": False}
    clock.t = 16.0                          # past the first deadline
    t.tick()
    assert "w1" in t.leases and "lease_expired" not in kinds
    out = t.complete("w1", lease["lease_id"],
                     execute_lease(m, lease, shell(m, "w1")))
    assert out == {"ok": True, "revoked": False}
    assert drive_to_terminal(m, svc, t, jid, "w1") == "completed"
    assert "group_requeued" not in kinds
    svc.journal.flush()
    assert replay_view(m, svc) == replay_view(m, restore(m,
                                                         svc.engine.cas))


def test_lease_fenced_after_expiry_requeues(m):
    svc, t, clock, kinds = remote_service(m, ttl=5.0)
    t.register("w1", "h100-nvl-94g")
    jid = svc.submit(spec_doc("acme", "expire"))["job_id"]
    svc.pump()
    lease = t.poll("w1")
    with pytest.raises(m.transport.FencedLease):
        t.heartbeat("w1", lease["lease_id"] + "/stale")
    clock.t = 5.1                           # the worker went silent
    svc.pump()
    for kind in ("lease_expired", "worker_fail", "group_requeued"):
        assert kind in kinds
    with pytest.raises(m.transport.FencedLease):
        t.heartbeat("w1", lease["lease_id"])
    with pytest.raises(m.transport.FencedLease):
        t.complete("w1", lease["lease_id"], {"outputs": []})
    with pytest.raises(m.transport.UnknownWorker):
        t.poll("w1")
    wid = t.register("w1", "h100-nvl-94g")["worker_id"]
    assert wid == "w1~1"                    # the dead lane keeps its name
    assert drive_to_terminal(m, svc, t, jid, wid) == "completed"


def test_lease_revoke(m):
    svc, t, clock, kinds = remote_service(m, ttl=10.0)
    t.register("w1", "h100-nvl-94g")
    jid = svc.submit(spec_doc("acme", "revoke"))["job_id"]
    svc.pump()
    lease = t.poll("w1")
    svc.cancel(jid)
    assert "lease_revoked" in kinds
    assert svc.job(jid)["status"] == "cancelled"
    assert t.heartbeat("w1", lease["lease_id"]) == {"ok": False,
                                                    "revoked": True}
    assert "w1" not in t.leases and "w1" in t.lanes
    jid2 = svc.submit(spec_doc("acme", "after-revoke"))["job_id"]
    assert drive_to_terminal(m, svc, t, jid2, "w1") == "completed"


def test_port_worker_process_serves_the_port_service():
    """``python -m repro_torch.launch.worker_main`` leases and completes a
    job's batches from the port's ``serve --remote-workers`` stack over
    loopback HTTP. Every wait is bounded; the process and the server are
    stopped either way."""
    m = package("repro_torch")
    transport = m.transport.LeaseTransport(lease_ttl_s=5.0)
    svc = build_service(m, m.cas.CAS(), transport=transport)
    server = m.http.FabricHTTPServer(m.api.FabricAPI(svc), port=0).start()
    proc = None
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.worker_main",
             "--url", server.url, "--worker-id", "w1", "--poll-s", "0.5",
             "--device-class", "h100-nvl-94g"],
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            cwd=str(ROOT), stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        client = m.http.RemoteAPI(server.url, timeout_s=10.0)
        code, job = client.handle("POST", "/workflows",
                                  {"spec": spec_doc("acme", "remote")})
        assert code == 201
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            status = client.handle("GET", f"/jobs/{job['job_id']}")[1]
            if status["status"] in m.service.TERMINAL_STATUSES:
                break
            time.sleep(0.05)
        assert status["status"] == "completed"
        lineage = client.handle("GET",
                                f"/jobs/{job['job_id']}/lineage")[1]
        assert {r["worker"] for r in lineage["lineage"]} == {"w1"}
    finally:
        if proc is not None:
            proc.kill()
            proc.wait(timeout=10)
        server.stop()
