"""The port end to end on the CPU: ``launch.rlhf.run_service`` on the port's
``FabricService`` with a ``TorchExecutor`` against the reference's
``FabricService`` with a ``JaxExecutor``, on the same four tenants.

The port's executor runs on the CPU with the reference's draws (the
``executors`` fixture of ``tests/test_torch_executor.py``). A train op's
payload carries its float losses, which agree to rtol 5e-7 but not bit for
bit, so every hash downstream of a train op differs between the packages.
The lineage (``executed`` included) and the result index are therefore
equal up to a renaming of hashes, which must be one to one, and hashes
upstream of every train op are equal outright. Each served payload the
port published is byte-identical to what the reference's executor
publishes for the same input hashes. After the run, a fresh service
restores the port's journal and serves a resubmission with no execution.
"""
import itertools
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_executor import executors  # noqa: F401
from test_torch_fabric_core import PACKAGES, package

from repro_torch.fabric.api import FabricAPI
from repro_torch.launch import rlhf

LOSS_RTOL = 5e-7
SERVED = {"generate", "score", "eval"}
TRAINING = {"sft", "dpo", "ppo"}


def service(m, executor, cas_dir):
    """``rlhf.run_service``'s service, built from package ``m``."""
    cas = m.cas.DiskCAS(cas_dir)
    return m.service.FabricService(
        executor=executor, cas=cas, journal=m.journal.EventJournal(cas),
        config=m.control_plane.EngineConfig(seed=0, speculation=False))


@pytest.fixture(scope="module")
def runs(executors, tmp_path_factory):  # noqa: F811
    """(reference service, port service), each run from restarted id
    counters; the port's through ``rlhf.run_service`` itself."""
    out = []
    with pytest.MonkeyPatch.context() as mp:
        for name, executor in zip(PACKAGES, executors):
            m = package(name)
            for mod, attr in ((m.dag, "_dag_ids"), (m.backends, "_wid"),
                              (m.scheduler, "_batch_seq")):
                mp.setattr(mod, attr, itertools.count())
            cas_dir = tmp_path_factory.mktemp(name)
            if name == "repro_torch":
                out.append(rlhf.run_service(executor, cas_dir))
                continue
            svc = service(m, executor, cas_dir)
            api = m.api.FabricAPI(svc)
            rlhf.submit_tenants(api)
            assert api.handle("POST", "/drain", {})[0] == 200
            out.append(svc)
    return out


def rows(svc) -> list:
    return [(jid, r) for jid in sorted(svc.jobs) for r in svc.lineage(jid)]


def renaming(ref, port) -> dict:
    """The one-to-one map of the reference's hashes onto the port's, read
    off their lineage rows in order."""
    fwd, back = {}, {}
    for (jid, a), (jid2, b) in zip(rows(ref), rows(port), strict=True):
        assert (jid, a["op"], a["executed"]) == (jid2, b["op"],
                                                  b["executed"])
        pairs = [(a["h_task"], b["h_task"]),
                 (a["output_hash"], b["output_hash"]),
                 *zip(a["input_hashes"], b["input_hashes"], strict=True)]
        for x, y in pairs:
            assert fwd.setdefault(x, y) == y, (jid, a["op"])
            assert back.setdefault(y, x) == x, (jid, a["op"])
    return fwd


def test_lineage_and_result_index_match_the_reference(runs):
    ref, port = runs
    rlhf.check(port.engine)
    assert {port.job(j)["status"] for j in port.jobs} == {"completed"}
    fwd = renaming(ref, port)
    assert {fwd[h]: fwd[k] for h, k in ref.engine.result_index.items()} \
        == port.engine.result_index
    # upstream of every train op the two runs agree hash for hash
    upstream = [r for _, r in rows(port) if r["op"] in ("prep", "teach",
                                                         "filter")]
    assert len(upstream) == 5           # prep x 3, teach, filter
    for r in upstream:
        assert fwd[r["h_task"]] == r["h_task"]
        assert fwd[r["output_hash"]] == r["output_hash"]
    s_ref, s_port = (svc.engine.telemetry.summary() for svc in runs)
    for key in ("tasks", "executions", "dedup_savings", "mean_batch"):
        assert s_port[key] == s_ref[key], key


def test_payloads_match_the_reference(runs, executors):  # noqa: F811
    ref, port = runs
    ref_ex, port_ex = executors
    r = package("repro")
    lane = r.worker.Worker("w-alone", r.cost_model.DEVICE_CLASSES[
        "rtx4090-24g"], now=0.0)
    served = trained = 0
    for (_, a), (_, b) in zip(rows(ref), rows(port)):
        if not b["executed"]:
            continue
        got = port.engine.cas.get_bytes(b["output_hash"])
        op_type = pickle.loads(got)["op"]
        if op_type in SERVED:
            # the reference's executor on the port's input hashes
            spec = r.dag.OperatorSpec(b["op"], r.dag.OpType(op_type),
                                      "llama-3.2-1b", inputs=["x"])
            group = r.worker.ExecutionGroup(
                h_task=b["h_task"], h_exec=spec.h_exec(), spec=spec,
                input_hashes=tuple(b["input_hashes"]))
            batch = r.worker.DispatchBatch(
                batch_id=0, h_exec=spec.h_exec(), groups=[group],
                worker_id=lane.worker_id, admitted_at=0.0)
            [want] = ref_ex.execute(batch, lane, ref.engine.cas).outputs
            assert got == want, b["op"]
            served += 1
        elif op_type in TRAINING:
            want = pickle.loads(ref.engine.cas.get_bytes(a["output_hash"]))
            np.testing.assert_allclose(pickle.loads(got)["losses"],
                                       want["losses"], rtol=LOSS_RTOL,
                                       atol=0)
            trained += 1
        else:                   # CPU ops on equal inputs: equal bytes
            assert got == ref.engine.cas.get_bytes(a["output_hash"])
    assert served == 8 and trained == 5


def test_restore_and_resubmit_executes_nothing(runs, executors):  # noqa: F811
    _, port = runs
    _, port_ex = executors
    cas_dir = port.engine.cas.root
    again = rlhf.service(port_ex, cas_dir)
    stats = again.restore_from_journal()
    assert stats["jobs"] == 4 and stats["interrupted"] == 0
    for jid in port.jobs:
        assert again.job(jid) == port.job(jid)
        assert again.lineage(jid) == port.lineage(jid)
        assert again.trace(jid) == port.trace(jid)
    for _, tenant, _ in rlhf.SERVICE_TENANTS:
        for field in ("workflows", "ops", "spend"):
            assert again.usage(tenant)[field] == port.usage(tenant)[field]
    assert again.engine.result_index == port.engine.result_index
    [jid] = rlhf.submit_tenants(FabricAPI(again), rlhf.SERVICE_TENANTS[:1])
    again.run_until_idle()
    assert again.job(jid)["status"] == "completed"
    assert again.engine.telemetry.executions == 0
    assert not any(row["executed"] for row in again.lineage(jid))
    assert [r["output_hash"] for r in again.lineage(jid)] == \
        [r["output_hash"] for r in port.lineage(sorted(port.jobs)[0])]
