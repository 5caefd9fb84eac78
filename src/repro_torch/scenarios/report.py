"""Scenario run reports: one canonical shape for both drivers.

The virtual driver (in-process, deterministic) and the open-loop driver
(wall clock, against a live fabric over HTTP) both emit this report, so a
scenario's trajectory entries are comparable across modes and across
machines. Key set is fixed (``REPORT_KEYS``) — the golden tests assert it,
which keeps downstream consumers (ci.sh asserts, trajectory tooling) from
rotting when the report grows.
"""
from __future__ import annotations

import json
import os
import platform

from repro_torch.core.telemetry import Telemetry

#: canonical top-level report keys, in emission order
REPORT_KEYS = ("bench", "scenario", "mode", "seed", "machine", "duration_s",
               "jobs", "latency", "slo", "dedup", "cost", "wall", "faults")

#: non-gating regression threshold on SLO hit rate between consecutive
#: same-(machine, scenario, mode) trajectory entries
SLO_REGRESSION = 0.10


def machine_tag() -> str:
    """Coarse host identity, same convention as benchmarks/ — regressions
    only compare like with like."""
    return f"{platform.machine()}-{os.cpu_count() or 0}cpu"


def percentile(xs: list[float], q: float) -> float:
    return round(Telemetry.percentile(xs, q), 4)


def build_report(scenario, *, mode: str, seed: int, records: list[dict],
                 usage_delta: dict, cost_delta: dict, wall: dict,
                 fault_log: list[dict]) -> dict:
    """Fold per-job outcome records + usage/cost deltas into the report.

    ``records``: one dict per scheduled arrival:
      {"job_id", "tenant", "deadline_s", "status", "latency_s"} where
      status ∈ completed|cancelled|rejected|lost|unresolved ("lost" = the
      fabric no longer knows the id, e.g. unflushed submissions dropped by
      a primary kill; "unresolved" = still non-terminal at settle timeout).
    ``usage_delta``: summed per-tenant deltas {"executed", "deduped",
      "spend_usd"} over the run (so shared/long-lived fabrics report only
      this run's traffic).
    ``cost_delta``: {"meter_usd", "energy_j"} — worker-meter integrals
      (provisioned capacity, not just charged work) over the run.
    """
    by_status: dict[str, int] = {"completed": 0, "cancelled": 0,
                                 "rejected": 0, "lost": 0, "unresolved": 0}
    for r in records:
        by_status[r["status"]] = by_status.get(r["status"], 0) + 1
    completed = [r for r in records if r["status"] == "completed"
                 and r.get("latency_s") is not None]
    lat = sorted(r["latency_s"] for r in completed)

    # SLO: of the deadline-carrying jobs, how many completed within their
    # deadline (virtual-time latency vs virtual-time deadline — identical
    # semantics in both modes). A deadline job that was lost/cancelled/
    # unresolved is a miss: the tenant did not get their answer in time.
    deadline_jobs = [r for r in records if r.get("deadline_s") is not None]
    hits = sum(1 for r in deadline_jobs
               if r["status"] == "completed"
               and r.get("latency_s") is not None
               and r["latency_s"] <= r["deadline_s"])
    executed = int(usage_delta.get("executed", 0))
    deduped = int(usage_delta.get("deduped", 0))
    spend = float(usage_delta.get("spend_usd", 0.0))
    n_done = len(completed)

    return {
        "bench": "scenario",
        "scenario": scenario.name,
        "mode": mode,
        "seed": seed,
        "machine": machine_tag(),
        "duration_s": scenario.duration_s,
        "jobs": {"submitted": len(records), **by_status},
        "latency": {
            "p50_s": percentile(lat, 0.50),
            "p95_s": percentile(lat, 0.95),
            "p99_s": percentile(lat, 0.99),
            "mean_s": round(sum(lat) / n_done, 4) if n_done else 0.0,
        },
        "slo": {
            "deadline_jobs": len(deadline_jobs),
            "hits": hits,
            "misses": len(deadline_jobs) - hits,
            "hit_rate": (round(hits / len(deadline_jobs), 4)
                         if deadline_jobs else 1.0),
        },
        "dedup": {
            "executed": executed,
            "deduped": deduped,
            "ratio": (round(deduped / (executed + deduped), 4)
                      if executed + deduped else 0.0),
        },
        "cost": {
            "spend_usd": round(spend, 6),
            "per_job_usd": round(spend / n_done, 6) if n_done else 0.0,
            "meter_usd": round(float(cost_delta.get("meter_usd", 0.0)), 6),
            "energy_j": round(float(cost_delta.get("energy_j", 0.0)), 3),
        },
        "wall": dict(wall),
        "faults": fault_log,
    }


def append_trajectory(path: str, report: dict) -> str | None:
    """Append a scenario report to the shared BENCH trajectory (JSON list,
    newest last — the same file the throughput tiers append to). Returns a
    non-gating warning when the SLO hit rate dropped more than
    ``SLO_REGRESSION`` against the previous entry for the same
    (machine, scenario, mode), else None."""
    trajectory: list[dict] = []
    if os.path.exists(path):
        with open(path) as f:
            loaded = json.load(f)
        trajectory = loaded if isinstance(loaded, list) else [loaded]
    prev = next((e for e in reversed(trajectory)
                 if e.get("bench") == "scenario"
                 and e.get("machine") == report["machine"]
                 and e.get("scenario") == report["scenario"]
                 and e.get("mode") == report["mode"]), None)
    trajectory.append(report)
    with open(path, "w") as f:
        json.dump(trajectory, f, indent=2)
        f.write("\n")
    if prev:
        drop = prev["slo"]["hit_rate"] - report["slo"]["hit_rate"]
        if drop > SLO_REGRESSION:
            return (f"WARNING: SLO hit rate dropped {drop:.2f} vs previous "
                    f"{report['machine']}/{report['scenario']} entry "
                    f"({prev['slo']['hit_rate']} -> "
                    f"{report['slo']['hit_rate']}) — non-gating, "
                    "investigate before merging")
    return None
