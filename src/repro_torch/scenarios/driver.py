"""Scenario drivers: replay a compiled schedule against a fabric.

Two drivers, one report shape (``report.build_report``):

* ``run_virtual`` — in-process ``FabricService``, schedule seconds mapped
  1:1 onto engine *virtual* time. Fully deterministic for a given
  (scenario, seed): the golden tests and the EDF-boost calibration sweep
  run here, where two configurations can be compared over byte-identical
  traffic with zero wall-clock noise.

* ``run_open_loop`` — wall clock against any ``.handle()`` surface
  (``FabricAPI`` in-process, ``RemoteAPI`` over HTTP, ``ClusterAPI`` riding
  failovers). Open loop: submissions fire at their scheduled wall time
  (``time_scale`` wall-seconds per schedule-second) regardless of how the
  fabric is coping — queueing shows up as latency, exactly like production
  traffic. Fault injectors (worker preemption, primary kill) fire from the
  same timeline through pluggable ``FaultActions``.

Latency and SLO semantics are identical in both modes: a job's
``latency_s`` and ``deadline_s`` are *virtual-time* quantities reported by
the fabric itself, so the hit rate measures scheduling quality, not the
driver's pacing.
"""
from __future__ import annotations

import os
import signal
import time

from repro_torch.fabric.admission import AdmissionController, TenantQuota
from repro_torch.fabric.service import TERMINAL_STATUSES, FabricService

from .report import build_report
from .schema import Fault, Scenario

DEFAULT_POLL_S = 0.25


class FaultActions:
    """Maps a scenario's logical fault targets onto real actions.

    The scenario file names *targets* ("worker-a", "primary"); the
    deployment decides what killing them means — the CLI maps names to
    PIDs (SIGKILL), tests install in-process callables (e.g. an abrupt
    HTTP-server stop). An unregistered target is reported, not fatal:
    the run continues and the report shows ``fired: false``.
    """

    def __init__(self, actions: dict | None = None) -> None:
        self.actions = dict(actions or {})

    def register(self, target: str, fn) -> None:
        self.actions[target] = fn

    @classmethod
    def from_pids(cls, pairs: list[str]) -> "FaultActions":
        """Build from CLI ``name=PID`` pairs: firing sends SIGKILL."""
        actions = {}
        for pair in pairs:
            name, _, pid = pair.partition("=")
            if not name or not pid.isdigit():
                raise ValueError(f"expected name=PID, got {pair!r}")
            actions[name] = (lambda p: lambda: os.kill(p, signal.SIGKILL))(
                int(pid))
        return cls(actions)

    def fire(self, fault: Fault) -> bool:
        fn = self.actions.get(fault.target)
        if fn is None:
            return False
        try:
            fn()
        except OSError:
            return False         # target already gone
        return True


def _fault_entry(fault: Fault, fired: bool) -> dict:
    return {"t": fault.t, "kind": fault.kind, "target": fault.target,
            "fired": fired}


def _merge_timeline(arrivals, faults) -> list:
    # faults sort ahead of a same-instant arrival: killing a worker "at" t
    # should precede traffic scheduled at t
    return sorted([(f.t, 0, f) for f in faults]
                  + [(a.t, 1, a) for a in arrivals], key=lambda x: x[:2])


# ---------------------------------------------------------------------------
# usage / cost deltas
# ---------------------------------------------------------------------------
def _usage_totals(get_usage, tenants: list[str]) -> dict:
    """Sum the per-tenant usage counters the report needs. ``get_usage`` is
    ``tenant -> usage_snapshot dict`` (virtual: service call; live: HTTP)."""
    out = {"executed": 0, "deduped": 0, "spend_usd": 0.0}
    for t in tenants:
        u = get_usage(t)
        out["executed"] += u["ops"]["executed"]
        out["deduped"] += u["ops"]["deduped"]
        out["spend_usd"] += u["spend"]["usd"]
    return out


def _usage_delta(before: dict, after: dict) -> dict:
    # cumulative counters: a shared or long-lived fabric reports only the
    # traffic THIS run added
    return {k: after[k] - before[k] for k in before}


# ---------------------------------------------------------------------------
# virtual driver
# ---------------------------------------------------------------------------
def run_virtual(scenario: Scenario, *, seed: int | None = None,
                deadline_boost: float | None = None,
                actions: FaultActions | None = None,
                device_classes: tuple[str, ...] | None = None,
                svc: FabricService | None = None) -> dict:
    """Deterministic in-process run: schedule seconds == virtual seconds."""
    seed = scenario.seed if seed is None else seed
    actions = actions or FaultActions()
    if svc is None:
        admission = (AdmissionController(deadline_boost=deadline_boost)
                     if deadline_boost is not None else AdmissionController())
        kwargs = {"seed": seed, "admission": admission}
        if device_classes is not None:
            kwargs["device_classes"] = tuple(device_classes)
        svc = FabricService(**kwargs)
    for t in scenario.tenants:
        if t.get("quota"):
            svc.admission.set_quota(t["name"], TenantQuota(**t["quota"]))

    tenants = [t["name"] for t in scenario.tenants]
    usage0 = _usage_totals(svc.usage, tenants)
    cost0, energy0 = svc.engine.cost_energy()
    arrivals, faults = scenario.schedule(seed)
    timeline = _merge_timeline(arrivals, faults)

    wall0 = time.perf_counter()
    fault_log: list[dict] = []
    submitted: list[tuple] = []      # (arrival, job_id | None)
    base = svc.engine.now            # a reused service may not start at 0
    for at, _, item in timeline:
        target_t = base + at
        svc.pump(until=target_t)
        if svc.engine.now < target_t:
            # idle gap: jump the virtual clock to the scheduled instant so
            # arrival spacing (and deadline clocks) match the schedule —
            # pump(until=) drained every event at or before target_t, so
            # the heap invariant (next event > now) holds after the jump
            svc.engine.now = target_t
            svc.engine._last_progress = target_t
        if isinstance(item, Fault):
            fault_log.append(_fault_entry(item, actions.fire(item)))
        else:
            view = svc.submit(item.doc)
            submitted.append((item, view["job_id"]))
    svc.run_until_idle()
    wall_run = time.perf_counter() - wall0

    records = []
    for arrival, job_id in submitted:
        view = svc.job(job_id, deadline_view=False) or {}
        status = view.get("status", "lost")
        if status not in TERMINAL_STATUSES and status != "lost":
            status = "unresolved"
        records.append({
            "job_id": job_id, "tenant": arrival.tenant,
            "deadline_s": arrival.deadline_s, "status": status,
            "latency_s": view.get("latency_s"),
        })

    usage1 = _usage_totals(svc.usage, tenants)
    cost1, energy1 = svc.engine.cost_energy()
    done = sum(1 for r in records if r["status"] == "completed")
    return build_report(
        scenario, mode="virtual", seed=seed, records=records,
        usage_delta=_usage_delta(usage0, usage1),
        cost_delta={"meter_usd": cost1 - cost0,
                    "energy_j": energy1 - energy0},
        wall={"run_s": round(wall_run, 3), "settle_s": 0.0,
              "time_scale": 0.0,
              "jobs_per_s": (round(done / wall_run, 2) if wall_run > 0
                             else 0.0)},
        fault_log=fault_log)


# ---------------------------------------------------------------------------
# open-loop driver
# ---------------------------------------------------------------------------
def _get(api, path: str):
    code, payload = api.handle("GET", path, None)
    return payload if code == 200 else None


def run_open_loop(scenario: Scenario, api, *, seed: int | None = None,
                  time_scale: float | None = None,
                  actions: FaultActions | None = None,
                  settle_timeout_s: float | None = None,
                  poll_interval_s: float = DEFAULT_POLL_S,
                  sleep=time.sleep, clock=time.monotonic) -> dict:
    """Open-loop wall-clock run against any ``.handle()`` surface."""
    seed = scenario.seed if seed is None else seed
    scale = scenario.time_scale if time_scale is None else time_scale
    settle = scenario.settle_s if settle_timeout_s is None else \
        settle_timeout_s
    actions = actions or FaultActions()
    tenants = [t["name"] for t in scenario.tenants]
    arrivals, faults = scenario.schedule(seed)
    timeline = _merge_timeline(arrivals, faults)

    def usage(t: str) -> dict:
        u = _get(api, f"/tenants/{t}/usage")
        return u or {"ops": {"executed": 0, "deduped": 0},
                     "spend": {"usd": 0.0}}

    def cost_energy() -> tuple[float, float]:
        h = _get(api, "/health") or {}
        c = h.get("cost", {})
        return c.get("total_usd", 0.0), c.get("total_energy_j", 0.0)

    usage0 = _usage_totals(usage, tenants)
    cost0, energy0 = cost_energy()

    t0 = clock()
    fault_log: list[dict] = []
    submitted: list[tuple] = []      # (arrival, job_id | None)
    for at, _, item in timeline:
        wait = t0 + at * scale - clock()
        if wait > 0:
            sleep(wait)
        if isinstance(item, Fault):
            fault_log.append(_fault_entry(item, actions.fire(item)))
            continue
        code, payload = api.handle("POST", "/workflows", {"spec": item.doc})
        job_id = (payload or {}).get("job_id") if code in (201, 429) else None
        submitted.append((item, job_id))
    run_s = clock() - t0

    # settle: poll until every submitted id is terminal, the fabric drains
    # idle (any id still missing then is lost — e.g. an unflushed submission
    # dropped by a primary kill), or the settle budget runs out
    latest: dict[str, dict] = {}
    settle0 = clock()
    while clock() - settle0 < settle:
        listing = _get(api, "/jobs") or []
        if isinstance(listing, dict):        # API wraps as {"jobs": [...]}
            listing = listing.get("jobs", [])
        latest = {j["job_id"]: j for j in listing if "job_id" in j}
        pending = [jid for _, jid in submitted
                   if jid is not None
                   and latest.get(jid, {}).get("status")
                   not in TERMINAL_STATUSES]
        if not pending:
            break
        present = [jid for jid in pending if jid in latest]
        if not present:
            health = _get(api, "/health") or {}
            if health.get("idle"):
                break                # drained and still missing: lost
        sleep(poll_interval_s)
    settle_s = clock() - settle0

    records = []
    for arrival, job_id in submitted:
        view = latest.get(job_id) if job_id is not None else None
        if job_id is None:
            # the submit call itself failed (e.g. no primary reachable
            # within the client's retry budget)
            status, latency = "lost", None
        elif view is None:
            status, latency = "lost", None
        else:
            status = view.get("status", "lost")
            latency = view.get("latency_s")
            if status not in TERMINAL_STATUSES:
                status = "unresolved"
        records.append({
            "job_id": job_id, "tenant": arrival.tenant,
            "deadline_s": arrival.deadline_s, "status": status,
            "latency_s": latency,
        })

    usage1 = _usage_totals(usage, tenants)
    cost1, energy1 = cost_energy()
    done = sum(1 for r in records if r["status"] == "completed")
    total_wall = run_s + settle_s
    return build_report(
        scenario, mode="live", seed=seed, records=records,
        usage_delta=_usage_delta(usage0, usage1),
        cost_delta={"meter_usd": cost1 - cost0,
                    "energy_j": energy1 - energy0},
        wall={"run_s": round(run_s, 3), "settle_s": round(settle_s, 3),
              "time_scale": scale,
              "jobs_per_s": (round(done / total_wall, 2) if total_wall > 0
                             else 0.0)},
        fault_log=fault_log)


# ---------------------------------------------------------------------------
# EDF-boost calibration sweep
# ---------------------------------------------------------------------------
def sweep_edf_boost(scenario: Scenario, boosts: list[float], *,
                    seed: int | None = None) -> list[dict]:
    """Replay the identical schedule under each ``deadline_boost`` value
    (fresh fabric per arm — no state bleeds between arms) and tabulate the
    SLO/latency/cost trade-off. The calibration methodology behind the
    committed ``AdmissionController`` default (DESIGN.md §15)."""
    rows = []
    for boost in boosts:
        r = run_virtual(scenario, seed=seed, deadline_boost=boost)
        rows.append({
            "deadline_boost": boost,
            "slo_hit_rate": r["slo"]["hit_rate"],
            "deadline_jobs": r["slo"]["deadline_jobs"],
            "p50_s": r["latency"]["p50_s"],
            "p95_s": r["latency"]["p95_s"],
            "p99_s": r["latency"]["p99_s"],
            "per_job_usd": r["cost"]["per_job_usd"],
            "dedup_ratio": r["dedup"]["ratio"],
        })
    return rows
