"""Scenario documents: declarative traffic shapes for the digital twin.

A scenario is a plain YAML/JSON document describing *traffic*, not code:
which tenants exist, what workflows they submit (spec templates or inline
spec documents), how arrivals are spaced in time (Poisson / uniform, with
diurnal modulation and burst windows), how deadlines are distributed, how
dedup-friendly the input shards are, and which faults to inject mid-run
(worker preemption, primary kill).

``compile_scenario`` validates the document into a ``Scenario``;
``Scenario.schedule()`` expands it into a *deterministic* arrival + fault
schedule: every random draw comes from one seeded ``random.Random`` consumed
in a fixed order, so the same (document, seed) pair always yields the same
jobs with the same input shards and the same deadlines — which is what makes
every checked-in scenario file a regression test (golden schedules) and what
makes A/B sweeps (e.g. the EDF deadline-boost calibration) fair: both arms
replay the identical traffic.

The schedule is *abstract time*: arrival ``t`` is seconds from scenario
start. The virtual driver maps it 1:1 onto engine virtual time; the
open-loop driver maps it onto wall clock via ``time_scale``.
"""
from __future__ import annotations

import json
import math
import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from repro_torch.fabric.spec import TEMPLATES, render_template, validate_spec

SCENARIO_VERSION = 1

FAULT_KINDS = ("worker_kill", "primary_kill")

ARRIVAL_PROCESSES = ("poisson", "uniform")


class ScenarioError(ValueError):
    """Raised when a scenario document fails validation/compilation."""

    def __init__(self, errors: list[str]) -> None:
        self.errors = errors
        super().__init__("invalid scenario: " + "; ".join(errors))


@dataclass(frozen=True)
class Arrival:
    """One scheduled workflow submission, fully rendered.

    ``doc`` is a concrete spec document (template already expanded, shard
    variant and deadline baked in) — the driver only has to POST it.
    """
    t: float                 # seconds from scenario start
    tenant: str
    kind: str                # workload label (template name or spec name)
    variant: int             # dedup shard variant chosen for this arrival
    deadline_s: float | None
    doc: dict


@dataclass(frozen=True)
class Fault:
    t: float                 # seconds from scenario start
    kind: str                # one of FAULT_KINDS
    target: str              # logical name, resolved by the driver's actions


@dataclass
class Scenario:
    """A compiled scenario document, ready to expand into a schedule."""
    name: str
    seed: int
    duration_s: float
    tenants: list[dict]            # [{name, weight, quota?, workload:[...]}]
    arrivals: dict                 # validated arrival-process block
    deadlines: dict                # validated deadline block
    dedup: dict                    # {"distinct_inputs": int|None, "dataset"}
    faults: list[Fault]
    slo: dict = field(default_factory=dict)
    time_scale: float = 1.0        # default wall seconds per schedule second
    settle_s: float = 60.0         # open-loop post-submission settle budget
    doc: dict = field(default_factory=dict)

    # ------------------------------------------------------------ schedule --
    def schedule(self, seed: int | None = None
                 ) -> tuple[list[Arrival], list[Fault]]:
        """Expand into (arrivals, faults). Deterministic for a given seed."""
        rng = random.Random(self.seed if seed is None else seed)
        times = self._arrival_times(rng)
        arrivals = [self._render_arrival(t, i, rng)
                    for i, t in enumerate(times)]
        return arrivals, list(self.faults)

    def _rate(self, t: float) -> float:
        """Instantaneous arrival rate λ(t) = base · diurnal(t) · burst(t)."""
        base = float(self.arrivals["rate_per_s"])
        diurnal = self.arrivals.get("diurnal")
        if diurnal:
            period = float(diurnal["period_s"])
            floor = float(diurnal.get("floor", 0.2))
            # starts at the floor, peaks mid-period, returns to the floor
            base *= floor + (1.0 - floor) * 0.5 * (
                1.0 - math.cos(2.0 * math.pi * t / period))
        for b in self.arrivals.get("bursts", ()):
            if b["at_s"] <= t < b["at_s"] + b["duration_s"]:
                base *= float(b["multiplier"])
        return base

    def _rate_max(self) -> float:
        base = float(self.arrivals["rate_per_s"])
        mult = max((float(b["multiplier"])
                    for b in self.arrivals.get("bursts", ())), default=1.0)
        return base * max(mult, 1.0)

    def _arrival_times(self, rng: random.Random) -> list[float]:
        proc = self.arrivals.get("process", "poisson")
        cap = self.arrivals.get("max_jobs")
        times: list[float] = []
        if proc == "uniform":
            step = 1.0 / float(self.arrivals["rate_per_s"])
            t = step
            while t <= self.duration_s:
                times.append(t)
                t += step
        else:  # poisson via thinning: exact for time-varying λ(t) ≤ λmax
            lam_max = self._rate_max()
            t = 0.0
            while True:
                t += rng.expovariate(lam_max)
                if t > self.duration_s:
                    break
                if rng.random() <= self._rate(t) / lam_max:
                    times.append(t)
        if cap is not None:
            times = times[:int(cap)]
        return times

    def _render_arrival(self, t: float, index: int,
                        rng: random.Random) -> Arrival:
        tenant = _weighted_pick(rng, self.tenants)
        item = _weighted_pick(rng, tenant["workload"])
        # dedup shaping: N distinct shard variants means 1/N collision odds
        # per pair of same-template arrivals; 0/None means every arrival is
        # unique (dedup-hostile)
        distinct = self.dedup.get("distinct_inputs")
        variant = rng.randrange(int(distinct)) if distinct else index
        dataset = self.dedup.get("dataset", "gsm8k")
        shard = f"{dataset}/shard-{variant}"
        deadline = self._draw_deadline(rng, tenant)
        if "template" in item:
            kind = item["template"]
            params = dict(item.get("params", {}))
            params["tenant"] = tenant["name"]
            if kind == "batch-eval":
                params.setdefault("shards", [shard])
            else:
                params.setdefault("shard", shard)
            doc = render_template(kind, **params)
        else:
            doc = _substitute(item["spec"], {"$shard": shard,
                                             "$tenant": tenant["name"]})
            doc["tenant"] = tenant["name"]
            kind = doc.get("name", "spec")
        if deadline is not None:
            doc["deadline_s"] = deadline
        return Arrival(t=round(t, 6), tenant=tenant["name"], kind=kind,
                       variant=variant, deadline_s=deadline, doc=doc)

    def _draw_deadline(self, rng: random.Random,
                       tenant: dict) -> float | None:
        d = self.deadlines
        # the draw happens unconditionally so the rng stream shape does not
        # depend on the fraction (schedules stay comparable across sweeps)
        u, v = rng.random(), rng.random()
        # per-tenant override models an SLO-bound interactive tenant next
        # to a best-effort batch tenant in one scenario
        frac = float(tenant.get("deadline_fraction",
                                d.get("fraction", 0.0)))
        if frac <= 0.0 or u >= frac:
            return None
        lo = float(d.get("min_s", 60.0))
        hi = float(d.get("max_s", lo))
        return round(lo + (hi - lo) * v, 3)


def _weighted_pick(rng: random.Random, items: list[dict]) -> dict:
    total = sum(float(i.get("weight", 1.0)) for i in items)
    x = rng.random() * total
    for i in items:
        x -= float(i.get("weight", 1.0))
        if x <= 0.0:
            return i
    return items[-1]


def _substitute(obj: Any, subs: dict[str, str]) -> Any:
    """Deep-copy ``obj``, replacing ``$shard``/``$tenant`` in every string."""
    if isinstance(obj, str):
        for k, v in subs.items():
            obj = obj.replace(k, v)
        return obj
    if isinstance(obj, dict):
        return {k: _substitute(v, subs) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_substitute(v, subs) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# loading + validation
# ---------------------------------------------------------------------------
def load_scenario_doc(path: str | Path) -> dict:
    """Load a raw scenario document from a YAML or JSON file.

    YAML needs PyYAML; when it is absent, ``.json`` files still work and
    YAML files fail with an actionable error instead of an ImportError
    traceback (the package declares no hard dependency on yaml).
    """
    path = Path(path)
    text = path.read_text()
    if path.suffix in (".yaml", ".yml"):
        try:
            import yaml
        except ImportError:
            raise ScenarioError(
                [f"{path.name} is YAML but PyYAML is not installed; "
                 "install pyyaml or provide the scenario as JSON"]) from None
        doc = yaml.safe_load(text)
    else:
        doc = json.loads(text)
    if not isinstance(doc, dict):
        raise ScenarioError([f"{path.name}: scenario must be a mapping"])
    return doc


def validate_scenario(doc: Any) -> list[str]:
    """Return a list of human-readable problems (empty == valid)."""
    errors: list[str] = []
    if not isinstance(doc, dict):
        return [f"scenario must be an object, got {type(doc).__name__}"]
    known = {"version", "name", "doc", "seed", "duration_s", "time_scale",
             "settle_s", "arrivals", "deadlines", "dedup", "tenants",
             "faults", "slo"}
    for key in sorted(set(doc) - known):
        # a typo'd block would otherwise silently fall back to defaults
        errors.append(f"unknown top-level key {key!r}")
    if doc.get("version", SCENARIO_VERSION) != SCENARIO_VERSION:
        errors.append(f"unsupported scenario version {doc.get('version')!r}")
    if not isinstance(doc.get("name"), str) or not doc.get("name"):
        errors.append("name must be a non-empty string")
    dur = doc.get("duration_s")
    if not isinstance(dur, (int, float)) or dur <= 0:
        errors.append("duration_s must be a positive number")
    seed = doc.get("seed", 0)
    if not isinstance(seed, int):
        errors.append("seed must be an int")
    for f in ("time_scale", "settle_s"):
        v = doc.get(f)
        if v is not None and (not isinstance(v, (int, float)) or v <= 0):
            errors.append(f"{f} must be a positive number")

    arr = doc.get("arrivals")
    if not isinstance(arr, dict):
        errors.append("arrivals must be an object")
    else:
        proc = arr.get("process", "poisson")
        if proc not in ARRIVAL_PROCESSES:
            errors.append(f"arrivals.process must be one of "
                          f"{ARRIVAL_PROCESSES}, got {proc!r}")
        rate = arr.get("rate_per_s")
        if not isinstance(rate, (int, float)) or rate <= 0:
            errors.append("arrivals.rate_per_s must be a positive number")
        cap = arr.get("max_jobs")
        if cap is not None and (not isinstance(cap, int) or cap <= 0):
            errors.append("arrivals.max_jobs must be a positive int")
        diurnal = arr.get("diurnal")
        if diurnal is not None:
            if not isinstance(diurnal, dict) \
                    or not isinstance(diurnal.get("period_s"), (int, float)):
                errors.append("arrivals.diurnal requires a numeric period_s")
            elif not 0.0 <= float(diurnal.get("floor", 0.2)) <= 1.0:
                errors.append("arrivals.diurnal.floor must be in [0, 1]")
        for i, b in enumerate(arr.get("bursts", []) or []):
            where = f"arrivals.bursts[{i}]"
            if not isinstance(b, dict):
                errors.append(f"{where}: expected an object")
                continue
            for f in ("at_s", "duration_s", "multiplier"):
                if not isinstance(b.get(f), (int, float)) or b[f] < 0:
                    errors.append(f"{where}.{f} must be a non-negative "
                                  "number")

    dl = doc.get("deadlines", {})
    if not isinstance(dl, dict):
        errors.append("deadlines must be an object")
    else:
        frac = dl.get("fraction", 0.0)
        if not isinstance(frac, (int, float)) or not 0.0 <= frac <= 1.0:
            errors.append("deadlines.fraction must be in [0, 1]")
        for f in ("min_s", "max_s"):
            v = dl.get(f)
            if v is not None and (not isinstance(v, (int, float)) or v <= 0):
                errors.append(f"deadlines.{f} must be a positive number")
        if isinstance(dl.get("min_s"), (int, float)) \
                and isinstance(dl.get("max_s"), (int, float)) \
                and dl["max_s"] < dl["min_s"]:
            errors.append("deadlines.max_s must be >= deadlines.min_s")

    dd = doc.get("dedup", {})
    if not isinstance(dd, dict):
        errors.append("dedup must be an object")
    else:
        di = dd.get("distinct_inputs")
        if di is not None and (not isinstance(di, int) or di < 0):
            errors.append("dedup.distinct_inputs must be a non-negative int "
                          "(0/null = every arrival unique)")

    tenants = doc.get("tenants")
    if not isinstance(tenants, list) or not tenants:
        errors.append("scenario requires a non-empty 'tenants' list")
        tenants = []
    names: set[str] = set()
    for i, t in enumerate(tenants):
        where = f"tenants[{i}]"
        if not isinstance(t, dict):
            errors.append(f"{where}: expected an object")
            continue
        name = t.get("name")
        if not isinstance(name, str) or not name:
            errors.append(f"{where}: missing or empty 'name'")
        elif name in names:
            errors.append(f"{where}: duplicate tenant name {name!r}")
        else:
            names.add(name)
        w = t.get("weight", 1.0)
        if not isinstance(w, (int, float)) or w <= 0:
            errors.append(f"{where}.weight must be a positive number")
        df = t.get("deadline_fraction")
        if df is not None and (not isinstance(df, (int, float))
                               or not 0.0 <= df <= 1.0):
            errors.append(f"{where}.deadline_fraction must be in [0, 1]")
        quota = t.get("quota")
        if quota is not None:
            if not isinstance(quota, dict):
                errors.append(f"{where}.quota must be an object")
            else:
                allowed = {"max_inflight_ops", "max_active_workflows",
                           "budget_usd", "weight"}
                for k in set(quota) - allowed:
                    errors.append(f"{where}.quota: unknown field {k!r} "
                                  f"(expected one of {sorted(allowed)})")
        workload = t.get("workload")
        if not isinstance(workload, list) or not workload:
            errors.append(f"{where}: requires a non-empty 'workload' list")
            continue
        for j, item in enumerate(workload):
            iw = f"{where}.workload[{j}]"
            if not isinstance(item, dict):
                errors.append(f"{iw}: expected an object")
                continue
            if ("template" in item) == ("spec" in item):
                errors.append(f"{iw}: exactly one of 'template' or 'spec'")
                continue
            if "template" in item and item["template"] not in TEMPLATES:
                errors.append(f"{iw}: unknown template {item['template']!r} "
                              f"(have {sorted(TEMPLATES)})")
            if "spec" in item:
                spec_errors = validate_spec(_substitute(
                    item["spec"], {"$shard": "x/shard-0", "$tenant": "t"}))
                errors.extend(f"{iw}.spec: {e}" for e in spec_errors)

    faults = doc.get("faults", [])
    if not isinstance(faults, list):
        errors.append("faults must be a list")
        faults = []
    for i, f in enumerate(faults):
        where = f"faults[{i}]"
        if not isinstance(f, dict):
            errors.append(f"{where}: expected an object")
            continue
        if f.get("kind") not in FAULT_KINDS:
            errors.append(f"{where}.kind must be one of {FAULT_KINDS}, "
                          f"got {f.get('kind')!r}")
        if not isinstance(f.get("at_s"), (int, float)) or f["at_s"] < 0:
            errors.append(f"{where}.at_s must be a non-negative number")
        if not isinstance(f.get("target"), str) or not f.get("target"):
            errors.append(f"{where}.target must be a non-empty string")

    slo = doc.get("slo", {})
    if not isinstance(slo, dict):
        errors.append("slo must be an object")
    return errors


def compile_scenario(doc: dict) -> Scenario:
    """Validate ``doc`` and compile it into a ``Scenario``.

    Raises ``ScenarioError`` on any problem. Rendering errors (a template
    rejecting a param) surface here, not mid-run: compilation renders one
    probe arrival per workload item.
    """
    errors = validate_scenario(doc)
    if errors:
        raise ScenarioError(errors)
    faults = sorted((Fault(t=float(f["at_s"]), kind=f["kind"],
                           target=f["target"])
                     for f in doc.get("faults", [])), key=lambda f: f.t)
    sc = Scenario(
        name=doc["name"],
        seed=int(doc.get("seed", 0)),
        duration_s=float(doc["duration_s"]),
        tenants=doc["tenants"],
        arrivals=doc["arrivals"],
        deadlines=doc.get("deadlines", {}),
        dedup=doc.get("dedup", {}),
        faults=faults,
        slo=doc.get("slo", {}),
        time_scale=float(doc.get("time_scale", 1.0)),
        settle_s=float(doc.get("settle_s", 60.0)),
        doc=doc,
    )
    # probe-render every workload item so bad template params fail at
    # compile time with a located error, not on arrival #137
    probe = random.Random(0)
    for t in sc.tenants:
        for item in t["workload"]:
            try:
                stub = Scenario(
                    name=sc.name, seed=0, duration_s=1.0,
                    tenants=[{"name": t["name"], "workload": [item]}],
                    arrivals=sc.arrivals, deadlines=sc.deadlines,
                    dedup=sc.dedup, faults=[])
                arrival = stub._render_arrival(0.0, 0, probe)
            except Exception as e:  # template TypeError, SpecError, ...
                raise ScenarioError(
                    [f"tenant {t['name']!r} workload item failed to "
                     f"render: {e}"]) from e
            spec_errors = validate_spec(arrival.doc)
            if spec_errors:
                raise ScenarioError(
                    [f"tenant {t['name']!r} workload item renders an "
                     f"invalid spec: {e}" for e in spec_errors])
    return sc


def load_scenario(path: str | Path) -> Scenario:
    return compile_scenario(load_scenario_doc(path))
