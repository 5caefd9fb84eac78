"""Elastic worker-pool management (serverless compute, §2/§3.2).

Scales on queue depth + SLO pressure, scales down idle workers, and chooses
which device class to lease by re-using the scheduler's own utility reasoning:
cheapest feasible class wins under cost-weighted policies, fastest under
perf-weighted ones. Provision lag comes from the backend (pods ~15 s,
marketplace 30–60 s — the paper's Fig. 9 lag).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .backends import Offer, Provisioner
from .cost_model import RESOURCE_CLASSES
from .scheduler import vram_needed_gb
from .worker import ExecutionGroup


@dataclass
class AutoscalerConfig:
    enabled: bool = True
    tick_s: float = 10.0
    target_depth_per_worker: float = 2.0   # scale up above this
    slo_wait_s: float = 60.0               # oldest-ready age triggering scale-up
    idle_timeout_s: float = 120.0          # retire after this much idleness
    min_workers: int = 1
    max_workers: int = 64
    cost_weighted: bool = True             # lease cheapest feasible vs fastest
    max_leases_per_tick: int = 4


@dataclass
class ScaleDecision:
    leases: list[Offer] = field(default_factory=list)
    retire: list[str] = field(default_factory=list)     # worker ids


class Autoscaler:
    def __init__(self, cfg: AutoscalerConfig, backend: Provisioner) -> None:
        self.cfg = cfg
        self.backend = backend
        self.pending_leases = 0    # leased but not yet ACTIVE

    def _pick_offer(self, offers: list[Offer]) -> Offer | None:
        if not offers:
            return None
        if self.cfg.cost_weighted:
            return min(offers, key=lambda o: o.price_hr / max(o.reliability, .5))
        return max(offers, key=lambda o: o.dev.flops * o.reliability)

    def decide(self, *, now: float, pending: dict[str, list[ExecutionGroup]],
               workers, oldest_wait_age: float) -> ScaleDecision:
        d = ScaleDecision()
        if not self.cfg.enabled:
            return d
        active = [w for w in workers
                  if w.state.value in ("active", "provisioning")]
        depth = sum(len(gs) for gs in pending.values())
        n_eff = len(active) + self.pending_leases

        # ---- scale up: depth or SLO pressure --------------------------------
        pressure = (depth > self.cfg.target_depth_per_worker * max(1, n_eff)
                    or oldest_wait_age > self.cfg.slo_wait_s)
        if pressure and n_eff < self.cfg.max_workers:
            # lease classes able to cover the *largest* pending demand first
            demands = sorted(
                {max(RESOURCE_CLASSES.get(gs[0].spec.resource_class, 0.0),
                     vram_needed_gb(gs[0].spec))
                 for gs in pending.values() if gs},
                reverse=True)
            budget = min(self.cfg.max_leases_per_tick,
                         self.cfg.max_workers - n_eff,
                         max(1, int(depth / max(1.0, self.cfg.target_depth_per_worker))
                             - n_eff))
            for min_vram in demands:
                if budget <= 0:
                    break
                offer = self._pick_offer(
                    self.backend.search_offers(min_vram, now))
                if offer is not None:
                    d.leases.append(offer)
                    budget -= 1

        # ---- scale down: idle beyond timeout ---------------------------------
        idlers = [w for w in active
                  if w.state.value == "active" and w.current is None
                  and w.queued_slices() == 0 and w.idle_since is not None
                  and now - w.idle_since > self.cfg.idle_timeout_s]
        keep = max(self.cfg.min_workers, 0)
        n_after = len(active) + self.pending_leases + len(d.leases)
        for w in sorted(idlers, key=lambda w: -w.dev.price_hr):
            if n_after - len(d.retire) - 1 < keep:
                break
            d.retire.append(w.worker_id)
        return d
