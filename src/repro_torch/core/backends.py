"""Provisioning backends: centralized Kubernetes-style vs decentralized
Vast.ai-style marketplace (§4, Table 2).

Both implement one ``Provisioner`` protocol so the control plane is backend-
agnostic — the same property the paper demonstrates by running identical
containerized workers on both infrastructures.
"""
from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass

from .cost_model import DEVICE_CLASSES, DeviceClass

_wid = itertools.count()


@dataclass
class Offer:
    dev: DeviceClass
    price_hr: float          # dynamic for marketplaces
    reliability: float       # P(survive 1 h) — feeds the cost model
    provision_s: float


class Provisioner:
    """Protocol: query offers, lease, terminate."""
    name = "base"

    def search_offers(self, resource_class_min_vram: float, now: float,
                      ) -> list[Offer]:
        raise NotImplementedError

    def lease(self, offer: Offer, now: float) -> tuple[str, float]:
        """Returns (worker_id, ready_at)."""
        wid = f"{self.name}-w{next(_wid)}"
        return wid, now + offer.provision_s

    def terminate(self, worker_id: str, now: float) -> None:
        pass


class KubernetesBackend(Provisioner):
    """HPA-style: fixed node classes, pre-configured costs, fast pod starts.
    Heterogeneity info comes from 'node labels' (the static class list)."""
    name = "k8s"

    def __init__(self, node_classes: list[str] | None = None,
                 capacity: dict[str, int] | None = None) -> None:
        self.node_classes = node_classes or [
            "h100-nvl-94g", "rtx4090-48g", "rtx4090-24g", "cpu-node"]
        self.capacity = dict(capacity or {})    # optional per-class cap
        self.leased: dict[str, str] = {}

    def search_offers(self, min_vram: float, now: float) -> list[Offer]:
        offers = []
        for cls in self.node_classes:
            dev = DEVICE_CLASSES[cls]
            if dev.vram_gb < min_vram:
                continue
            cap = self.capacity.get(cls)
            if cap is not None and sum(
                    1 for c in self.leased.values() if c == cls) >= cap:
                continue
            offers.append(Offer(dev, dev.price_hr, reliability=0.999,
                                provision_s=15.0))  # pod scheduling + pull
        return offers

    def lease(self, offer: Offer, now: float):
        wid, ready = super().lease(offer, now)
        self.leased[wid] = offer.dev.name
        return wid, ready

    def terminate(self, worker_id: str, now: float) -> None:
        self.leased.pop(worker_id, None)


class VastAiBackend(Provisioner):
    """Marketplace: dynamic prices, heterogeneous reliability, 30–60 s
    instance-creation lag (§5.4 observes exactly this lag window)."""
    name = "vastai"

    def __init__(self, seed: int = 0) -> None:
        self.rng = random.Random(seed)

    def _dyn_price(self, base: float, now: float) -> float:
        # diurnal demand wave + market noise
        wave = 1.0 + 0.15 * math.sin(now / 3600.0 * 2 * math.pi / 24.0)
        return base * wave * self.rng.uniform(0.85, 1.20)

    def search_offers(self, min_vram: float, now: float) -> list[Offer]:
        offers = []
        for cls in ("h100-nvl-94g", "rtx4090-48g", "rtx4090-24g"):
            dev = DEVICE_CLASSES[cls]
            if dev.vram_gb < min_vram:
                continue
            # a few distinct hosts per class with varying price/reliability
            for _ in range(3):
                offers.append(Offer(
                    dev, self._dyn_price(dev.price_hr, now),
                    reliability=self.rng.uniform(0.95, 0.995),
                    provision_s=self.rng.uniform(30.0, 60.0)))
        return offers
