"""Analytic device + workload cost model.

Serves two roles:
  1. the control plane's ``T_eff(j, B)`` predictor in the utility (Eq. 1);
  2. the discrete-event simulator's ground-truth task durations / energy.

The simulator intentionally uses the SAME estimator with a per-worker noise
factor, so scheduling decisions are good-but-not-oracle (as in a real cluster
where the cost model is approximate).

Device classes mirror the paper's testbed (H100 NVL 94 GB, RTX 4090 48 GB,
RTX 4090 24 GB, Vast.ai-style Oct-2025 rental prices) plus the TPU v5e target
of the dry-run/roofline work. All rates are dense-bf16 peak; MFU factors model
achievable fractions per phase. The table is spec-sheet and price data for
the classes the scheduler places work on, copied from the reference package
as data: nothing in it was measured on the port's card.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class DeviceClass:
    name: str
    vram_gb: float
    flops: float            # peak dense bf16 FLOP/s
    hbm_bw: float           # bytes/s
    net_bw: float           # bytes/s from CAS (model/artifact fetch)
    price_hr: float         # $/hr while provisioned
    power_w: float          # active power draw
    idle_power_w: float     # provisioned-but-idle draw
    mfu_train: float = 0.40
    mfu_prefill: float = 0.55
    provision_s: float = 15.0   # lease/boot lag


H100_NVL = DeviceClass("h100-nvl-94g", 94, 835e12, 3.9e12, 2.5e9, 2.30, 400, 90,
                       provision_s=20.0)
RTX4090_48 = DeviceClass("rtx4090-48g", 48, 165e12, 1.01e12, 1.2e9, 0.55, 380, 60,
                         provision_s=45.0)   # marketplace-style lag
RTX4090_24 = DeviceClass("rtx4090-24g", 24, 165e12, 1.01e12, 1.2e9, 0.35, 350, 50,
                         provision_s=45.0)
TPU_V5E = DeviceClass("tpu-v5e", 16, 197e12, 819e9, 2.0e9, 1.20, 250, 60,
                      provision_s=25.0)
CPU_NODE = DeviceClass("cpu-node", 0, 2e12, 100e9, 1.0e9, 0.08, 120, 30,
                       provision_s=10.0)

DEVICE_CLASSES: dict[str, DeviceClass] = {
    d.name: d for d in (H100_NVL, RTX4090_48, RTX4090_24, TPU_V5E, CPU_NODE)
}

# resource_class -> predicate over device class (hard feasibility, Eq. 1 text)
RESOURCE_CLASSES: dict[str, float] = {
    # minimum VRAM in GB implied by the class; 0 => CPU ok
    "cpu": 0.0,
    "gpu.small": 12.0,
    "gpu.medium": 24.0,
    "gpu.large": 40.0,
    "gpu.xlarge": 80.0,
}


def feasible(dev: DeviceClass, resource_class: str,
             vram_needed_gb: float = 0.0) -> bool:
    min_vram = RESOURCE_CLASSES.get(resource_class, 0.0)
    if min_vram == 0.0 and resource_class == "cpu":
        return True
    return dev.vram_gb >= max(min_vram, vram_needed_gb)


# ---------------------------------------------------------------------------
# Model catalogue (paper's §5 models + reward heads). Sizes in parameters.
# ---------------------------------------------------------------------------
MODEL_SIZES: dict[str, float] = {
    "llama-3.2-1b": 1.24e9,
    "llama-3.2-3b": 3.21e9,
    "llama-3.1-8b": 8.03e9,
    "reward-1b": 1.24e9,
    "reward-3b": 3.21e9,
    "tiny-lm": 2.0e7,          # the real-compute executor's model on the CPU
}
BYTES_PER_PARAM = 2.0          # bf16 weights


def model_params(model_id: str) -> float:
    return MODEL_SIZES.get(model_id, 1.0e9)


def model_bytes(model_id: str) -> float:
    return model_params(model_id) * BYTES_PER_PARAM


def model_vram_gb(model_id: str, *, training: bool = False,
                  lora: bool = False) -> float:
    """Weights + KV/optimizer headroom. Full-weight training ~5x weights
    (bf16 grads + bf16 Adam moments + remat'd activations — the TRL-style
    memory-efficient recipe that fits 8B on one H100 NVL); LoRA ~1.3x;
    inference ~1.4x (KV)."""
    base = model_bytes(model_id) / 1e9
    if training:
        return base * (1.3 if lora else 5.0) + 2.0
    return base * 1.4 + 1.0


@dataclass
class WorkEstimate:
    duration_s: float
    energy_j: float
    flops: float
    bytes_moved: float
    load_s: float = 0.0      # model cold-load component (avoided when hot)


def load_time_s(model_id: str, dev: DeviceClass) -> float:
    """Cold start: pull weights from CAS over net + push to HBM."""
    b = model_bytes(model_id)
    return b / dev.net_bw + b / dev.hbm_bw + 2.0   # +2 s runtime init


def inference_time_s(model_id: str, dev: DeviceClass, *, batch: int,
                     tokens_in: int, tokens_out: int) -> tuple[float, float, float]:
    """(seconds, flops, bytes) for a batched generate/score run (weights hot).

    Prefill is compute-bound: 2·N·T_in per sequence at mfu_prefill.
    Decode is memory-bound: each step reads the weights once for the WHOLE
    batch (this is why cross-tenant batching pays) plus per-sequence KV.
    """
    n = model_params(model_id)
    wbytes = model_bytes(model_id)
    prefill_flops = 2.0 * n * tokens_in * batch
    t_prefill = prefill_flops / (dev.flops * dev.mfu_prefill)
    # decode: per token-step, max(weight read, compute across batch)
    kv_bytes_per_tok = 0.10 * wbytes / 1000.0   # coarse per-token KV footprint
    step_bytes = wbytes + batch * kv_bytes_per_tok * (tokens_in + tokens_out / 2)
    step_flops = 2.0 * n * batch
    t_step = max(step_bytes / dev.hbm_bw, step_flops / (dev.flops * 0.9))
    t_decode = tokens_out * t_step
    flops = prefill_flops + step_flops * tokens_out
    bytes_moved = step_bytes * tokens_out + 2.0 * n * batch  # + prefill IO
    return t_prefill + t_decode, flops, bytes_moved


def train_time_s(model_id: str, dev: DeviceClass, *, tokens: int,
                 lora: bool = False) -> tuple[float, float]:
    """(seconds, flops) for a training stage over ``tokens`` tokens."""
    n = model_params(model_id)
    factor = 3.6 if lora else 6.0    # LoRA backward touches adapters only
    flops = factor * n * tokens
    return flops / (dev.flops * dev.mfu_train), flops


def cpu_op_time_s(op_type: str, payload_items: int) -> float:
    base = {"tool": 1.5, "data_prep": 0.8, "aggregate": 0.3}.get(op_type, 0.5)
    return base + 0.01 * payload_items


@dataclass
class CostMeter:
    """Integrates $ and joules for one worker over its provisioned lifetime."""
    dev: DeviceClass
    provisioned_at: float = 0.0
    active_s: float = 0.0
    retired_at: float | None = None
    _samples: list = field(default_factory=list)

    def note_active(self, seconds: float) -> None:
        self.active_s += seconds

    def totals(self, now: float) -> tuple[float, float]:
        """(dollars, joules) up to ``now``."""
        end = self.retired_at if self.retired_at is not None else now
        lifetime = max(0.0, end - self.provisioned_at)
        dollars = self.dev.price_hr * lifetime / 3600.0
        idle_s = max(0.0, lifetime - self.active_s)
        joules = self.dev.power_w * self.active_s + self.dev.idle_power_w * idle_s
        return dollars, joules
