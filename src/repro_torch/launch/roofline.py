"""Roofline terms of a dry-run step on the H100 (counterpart of
``repro/launch/roofline.py``).

    compute    = FLOPs       / (chips * peak_FLOP/s)
    memory     = HBM_bytes   / (chips * HBM_bw)
    collective = coll_bytes  / (chips * link_bw)

The FLOPs and bytes come from ``analysis.step_cost`` over the step as it
runs on the ``meta`` device; the collective bytes from the collectives
that step issued (``analysis.StepCounter`` records each with its output
size and group), summed by ``collective_bytes`` with the reference's
operand rule.

The reference parses the optimized HLO text of a compiled XLA program:
``_computation_blocks``, ``_while_body_trips``, ``hlo_hbm_bytes``,
``cpu_upcast_overhead_bytes`` and ``_collective_bytes_flat``. PyTorch's
eager step has no HLO and no loops to multiply out (each layer runs, and
is counted, once), and the meta device makes no fp32 copies of bf16
leaves, so none of them has a counterpart here.

``LINK_BW`` is the inter-node rate: the production meshes put 16 ranks on
each axis and a node holds 8 cards, so every collective along "data" or
"model" crosses nodes, and its slowest hop is one InfiniBand port a card.
NVLink (``NVLINK_BW``) carries only the hops inside a node, so the term
uses the slower rate that every collective pays.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

# --- H100 SXM5 80GB constants (per card; NVIDIA H100 Tensor Core GPU data
# sheet, SXM5 column) ---
PEAK_FLOPS = 989.4e12     # bf16 dense tensor-core FLOP/s (1979 sparse)
HBM_BW = 3.35e12          # HBM3 bytes/s
LINK_BW = 50e9            # bytes/s a direction: one 400 Gb/s NDR
#                           InfiniBand port (ConnectX-7) a card
NVLINK_BW = 450e9         # bytes/s a direction: NVLink 4, 900 GB/s both
HBM_BYTES = 80e9          # the data sheet's 80 GB, decimal: torch reports
#                           85.0e9 total, of which the CUDA context and the
#                           allocator's pools take some

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_bytes(records) -> tuple[int, dict[str, int]]:
    """Sum of the operand bytes of the collectives in ``records``, each
    (kind, output bytes, group size), and the sums by kind. An
    all-gather's operand is its output over the group, a reduce-scatter's
    its output times the group, any other's its output."""
    total = 0
    per_kind: dict[str, int] = {}
    for kind, out_bytes, gsize in records:
        gsize = max(int(gsize), 1)
        if kind == "all-gather":
            op_bytes = out_bytes // gsize
        elif kind == "reduce-scatter":
            op_bytes = out_bytes * gsize
        else:
            op_bytes = out_bytes
        total += op_bytes
        per_kind[kind] = per_kind.get(kind, 0) + op_bytes
    return total, per_kind


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_by_kind: dict
    model_flops: float            # 6ND (train) / 2ND (inference), N_active
    bytes_per_device: float       # rank 0's peak
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def finalize(self) -> "Roofline":
        self.compute_s = self.hlo_flops / (self.chips * PEAK_FLOPS)
        self.memory_s = self.hlo_bytes / (self.chips * HBM_BW)
        self.collective_s = self.coll_bytes / (self.chips * LINK_BW)
        return self

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / FLOPs — remat/redundancy waste detector."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    min_bytes: float = 0.0     # memory floor (params+cache+activations)

    @property
    def roofline_fraction(self) -> float:
        """Achieved fraction of the cell's roofline: ideal time (max of the
        compute ideal and the memory FLOOR) over the bounding term."""
        ideal = max(self.model_flops / (self.chips * PEAK_FLOPS),
                    self.min_bytes / (self.chips * HBM_BW))
        return ideal / self.bound_s if self.bound_s else 0.0

    def to_json(self) -> dict:
        d = asdict(self)
        d.update(dominant=self.dominant, useful_fraction=self.useful_fraction,
                 roofline_fraction=self.roofline_fraction,
                 bound_s=self.bound_s)
        return d


def model_flops_estimate(n_params_active: float, tokens: float,
                         kind: str) -> float:
    """6*N*D for training, 2*N*D for inference forward."""
    return (6.0 if kind == "train" else 2.0) * n_params_active * tokens
