"""Deterministic synthetic data (counterpart of ``repro/train/data.py``).

The same token formula as the reference's, over base draws from a
stateless numpy generator of the port's own, seeded by (seed, step,
host_id): a batch is a pure function of its step, so a resumed run
replays the same stream and each host derives its shard alone. torch and
numpy cannot reproduce ``jax.random``, so the two packages' streams
differ; parity tests feed the reference's batches to both.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: int = 97     # periodicity that makes the stream learnable


class SyntheticLM:
    """batch(step) -> {tokens, labels, loss_mask}; pure function of step."""

    def __init__(self, cfg: DataConfig,
                 device: str | torch.device = "cpu") -> None:
        self.cfg = cfg
        self.device = torch.device(device)

    def batch(self, step: int, *, batch_size: int | None = None,
              host_id: int = 0, n_hosts: int = 1) -> dict:
        cfg = self.cfg
        B = batch_size or cfg.global_batch
        B_local = B // n_hosts
        rng = np.random.default_rng((cfg.seed, step, host_id))
        base = rng.integers(0, cfg.structure, (B_local, cfg.seq_len + 1))
        # structured stream: next token depends deterministically on previous
        toks = (base[:, :-1] * 31 + base[:, 1:]) % cfg.vocab_size
        nxt = (base[:, 1:] * 31 + (base[:, 1:] + 1) % cfg.structure) \
            % cfg.vocab_size
        t = lambda a: torch.from_numpy(a.astype(np.int32)).to(self.device)
        return {"tokens": t(toks), "labels": t(nxt),
                "loss_mask": t(np.ones_like(toks))}


def preference_batch(vocab: int, seq: int, batch: int, step: int,
                     seed: int = 0, device: str | torch.device = "cpu"
                     ) -> dict:
    """Synthetic (chosen, rejected) pairs for DPO/reward training."""
    rng = np.random.default_rng((seed + 101, step))
    chosen = rng.integers(0, vocab, (batch, seq))
    rejected = rng.integers(0, vocab, (batch, seq))
    mask = np.ones((batch, seq), np.float32)
    mask[:, :seq // 4] = 0.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {
        "chosen": t(chosen.astype(np.int32)),
        "chosen_labels": t(np.roll(chosen, -1, axis=1).astype(np.int32)),
        "chosen_mask": t(mask),
        "rejected": t(rejected.astype(np.int32)),
        "rejected_labels": t(np.roll(rejected, -1, axis=1).astype(np.int32)),
        "rejected_mask": t(mask.copy()),
    }
