"""Training entry point with CAS-backed checkpoint/restart, on the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 6 --batch 8 --seq 2048 --ckpt-every 0
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu

The reference's flags (``repro/launch/train.py``) plus ``--device``
(default ``cuda``; the CPU only when asked) and ``--warmup``. Every
``--ckpt-every`` steps the full train state goes into a ``DiskCAS``
(unchanged leaves cost nothing); ``--resume latest`` restarts from the
newest manifest and replays the same data stream (a batch is a pure
function of its step), so the trajectory equals an uninterrupted run's.
The vlm backbone trains text-only and the enc-dec family is refused, as
in the reference: ``SyntheticLM`` gives no frames.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.cas import DiskCAS
from repro_torch.models.transformer import build_model
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import OptimizerConfig, build_optimizer
from repro_torch.train.train_step import build_train_step, init_train_state

DEFAULT_CAS = Path(__file__).resolve().parents[3] / "build" / "flowmesh-cas"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--cas", default=str(DEFAULT_CAS))
    ap.add_argument("--run-name", default="train-e2e")
    ap.add_argument("--resume", default=None,
                    help="manifest hash to resume from ('latest' works)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "encdec":
        # as the reference's data, the port's gives only tokens and labels
        raise SystemExit(f"{cfg.name}: the enc-dec family needs frames, and "
                         "SyntheticLM gives only tokens and labels")
    model = build_model(cfg, device=args.device)
    opt_cfg = OptimizerConfig(peak_lr=args.lr, warmup=args.warmup,
                              total_steps=max(args.steps, 100))
    opt = build_optimizer(opt_cfg)
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                  seed=args.seed), device=model.device)
    cas = DiskCAS(args.cas)
    ckpt = Checkpointer(cas, args.run_name)

    start_step = 0
    if args.resume:
        mh = None if args.resume == "latest" else args.resume
        state, start_step, _ = ckpt.restore(mh, device=model.device)
        print(f"[train] resumed from step {start_step} "
              f"(manifest {ckpt.latest or mh})")
    else:
        state = init_train_state(model, opt, torch.Generator(
            device=model.device).manual_seed(args.seed))

    step_fn = build_train_step(model, opt, grad_accum=args.grad_accum)
    losses, gnorms, step_s = [], [], []
    t0 = time.perf_counter()
    last_manifest = None
    for i in range(start_step, args.steps):
        t_step = time.perf_counter()
        state, m = step_fn(state, data.batch(i))
        losses.append(float(m["loss"]))           # waits for the step
        gnorms.append(float(m["grad_norm"]))
        step_s.append(time.perf_counter() - t_step)
        if args.log_every and (i + 1) % args.log_every == 0:
            rate = (i + 1 - start_step) / (time.perf_counter() - t0)
            print(f"[train] step {i + 1:5d} loss {losses[-1]:.4f} "
                  f"gnorm {gnorms[-1]:.3f} ({rate:.1f} steps/s)")
        if args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            last_manifest = ckpt.save(state, step=i + 1,
                                      extra={"arch": args.arch})
            print(f"[train] checkpoint @ {i + 1}: {last_manifest} "
                  f"({cas.bytes_written / 1e6:.1f} MB in CAS)")
    result = {
        "first_loss": losses[0] if losses else None,
        "final_loss": float(np.mean(losses[-10:])) if losses else None,
        "steps": args.steps,
        "manifest": last_manifest,
        "converged": bool(losses and np.mean(losses[-10:])
                          < losses[0] - 0.2),
        "losses": losses,
        "grad_norms": gnorms,
        "step_s": step_s,
    }
    print(f"[train] done: {json.dumps(result)}")
    return result


if __name__ == "__main__":
    main()
