"""Serving entry point: a FlowMesh worker lane in miniature, on the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --requests 16 --max-new 12

Boots the continuous-batching engine for one arch with seeded random
weights, streams a batch of multi-tenant requests through it, and reports
throughput. Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.transformer import build_model
from repro_torch.serve.engine import Request, ServingEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device)
                        .manual_seed(args.seed))
    eng = ServingEngine(model, params, n_slots=args.slots,
                        max_len=args.max_len, seed=args.seed)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rng.integers(0, cfg.vocab_size,
                                 int(rng.integers(4, 24))).astype(np.int32),
                    max_new_tokens=args.max_new,
                    tenant=f"tenant-{i % 4}")
            for i in range(args.requests)]
    t0 = time.time()
    done = eng.run(reqs)
    dt = time.time() - t0     # the engine reads its tokens back each step
    result = {
        "requests": len(done),
        "tokens_generated": eng.tokens_generated,
        "engine_steps": eng.steps,
        "wall_s": round(dt, 2),
        "tok_per_s": round(eng.tokens_generated / dt, 1),
        "tenants": sorted({r.tenant for r in done}),
    }
    print(f"[serve] {json.dumps(result)}")
    return result


if __name__ == "__main__":
    main()
