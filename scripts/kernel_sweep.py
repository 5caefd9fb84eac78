#!/usr/bin/env python3
"""Two kernels of the port timed on the card, from this checkout's sources
or another's, device ms from CUDA-graph replays:

    python3 scripts/kernel_sweep.py flash [--hd 80 128] [--src OTHER/src]
    python3 scripts/kernel_sweep.py scan-bwd [--src OTHER/src]
    python3 scripts/kernel_sweep.py decode [--src OTHER/src]

``flash``: the flash kernels' forward and backward beside SDPA at each
bf16 head dim and at fp32 hd 64, the shapes of ``chip_smoke.ROUTE_SHAPES``
(phase 7's), or only the head dims given; one ``[kernel] flash_attention
route timing`` JSON line a shape. ``scan-bwd``: the SSD scan's backward,
each of its passes by kernel name and the plain version at mamba2-1.3b's
training shape, as phase 21 times it (the passes' kernels keep their
names from PR 22 on); one ``[kernel] ssd_scan backward timing`` line.
``decode``: the served ``decode_attention`` call (no log-sum-exp) at
phase 3's shapes and lengths of smollm-135m and llava-next-34b (B 8, S
2048, bf16, over the models' layers of cache), through the wrapper's
served signature alone, so any checkout's kernel times alike; one
``[kernel] decode_attention served timing`` line a shape.

With ``--src`` the kernels and their wrappers come from another checkout's
``src`` (built into that checkout's ``build/``), so that two versions are
compared in one call on one card: run parent, change, change, parent.
Prints the card's name and power limit and the compiler's registers and
spills of the kernels built; exits 1 without a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
KERNELS = {"flash": "flash_attention", "scan-bwd": "ssd_scan",
           "decode": "decode_attention"}


def time_served_decode(smoke) -> None:
    """The served decode call as ``chip_smoke`` phase 3 times it: the
    lengths phase 3 draws first (0, 1, S, past S and four from its seed),
    q, K and V drawn from ``SEED + 1`` in fp32 and cast to bf16, device ms
    of CUDA-graph replays over the model's layers of cache."""
    from repro_torch.kernels import decode_attention as dk
    dev = torch.device("cuda")
    B, S = smoke.B, smoke.S
    rng = np.random.default_rng(smoke.SEED)
    lengths = np.concatenate([[0, 1, S, S + 5],
                              rng.integers(8, 1533, B - 4)]).astype(np.int32)
    lens = torch.from_numpy(lengths).to(dev)
    for name, Hq, Hkv, hd, L in (("smollm-135m", 9, 3, 64, 30),
                                 ("llava-next-34b", 56, 8, 128, 60)):
        gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 1)
        q = torch.randn((L, B, Hq, hd), generator=gen, device=dev
                        ).to(torch.bfloat16)
        k = torch.randn((L, B, S, Hkv, hd), generator=gen, device=dev
                        ).to(torch.bfloat16)
        v = torch.randn((L, B, S, Hkv, hd), generator=gen, device=dev
                        ).to(torch.bfloat16)
        ms = smoke.device_ms(
            lambda i: dk.decode_attention(q[i % L], k[i % L], v[i % L], lens),
            3 * L)
        print("[kernel] decode_attention served timing " + json.dumps(
            {"shape": name, "B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "hd": hd,
             "layers": L, "lengths": lengths.tolist(), "ms": ms}),
            flush=True)
        del q, k, v
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=sorted(KERNELS))
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--hd", type=int, nargs="*",
                    help="flash: time only these head dims (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(f"[device] {card}; kernels from {args.src}", flush=True)
    name = KERNELS[args.what]
    for line in build.build([name]).get(name, "").splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)
    if args.what == "flash":
        for dtype, shape in chip_smoke.ROUTE_SHAPES:
            if not args.hd or shape[6] in args.hd:
                chip_smoke.time_flash_route(dtype, shape)
    elif args.what == "decode":
        time_served_decode(chip_smoke)
    else:
        chip_smoke.time_ssd_scan_bwd()
    return 0


if __name__ == "__main__":
    sys.exit(main())
