#!/usr/bin/env python3
"""Two kernels of the port timed on the card, from this checkout's sources
or another's, device ms from CUDA-graph replays:

    python3 scripts/kernel_sweep.py flash [--hd 80 128] [--src OTHER/src]
    python3 scripts/kernel_sweep.py scan-bwd [--src OTHER/src]

``flash``: the flash kernels' forward and backward beside SDPA at each
bf16 head dim and at fp32 hd 64, the shapes of ``chip_smoke.ROUTE_SHAPES``
(phase 7's), or only the head dims given; one ``[kernel] flash_attention
route timing`` JSON line a shape. ``scan-bwd``: the SSD scan's backward,
each of its passes by kernel name and the plain version at mamba2-1.3b's
training shape, as phase 21 times it (the passes' kernels keep their
names from PR 22 on); one ``[kernel] ssd_scan backward timing`` line.

With ``--src`` the kernels and their wrappers come from another checkout's
``src`` (built into that checkout's ``build/``), so that two versions are
compared in one call on one card: run parent, change, change, parent.
Prints the card's name and power limit and the compiler's registers and
spills of the kernels built; exits 1 without a CUDA card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
KERNELS = {"flash": "flash_attention", "scan-bwd": "ssd_scan"}


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
    else:
        chip_smoke.time_ssd_scan_bwd()
    return 0


if __name__ == "__main__":
    sys.exit(main())
