#!/usr/bin/env python3
"""Times the split-KV ``decode_attention`` kernel on a CUDA card over its
tiles per split, at the decode shapes of smollm-135m (9/3 heads, hd 64),
llama-3.2-1b (32/8, hd 64) and zamba2-2.7b (32/32, hd 80): 8 slots of
2048, bf16, two sets of lengths (those of ``chip_smoke.py`` phase 3, and
eight served-like lengths of 800 to 1530), over as many layers of cache as
the model has, so the cache is not in the L2. It calls the kernel's C
entry with each plan directly, checks it against the plain version, and
prints one line a shape and length set: (tiles per split, splits, device
microseconds, GB/s) per plan, the plan ``split_plan`` picks, and SDPA's
time. It is how ``split_plan``'s rule was chosen.

    python3 scripts/decode_split_sweep.py      # from the root of a checkout

Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
S, B = 2048, 8
TPS = (1, 2, 3, 4, 5, 6, 8, 16)
SHAPES = (("smollm-135m", 9, 3, 64, 30), ("llama-3.2-1b", 32, 8, 64, 16),
          ("zamba2-2.7b", 32, 32, 80, 9))
LENGTHS = (("smoke", [0, 1, S, S + 5, 1305, 979, 787, 419]),
           ("served", [1500, 1100, 1300, 800, 1200, 1050, 1530, 900]))


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_split_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms, max_err
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    fn = dk._function()
    n_sm = dk._sm_count(dev)

    def run(q, k, v, lens, splits, tps):
        Hq, hd, Hkv = q.shape[1], q.shape[2], k.shape[2]
        ws, counters = dk._workspace(dev, B * Hq * splits * (hd + 2),
                                     B * Hkv)
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
                 out.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, Hq,
                 Hkv, S, hd, 1, splits, tps, q.stride(0), q.stride(1),
                 k.stride(0), k.stride(1), k.stride(2), v.stride(0),
                 v.stride(1), v.stride(2), 1.0 / hd ** 0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    sdpa = torch.nn.functional.scaled_dot_product_attention
    print(f"[sweep] {torch.cuda.get_device_name(0)}, {n_sm} SMs", flush=True)
    for name, Hq, Hkv, hd, L in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(1)
        q = torch.randn((L, B, Hq, hd), generator=gen, device=dev).bfloat16()
        k = torch.randn((L, B, S, Hkv, hd), generator=gen, device=dev
                        ).bfloat16()
        v = torch.randn((L, B, S, Hkv, hd), generator=gen, device=dev
                        ).bfloat16()
        for lname, lengths in LENGTHS:
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            want = ref.decode_attention_ref(q[0], k[0], v[0], lens)
            nbytes = 2 * int(np.minimum(lengths, S).sum()) * Hkv * hd * 2
            rows = []
            for tps in TPS:
                splits = -(-(S // dk.TILE) // tps)
                max_err(run(q[0], k[0], v[0], lens, splits, tps), want, 2e-2)
                ms = device_ms(lambda i: run(q[i % L], k[i % L], v[i % L],
                                             lens, splits, tps), 3 * L)
                rows.append((tps, splits, round(ms * 1e3, 2),
                             round(nbytes / ms / 1e6, 1)))
            mask = (torch.arange(S, device=dev)[None, :] < lens[:, None]
                    )[:, None, None, :]
            lib = device_ms(lambda i: sdpa(
                q[i % L][:, :, None], k[i % L].transpose(1, 2),
                v[i % L].transpose(1, 2), attn_mask=mask, enable_gqa=True),
                3 * L)
            print(f"[sweep] {name} {lname}: plan "
                  f"{dk.split_plan(B, Hkv, S, n_sm)}, (tps, splits, us, "
                  f"GB/s) {rows}, sdpa us {lib * 1e3:.2f}", flush=True)
        del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
