#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each fatal on failure (nothing is caught):
  1. the card's name and power limit (``nvidia-smi``); TF32 off for
     matrix products and cuDNN, so fp32 results compare in full fp32;
  2. builds every kernel of the served and trained paths from
     ``src/repro_torch/kernels/csrc`` with ``nvcc`` (one process per source,
     three sources, started together) and prints each kernel's registers,
     shared memory and spills (the dynamic shared memory of the wgmma
     backward and of the scan's passes from the libraries);
  3. holds the decode kernel against its plain PyTorch version on the card
     at the decode shapes of smollm-135m, llama-3.2-1b, zamba2-2.7b (hd 80),
     qwen2-moe-a2.7b (16/16, hd 128), llava-next-34b (56/8, hd 128, a
     group of 7) and whisper-tiny (6/6, hd 64, S 448), and at the head dims
     of phi3-mini (96) and kimi-k2 (112)
     (B 8, S 2048; lengths 0, 1, S and past S among them), fp32 at 1e-4 and
     bf16 at 2e-2, repeated calls bit-identical, and times kernel, plain
     version and a library call (with the split plan, the achieved GB/s
     and the kernel on a head-major copy of the cache);
  4. serves 16 requests at the full width of smollm-135m in bf16 through
     ``ServingEngine`` (8 slots, max_len 2048, prompts of 8 to 1500 tokens,
     32 new tokens, one request submitted mid-flight) and checks that every
     decode step of every layer launched the kernel;
  5. parity: a served bf16 stream teacher-forced through the same model with
     the plain attention, and fp32 engine streams against a sequential
     single-request reference with the plain attention;
  6. ``repro_torch.launch.serve`` at full width;
  7. holds the flash attention kernels, forward and backward, against the
     plain version and autograd through it on the card (fp32 at 1e-4, bf16
     at 2e-2) at the smollm-135m training shape (B 8, T 2048, 9/3/64),
     llama-3.2-1b (32/8/64), llama-3.1-8b's hd 128 (32/8/128), the head
     dims 80, 96 and 112 of zamba2, phi3-mini and kimi-k2 (T 1024), a
     ragged T, T = 1, a non-causal T != S, the fabric executor's train
     shape (B 4, T 32), whisper-tiny's decoder (B 8, T 448, 6/6/64) and
     llava-next-34b's 576 patches + 512 tokens (B 2, T 1088, 56/8/128)
     (the bf16 forward and backward
     on wgmma at hd 64 and 128, on mma.sync at the others, the library's
     route tables checked against the wrapper's; repeated forwards
     bit-identical), and times kernel, plain version and SDPA at the
     training shape, forward and backward (with achieved TFLOP/s, the
     routes and the device ms of each backward kernel); and the decode
     kernel against its plain version at the fabric executor's serving
     shape (4 slots, S 256, 9/3/64);
  8. trains full-width smollm-135m in bf16 with ``remat="block"`` through
     ``repro_torch.launch.train`` (AdamW, 6 steps of 8 x 2048 tokens) and
     checks falling finite losses and that every layer's attention went
     through the kernels (2 x 30 forward and 30 backward launches a step);
     profiles one train step;
  9. train parity: one step's loss and gradients with the kernels against
     the plain attention (fp32 at 4 layers, bf16 at the full config), and
     two identical 2-step runs with bit-identical losses;
 10. holds the SSD scan kernel against the chunked plain version (2e-4)
     and the sequential recurrence (y 2e-4, state 1e-3) in fp32 at the
     prefill shapes of mamba2-1.3b and zamba2-2.7b, a single chunk of 37
     tokens at B 8, a nonzero initial state and the sweep of
     ``tests/test_kernels.py``; checks chunk-size invariance; times kernel
     (and each of its four passes) and plain version at the mamba2 and
     zamba2 prefill shapes;
 11. serves 16 requests at the full width of mamba2-1.3b in bf16 (8 slots,
     max_len 2048, prompts of 8 to 256, 512, 1024 and 1536 tokens, 32 new
     tokens, one submitted mid-flight), checks 48 scan launches a
     prefill, and profiles decode steps and a prefill;
 12. the same for zamba2-2.7b: 54 scan launches a prefill, 9
     ``decode_attention`` launches a decode step (hd 80);
 13. parity of both families as in phase 5, with the plain scan and the
     plain attention (fp32 streams at 4 layers of mamba2, 12 of zamba2),
     with controls beside the bf16 check (the kernels at batch 1, the
     sequential scan, for zamba2 the plain scan with the decode attention
     kernel) and a planted fault the check must catch (a neighbouring
     request's SSM state), and an fp32 prefill of 1536 tokens at full
     depth, kernels against plain versions;
 14. ``repro_torch.launch.serve --arch mamba2-1.3b``;
 15. the fabric: ``repro_torch.launch.rlhf`` at full-width smollm-135m,
     twice, each with a fresh engine and ``TorchExecutor``: four RLHF
     tenants complete every op with one execution per H_task; the decode
     and both flash kernels launched in the phase; the two runs published
     the same output for every H_task both ran; every served payload
     equals its prompt run alone through a fresh ``ServingEngine``. Prints
     a ``[fabric]`` line (the executor's median wall ms per op type, the
     phase's launches and seconds; dollars and energy are the cost
     model's, labelled modelled);
 16. the service: ``launch.rlhf``'s journaled ``FabricService`` (a fresh
     ``DiskCAS`` under ``build/``) with a full-width ``TorchExecutor``
     behind ``FabricHTTPServer`` on loopback (auto-pumped); a
     ``RemoteAPI`` client submits ``rlhf`` for t0 and t1 on
     ``gsm8k/shard-0``, ``rlhf`` for t2 on ``gsm8k/shard-1`` and
     ``distill`` for t3 on ``gsm8k/shard-0`` while a ``FollowerFabric``
     tails the store behind its own server. Every job completes with one
     execution per H_task and some dedup; the decode and both flash
     kernels launched in the phase; ``GET /metrics`` counts one
     ``workflow_completed`` per tenant; the follower's ``GET /jobs`` and
     traces equal the primary's; every served payload equals its prompt
     run alone. A second service with a fresh executor restores the
     journal and equals the live one (jobs, lineage, the event-sourced
     usage, traces, result index); t0's resubmission completes with no
     execution; after ``compact()`` and ``gc()`` a third restore equals
     the second. Prints a ``[service]`` line;
 17. the scenarios: ``steady_mix`` and ``worker_preemption`` (held here as
     dicts, compiled by ``repro_torch.scenarios``) through
     ``launch.scenario`` on a fresh service and full-width
     ``TorchExecutor`` each, on the virtual driver, then ``steady_mix``
     open loop against the service behind ``FabricHTTPServer`` on loopback
     (auto-pumped) through a ``RemoteAPI`` client at the document's pace.
     ``worker_preemption``'s ``worker-a`` crashes the service's first lane
     mid-run (what the lane held then is printed). Every job completes,
     every fault fires, every H_task published one output, the ops
     executed plus deduped are those of the same schedule on
     ``SimExecutor``, the report has ``REPORT_KEYS``, every served payload
     equals its prompt run alone, and the decode and both flash kernels
     launched in each run. Prints a ``[scenario]`` line a run (the report,
     its cost and energy as the cost model's, labelled modelled, the
     executor's median wall ms per op type, the engine's executions and
     retries, the launches and seconds);
 18. the MoE family: serves 16 requests at the full width of
     qwen2-moe-a2.7b in bf16 as in phase 4 (24 ``decode_attention``
     launches a decode step), profiles decode steps and prefills with the
     device ms of ``moe_block``'s parts against the step's bound (the
     weights' bytes); bf16 parity as in phase 5 with the count of tokens
     whose top-k experts differ from the plain path's, by layer, controls
     (the kernels at batch 1, the plain model at batch 8) and two planted
     faults (a neighbouring request's KV cache, gates not renormalised);
     two decode steps on one cache bit-identical with no host sync, and
     every served stream equal to its prompt run alone; fp32 engine streams
     at 4 layers against the sequential plain reference; one fp32 train
     step at 2 layers, loss with the auxiliary term and gradients, flash
     kernels against the plain attention; ``repro_torch.launch.serve --arch
     qwen2-moe-a2.7b``; the phase's peak memory;
 19. the enc-dec family: whisper-tiny at full width (4 + 4 layers, d 384,
     enc_len 1500) in bf16, served at the model's level (the engine hands
     prefill only tokens, as the reference's does): 8 rows of seeded
     frames and 4-token prompts, prefill and 32 greedy steps on a cache of
     448 (4 ``decode_attention`` launches a step); the encoder's device ms,
     the decode step's host and device ms; bf16 logits against the plain
     decode attention fed the same tokens, beside a control (the plain
     model a row at a time) and a planted fault (a neighbouring row's cross
     K/V); two decode steps on one cache bit-identical; fp32 greedy streams
     against the plain path; one fp32 train step (B 8, T 448), flash
     kernels against the plain attention;
 20. the vlm family: llava-next-34b at full width (60 layers, d 7168, 56/8
     heads of hd 128, 68.9 GB of bf16 weights drawn a layer at a time)
     served text-only as in phase 4 (60 ``decode_attention`` launches a
     step), the decode step's device ms against its bound (the weights'
     and KV rows' bytes), bf16 parity with a control (the kernels at batch
     1) and a planted fault (a neighbouring request's KV cache); a prefill
     of 576 seeded patch embeddings and 64 tokens (``index`` 640) and 8
     decode steps against the plain decode attention; fp32 engine streams
     at 4 layers; one fp32 train step at 2 layers on 576 patches + 512
     tokens (flash at a group of 7); ``repro_torch.launch.serve --arch
     llava-next-34b``; the phase's peak memory.

It then prints the kernels line and, last, the device line as JSON. Exits
non-zero without a CUDA card or outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
B, S = 8, 2048                     # decode shape: engine slots, max_len
SEED = 0
DEV = "cuda"
# Peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet, dense):
# the least time for a call is the larger of bytes / memory rate and
# operations / the rate for the inputs' type.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12           # fp32 FMAs on the CUDA cores (same sheet)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 served logits against the same model with the plain attention: the
# two paths round K/V, q and the residual stream to bf16 at other places
# (batch of 8 against a batch of 1, decode kernel against plain einsums),
# and 30 layers carry that rounding (~2^-8 relative) into logits of size ~1.
BF16_LOGIT_ATOL = 0.15
# The same for mamba2-1.3b and zamba2-2.7b against the plain scan and
# attention. These bf16 models amplify any fp32-level change: summing the
# scan in the sequential order instead of the chunked plain version's
# moves their logits by up to 0.195 (H100 runs), as much as the scan kernel
# does (0.20 for mamba2), since 48 or 54 layers of bf16 rounding act on it
# and the fp32 SSM state keeps each decode step's difference for all later
# steps. The hybrid has a second such seam: the plain scan with the decode
# attention kernel moves its logits by up to 0.30, the two kernels together
# by up to 0.334 (H100 runs). A neighbouring request's SSM state, planted as
# a fault, moves them by 5.8 to 6.7, and the check fails unless it does by
# more than the tolerance. The kernels are held to the plain versions in
# fp32 as well: at full depth on a 1536-token prefill (1e-2; 2.5e-5
# measured for mamba2) and by equal greedy streams at reduced depth.
BF16_SSM_LOGIT_ATOL = 0.5
# The same for qwen2-moe-a2.7b against the plain attention. Routing is
# discontinuous: a bf16-ulp difference upstream can move a token's router
# probabilities across a near-tie of its 4th and 5th expert, and the
# swapped expert changes that layer's output for that token by order 1
# times its gate, which later layers and later steps (through the KV
# cache) carry on: in the last layers up to half of 31 tokens route to
# another top-4 set. So bf16 rounding alone moves these logits by up to
# 1.96 at some step: the controls, the kernels at batch 1 and the plain
# model at batch 8, read 0.91 to 1.96 against the plain model at batch 1,
# the served streams 0.69 to 2.12 (and each served stream equals its
# prompt run alone). The heavy tail is a few steps: the median step of
# every stream and control reads under 0.5. The planted faults move every
# step: a neighbouring request's KV cache by 7.48 to 7.94 at most and 6.4
# or more at the median step, gates not renormalised by 3.44 to 3.82 and
# 2.78 or more (H100 runs); the check fails unless each fault exceeds both
# tolerances.
BF16_MOE_LOGIT_ATOL = 2.5
BF16_MOE_MEDIAN_STEP_ATOL = 1.0
# The same for whisper-tiny (4 + 4 layers, d 384): served logits read
# 0.039 at most from the plain decode attention over 256 steps, and the
# control, the plain model a row at a time against batch 8, reads 0.031
# (H100 run): bf16 rounding in another place, not the kernel. The bound is
# 3x the larger. The planted fault, a neighbouring row's cross K/V, reads
# 0.445 or more: small because cross-attention over 1500 random frames
# averages them, so two rows' encoder outputs differ little.
BF16_ENCDEC_LOGIT_ATOL = 0.12
# The same for llava-next-34b (60 layers, d 7168): served logits read 0.101
# to 0.106 from the plain decode attention, the control (the kernels at
# batch 1) 0.102 to 0.109, a prefill of 576 patches and 64 tokens 0.141 over
# 8 steps (H100 run); the bound is 3x the largest. A neighbouring request's
# KV cache, planted as a fault, moves them by 6.81 or more.
BF16_VLM_LOGIT_ATOL = 0.4
# fp32: a greedy stream may differ only after a step where the reference's
# top-2 margin is under this (sums in another order, ~1e-6 relative).
FP32_TIE_MARGIN = 1e-3
# Flash attention shapes (name, B, T, S, Hq, Hkv, hd, causal); the first is
# the training shape the train phase runs.
FLASH_SHAPES = [("smollm-135m train", 8, 2048, 2048, 9, 3, 64, True),
                ("llama-3.2-1b", 2, 2048, 2048, 32, 8, 64, True),
                ("llama-3.1-8b hd 128", 1, 2048, 2048, 32, 8, 128, True),
                ("zamba2-2.7b hd 80", 2, 1024, 1024, 32, 32, 80, True),
                ("phi3-mini hd 96", 1, 1024, 1024, 32, 32, 96, True),
                ("kimi-k2 hd 112", 1, 1024, 1024, 64, 8, 112, True),
                ("ragged T 1000", 2, 1000, 1000, 9, 3, 64, True),
                ("T 1", 4, 1, 1, 9, 3, 64, True),
                ("full T != S", 2, 300, 700, 8, 2, 128, False),
                ("smollm-135m fabric train", 4, 32, 32, 9, 3, 64, True),
                ("whisper-tiny decoder train", 8, 448, 448, 6, 6, 64, True),
                ("llava-next-34b 576 patches + 512 text, group 7", 2, 1088,
                 1088, 56, 8, 128, True)]
# Forward and dq, dk, dv against autograd through the plain version.
# fp32: sums in another order only. bf16: both accumulate in fp32 and round
# the results once; the kernel also rounds P and dS to bf16 as tensor-core
# operands and reads the bf16 O in rowsum(dO * O), each a 2^-9 relative
# difference in one term of a sum.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TRAIN_STEPS = 6
TRAIN_B, TRAIN_T = 8, 2048
# Train parity, kernel against the plain attention on the same params and
# batch. fp32 (4 layers, B 2, T 1024): sums in another order only; per leaf
# max |dg| <= 1e-4 of the leaf's max |g|, loss within 1e-5 relative. bf16
# (full config): both paths accumulate attention in fp32 and round O and
# the gradients to bf16 (the kernel P and dS too), so they differ by
# single-ulp flips (2^-8 relative) that 30 layers carry on; the loss (~10.8) may move by 2^-8 of
# itself, 0.04, and each leaf's gradient by 5% in relative L2 norm, where a
# wrong mask, scale or group sum moves it by order 1.
FP32_LOSS_RTOL, FP32_GRAD_TOL = 1e-5, 1e-4
BF16_LOSS_ATOL, BF16_GRAD_RTOL = 0.04, 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def max_err(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Max abs error; raises where |got - want| > tol + tol * |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    if bad.any():
        raise AssertionError(f"{int(bad.sum())} values off by up to "
                             f"{err.max().item():.3e} (tol {tol})")
    return err.max().item()


def eager_ms(fn, n: int) -> float:
    """Mean time of ``fn(i)`` over n calls as the engine pays it: launched
    one by one from Python, so host overhead counts where it exceeds the
    device time."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int) -> float:
    """Mean device time of ``fn(i)``: n calls captured in one CUDA graph and
    replayed, so no host overhead sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def log_dynamic_smem(build) -> None:
    """The dynamic shared memory of the kernels redesigned last (ptxas
    prints only the static part): the wgmma backward's dK/dV and dQ
    kernels, and the SSD scan's passes at the two served SSM shapes."""
    import ctypes
    flash = build.load("flash_attention").repro_flash_bwd_smem
    scan = build.load("ssd_scan").repro_ssd_smem
    for fn in (flash, scan):
        fn.restype = ctypes.c_int
    flash.argtypes = [ctypes.c_int] * 2
    scan.argtypes = [ctypes.c_int] * 3
    for hd in (64, 128):
        log(f"[build] flash_attention wgmma backward hd {hd}: dynamic shared "
            f"memory dK/dV {flash(hd, 0)} B, dQ {flash(hd, 1)} B")
    for name, N, P in (("mamba2-1.3b", 128, 64), ("zamba2-2.7b", 64, 64)):
        log(f"[build] ssd_scan {name} (N {N}, P {P}): dynamic shared memory "
            + ", ".join(f"pass {i} {scan(N, P, i)} B" for i in (1, 2, 4)))


# --------------------------------------------------------------- phase 3 --
def check_and_time_decode_attention(name, Hq, Hkv, hd, L, rng, B=B, S=S,
                                    lengths=None):
    """Kernel against plain on the card in fp32 and bf16, then timings in
    bf16 over L layers of cache (more bytes than the 50 MB L2 holds, as a
    decode step finds them); L = 0 checks only. B slots of S keys; the
    slots' lengths are drawn unless given (the first must be 0)."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ref
    decode_attention = dk.decode_attention
    dev = torch.device(DEV)
    if lengths is None:
        lengths = np.concatenate([[0, 1, S, S + 5],
                                  rng.integers(8, 1533, B - 4)])
    lengths = np.asarray(lengths, np.int32)
    lens = torch.from_numpy(lengths).to(dev)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(dtype)
        kv = torch.randn((2, B, S, Hkv, hd), generator=gen, device=dev
                         ).to(dtype)
        got = decode_attention(q, kv[0], kv[1], lens)
        torch.cuda.synchronize()
        want = ref.decode_attention_ref(q, kv[0], kv[1], lens)
        torch.cuda.synchronize()
        errs[dtype] = max_err(got, want, TOL[dtype])
        if not torch.all(got[0] == 0):
            raise AssertionError("length 0 must give zeros")
        for _ in range(2):
            if not torch.equal(decode_attention(q, kv[0], kv[1], lens), got):
                raise AssertionError("repeated decode_attention calls differ")
    splits, tps = dk.split_plan(B, Hkv, S, dk._sm_count(dev))
    row = {"shape": name, "B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "hd": hd,
           "splits": splits, "tiles_per_split": tps,
           "lengths": lengths.tolist(),
           "max_abs_err_fp32": errs[torch.float32],
           "max_abs_err_bf16": errs[torch.bfloat16]}
    if not L:
        log(f"[kernel] decode_attention check {json.dumps(row)}")
        return row
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    q = torch.randn((L, B, Hq, hd), generator=gen, device=dev
                    ).to(torch.bfloat16)
    k = torch.randn((L, B, S, Hkv, hd), generator=gen, device=dev
                    ).to(torch.bfloat16)
    v = torch.randn((L, B, S, Hkv, hd), generator=gen, device=dev
                    ).to(torch.bfloat16)
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None]
            )[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    calls = {
        "": lambda i: decode_attention(q[i % L], k[i % L], v[i % L], lens),
        "plain_": lambda i: ref.decode_attention_ref(q[i % L], k[i % L],
                                                     v[i % L], lens),
        "library_": lambda i: sdpa(q[i % L][:, :, None],
                                   k[i % L].transpose(1, 2),
                                   v[i % L].transpose(1, 2), attn_mask=mask,
                                   enable_gqa=True)}
    times = {}
    for key, fn in calls.items():
        times[f"{key}ms"] = device_ms(fn, 3 * L)
        times[f"{key}eager_ms"] = eager_ms(fn, 3 * L)
    # the same call on a head-major copy of the cache (each head's keys
    # contiguous), which the kernel reads through its strides: how much the
    # cache's (S, Hkv, hd) layout, a row of hd every Hkv * hd, costs it
    kh, vh = (t.transpose(2, 3).contiguous().transpose(2, 3) for t in (k, v))
    times["head_major_ms"] = device_ms(
        lambda i: decode_attention(q[i % L], kh[i % L], vh[i % L], lens),
        3 * L)
    del kh, vh
    valid = int(np.minimum(lengths, S).sum())
    elt = 2
    nbytes = 2 * valid * Hkv * hd * elt + 2 * B * Hq * hd * elt + 4 * B
    flops = 4 * valid * Hq * hd
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    row.update(times, bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               achieved_gb_per_s=nbytes / times["ms"] / 1e6)
    log(f"[kernel] decode_attention {json.dumps(row)}")
    return row


# ----------------------------------------------------------- phases 4, 11 --
def prompt_lengths(cfg, rng):
    """16 served prompt lengths; [1] and [3] are the long and the short
    stream that ``parity_bf16`` checks. The SSM families take at most one
    chunk (256) or a multiple of it, as the reference asserts."""
    if cfg.family in ("dense", "moe", "vlm"):
        return np.concatenate([[8, 1500, 1024, 300],
                               rng.integers(8, 1500, 12)])
    return np.concatenate([[8, 1536, 1024, 256, 512],
                           rng.integers(9, 256, 11)])


def plain_model(cfg):
    """The family's model with the plain versions at every kernel seam."""
    from repro_torch.kernels import ref
    from repro_torch.models.transformer import (DenseLM, EncDecLM, HybridLM,
                                                MambaLM, MoELM)
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        lm = {"moe": MoELM, "encdec": EncDecLM}.get(cfg.family, DenseLM)
        return lm(cfg, device=DEV, decode_attention=ref.decode_attention_ref)
    if cfg.family == "ssm":
        return MambaLM(cfg, device=DEV, ssd_scan=ref.ssd_scan_ref)
    return HybridLM(cfg, device=DEV, ssd_scan=ref.ssd_scan_ref,
                    decode_attention=ref.decode_attention_ref)


def launch_counts(reset: bool = False) -> dict:
    """The serving kernels' launch counts, set to 0 first if ``reset``."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ssd_scan as sk
    counters = {"decode_attention": dk.decode_attention,
                "ssd_scan": sk.ssd_scan_fwd}
    if reset:
        for fn in counters.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in counters.items()}


def fabric_launches(reset: bool = False) -> dict:
    """The fabric executor's kernels' launch counts (the decode kernel, the
    flash forward and backward), set to 0 first if ``reset``; raises on a
    read where one of them did not launch."""
    from repro_torch.kernels import flash_attention as fk
    if reset:
        launch_counts(reset=True)
        fk.flash_attention_fwd.launches = 0
        fk.flash_attention_bwd.launches = 0
        return {}
    launches = {"decode_attention": launch_counts()["decode_attention"],
                "flash_attention_fwd": fk.flash_attention_fwd.launches,
                "flash_attention_bwd": fk.flash_attention_bwd.launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel did not run in the fabric: "
                             f"{launches}")
    return launches


@contextlib.contextmanager
def recording_routing(sink: list):
    """While open, every MoE layer's top-k expert ids, (B, T, k) sorted
    along k, are appended to ``sink`` (the model module's ``moe_block`` is
    wrapped; the ids are those ``moe_block`` computes)."""
    from repro_torch.models import ffn
    from repro_torch.models import transformer as tm
    block = tm.moe_block

    def recorded(p, x, cfg):
        _, _, ids = ffn.route(p, x.reshape(1, -1, x.shape[-1]), cfg)
        sink.append(ids.reshape(*x.shape[:2], -1).sort(dim=-1).values)
        return block(p, x, cfg)

    tm.moe_block = recorded
    try:
        yield sink
    finally:
        tm.moe_block = block


def serve_full_width(cfg, rng):
    """Serves 16 requests at full width in bf16. Returns the model, its
    params, the requests, each decode step's logits with the slot map it
    ran under (and for MoE its top-k expert ids by layer, (L, B, 1, k);
    else None), and the kernels' launches in the run: ``decode_attention``
    on every attention layer of every decode step, ``ssd_scan`` on every
    SSM layer of every prefill."""
    from repro_torch.models.transformer import build_model
    from repro_torch.serve.engine import Request, ServingEngine
    model = build_model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    lens = prompt_lengths(cfg, rng)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]

    warm = ServingEngine(model, params, n_slots=B, max_len=S, seed=SEED)
    warm.run([Request(prompts[0], max_new_tokens=4),
              Request(prompts[2], max_new_tokens=4)])
    del warm          # its cache, 4.03 GB at llava-next-34b, before eng's

    eng = ServingEngine(model, params, n_slots=B, max_len=S, seed=SEED)
    records, finite = [], torch.ones((), dtype=torch.bool, device=DEV)
    plain_decode = model.decode
    routing = []

    def recording_decode(p, tokens, cache):
        nonlocal finite
        routing.clear()                          # drops the prefills' ids
        logits, cache = plain_decode(p, tokens, cache)
        finite = finite & torch.isfinite(logits).all()
        records.append(({s: r.req_id for s, r in eng.active.items()},
                        logits[:, -1].clone(),
                        torch.stack(routing) if routing else None))
        return logits, cache

    model.decode = recording_decode
    reqs = [Request(p, max_new_tokens=32, tenant=f"tenant-{i % 4}")
            for i, p in enumerate(prompts)]
    launch_counts(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (recording_routing(routing) if cfg.family == "moe"
          else contextlib.nullcontext()):
        for r in reqs[:-1]:
            eng.submit(r)
        done = eng.step()
        eng.submit(reqs[-1])                     # arrives mid-flight
        while eng.waiting or eng.active:
            done.extend(eng.step())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    model.decode = plain_decode

    if len(done) != len(reqs) or not all(r.done for r in reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    if not bool(finite):
        raise AssertionError("non-finite logits in a served decode step")
    attn_layers = {"dense": cfg.n_layers, "moe": cfg.n_layers,
                   "vlm": cfg.n_layers, "ssm": 0,
                   "hybrid": cfg.n_layers // max(cfg.attn_every, 1)}
    want = {"decode_attention": attn_layers[cfg.family] * eng.steps,
            "ssd_scan": cfg.n_layers * len(reqs)
            if cfg.family in ("ssm", "hybrid") else 0}
    if launches != want or eng.steps == 0:
        raise AssertionError(f"launches {launches} in {eng.steps} steps and "
                             f"{len(reqs)} prefills, want {want}")
    stats = {"arch": cfg.name, "requests": len(done),
             "routing_recorded": cfg.family == "moe",
             "prompt_tokens": int(lens.sum()),
             "tokens_generated": eng.tokens_generated,
             "engine_steps": eng.steps, "wall_s": wall,
             "tok_per_s": eng.tokens_generated / wall,
             "mean_occupancy": eng.tokens_generated / (eng.steps * B),
             **{f"{k}_launches": v for k, v in launches.items()}}
    log(f"[serve] {json.dumps(stats)}")
    return model, params, reqs, records, launches


def device_kernels(prof, per: int) -> list:
    """(name, calls, device ms) of every CUDA kernel in a profile, per
    ``per`` repetitions, largest first."""
    kernels = [(e.key, e.count / per, e.self_device_time_total / per / 1e3)
               for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    return sorted(kernels, key=lambda k: -k[2])


def where_the_time_goes(model, params, rng, n_steps=10):
    """Decode steps of a full engine by host clock, then the same number of
    steps under the profiler for device busy time by kernel; prefill time
    of one request at a few prompt lengths, and the longest prefill under
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request, ServingEngine
    cfg = model.cfg
    if cfg.family in ("dense", "moe", "vlm"):
        lens, prefill_lens = (8, 1500, 1024, 300, 500, 700, 900, 100), \
            (1500, 1024, 300)
    else:
        lens, prefill_lens = (8, 1536, 1024, 256, 512, 100, 200, 37), \
            (1536, 1024, 256)
    eng = ServingEngine(model, params, n_slots=B, max_len=S, seed=SEED)
    for n in lens:
        eng.submit(Request(rng.integers(0, cfg.vocab_size, n)
                           .astype(np.int32), max_new_tokens=4 * n_steps))
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_steps * 1e3
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    rows = [eng.cache["index"].clamp(max=S).sum().item()]
    with profile(activities=activities) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    rows.append(eng.cache["index"].clamp(max=S).sum().item())
    kernels = device_kernels(prof, n_steps)
    busy_ms = sum(ms for _, _, ms in kernels)
    prefill_ms = {}
    for n in prefill_lens:
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, n),
                                 device=DEV)[None]
        cache = model.init_cache(1, S)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
        prefill_ms[n] = (time.perf_counter() - t0) * 1e3
    n = prefill_lens[0]
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, n),
                             device=DEV)[None]
    cache = model.init_cache(1, S)
    with profile(activities=activities) as prof:
        model.prefill(params, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
    prefill_kernels = device_kernels(prof, 1)
    stats = {"arch": cfg.name, "decode_step_ms": step_ms,
             "kv_rows": sum(rows) / 2,     # cached rows a profiled step reads
             "device_busy_ms_per_step": busy_ms,
             "device_idle_share": 1 - busy_ms / step_ms,
             "top_kernels_per_step": [[name[:60], calls, ms]
                                      for name, calls, ms in kernels[:6]],
             "prefill_ms": prefill_ms,
             f"prefill_{n}_device_busy_ms":
                 sum(ms for _, _, ms in prefill_kernels),
             f"prefill_{n}_ssd_scan_ms":
                 sum(ms for name, _, ms in prefill_kernels if "ssd_" in name),
             "prefill_top_kernels": [[name[:60], calls, ms] for
                                     name, calls, ms in prefill_kernels[:4]]}
    log(f"[profile] {json.dumps(stats)}")
    return stats


# ----------------------------------------------------------- phases 5, 13 --
def teacher_forced_logits(model, params, prompt, generated,
                          state_from=None):
    """(n - 1, V) logits of the decode steps of one stream of n tokens, fed
    its own tokens, on a one-slot cache. ``state_from``, another prompt,
    plants a fault: the SSM state its prefill leaves (without one, its KV
    cache) replaces the stream's own before the first decode step, as a
    slot mix-up would."""
    from repro_torch.models.common import tree_leaves
    cache = model.init_cache(1, S)
    tokens = torch.as_tensor(np.asarray(prompt, np.int64), device=DEV)
    _, cache = model.prefill(params, {"tokens": tokens[None]}, cache)
    if state_from is not None:
        other = torch.as_tensor(np.asarray(state_from, np.int64), device=DEV)
        _, wrong = model.prefill(params, {"tokens": other[None]},
                                 model.init_cache(1, S))
        names = ["state"] if "state" in cache else ["k", "v"]
        for leaf, bad in zip(tree_leaves([cache[n] for n in names]),
                             tree_leaves([wrong[n] for n in names])):
            leaf.copy_(bad)
    out = []
    for tok in generated[:-1]:
        logits, cache = model.decode(
            params, torch.tensor([[tok]], device=DEV), cache)
        out.append(logits[0, -1])
    return torch.stack(out)


def teacher_forced_batch(model, params, streams):
    """(len(streams), n - 1, V): the decode-step logits of streams of n
    tokens each, (prompt, generated), side by side in one cache of
    ``len(streams)`` slots, each slot fed its own tokens: a served batch
    without the engine's arrivals and departures."""
    from repro_torch.serve.engine import ServingEngine
    eng = ServingEngine(model, params, n_slots=len(streams), max_len=S)
    for slot, (prompt, _) in enumerate(streams):
        eng._prefill(prompt, slot)
    toks = torch.tensor([g[:-1] for _, g in streams], device=DEV)
    cache, out = eng.cache, []
    for t in range(toks.shape[1]):
        logits, cache = model.decode(params, toks[:, t:t + 1], cache)
        out.append(logits[:, -1])
    return torch.stack(out, dim=1)


@contextlib.contextmanager
def unnormalised_gates():
    """A planted fault while open: ``moe_block`` weights each expert by its
    raw softmax probability, its top-k gates not renormalised to sum 1."""
    from repro_torch.models import ffn
    route = ffn.route

    def raw(p, xt, cfg):
        probs = torch.softmax(xt.float() @ p.router, dim=-1)
        gates, expert_ids = torch.topk(probs, cfg.top_k, dim=-1)
        return probs, gates, expert_ids

    ffn.route = raw
    try:
        yield
    finally:
        ffn.route = route


def parity_bf16(model, params, reqs, records):
    """Served logits (batch of 8, kernels) against the same stream
    teacher-forced at batch 1 with the plain versions. For the SSM families
    also controls, each against the plain versions at batch 1: the kernels
    at batch 1, the sequential scan, for the hybrid the plain scan with the
    decode attention kernel; and a planted fault, a neighbouring request's
    SSM state, which the check must catch. For MoE the count of tokens, by
    layer, whose top-k experts differ between the served and the
    teacher-forced plain path, controls (the kernels at batch 1, the plain
    model at batch 8 beside seven other streams) and two planted faults (a
    neighbouring request's KV cache, gates not renormalised). For vlm a
    control (the kernels at batch 1) and a planted fault (a neighbouring
    request's KV cache)."""
    cfg = model.cfg
    plain = plain_model(cfg)
    tol = {"dense": BF16_LOGIT_ATOL, "moe": BF16_MOE_LOGIT_ATOL,
           "vlm": BF16_VLM_LOGIT_ATOL}.get(cfg.family, BF16_SSM_LOGIT_ATOL)
    # MoE: the median step's max |dlogit| as well (routing flips make a
    # heavy tail of a few steps)
    step_tol = BF16_MOE_MEDIAN_STEP_ATOL if cfg.family == "moe" else None

    def forced(m, req, **kw):
        return teacher_forced_logits(m, params, req.prompt, req.generated,
                                     **kw)

    controls, faults = {}, {}
    if cfg.family in ("ssm", "hybrid"):
        from repro_torch.kernels import ref
        from repro_torch.models.transformer import HybridLM
        # the plain model with the scan summed in the sequential order: how
        # far an fp32 reordering of the scan alone moves bf16 logits
        sequential = plain_model(cfg)
        sequential.ssd_scan = lambda u, loga, Bm, Cm, *, chunk, h0=None: \
            ref.ssd_ref(u, loga, Bm, Cm, h0=h0)
        models = {"kernels at batch 1": model,
                  "sequential scan": sequential}
        if cfg.family == "hybrid":
            models["plain scan, decode_attention kernel"] = HybridLM(
                cfg, device=DEV, ssd_scan=ref.ssd_scan_ref)
        controls = {name: lambda req, m=m: forced(m, req)
                    for name, m in models.items()}
        faults["state"] = lambda req, nb: forced(plain, req,
                                                 state_from=nb.prompt)
    elif cfg.family == "vlm":
        controls["kernels at batch 1"] = lambda req: forced(model, req)
        faults["KV cache"] = lambda req, nb: forced(plain, req,
                                                    state_from=nb.prompt)
    elif cfg.family == "moe":
        controls["kernels at batch 1"] = lambda req: forced(model, req)
        controls["plain at batch 8"] = lambda req: teacher_forced_batch(
            plain, params, [(r.prompt, r.generated) for r in
                            [req] + [r for r in reqs if r is not req][
                                :B - 1]])[0]
        faults["KV cache"] = lambda req, nb: forced(plain, req,
                                                    state_from=nb.prompt)

        def unnormalised(req, nb):
            with unnormalised_gates():
                return forced(plain, req)
        faults["gates not renormalised"] = unnormalised
    worst, fault_least, checked = 0.0, float("inf"), 0
    fault_median_least = float("inf")
    flips_total = np.zeros(cfg.n_layers, np.int64)
    for i in (1, 3, len(reqs) - 1):              # long, short, mid-flight
        req = reqs[i]
        mine = [(lg[req.slot], ids) for slots, lg, ids in records
                if slots.get(req.slot) == req.req_id]
        served = torch.stack([lg for lg, _ in mine]).float()
        sink = []
        with (recording_routing(sink) if cfg.family == "moe"
              else contextlib.nullcontext()):
            want = forced(plain, req).float()
        if served.shape != want.shape:
            raise AssertionError(f"{served.shape} served steps, "
                                 f"{want.shape} teacher-forced")
        err = (served - want).abs().amax(dim=-1)
        top2 = want.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        agree = served.argmax(-1) == want.argmax(-1)
        readings = ""
        median = lambda e: f" (median step {e.median().item():.4f})" \
            if step_tol else ""
        for name, fn in controls.items():
            e = (fn(req).float() - want).abs().amax(dim=-1)
            readings += f", {name} {e.max().item():.4f}{median(e)}"
        neighbour = reqs[(i + 1) % len(reqs)]
        for name, fn in faults.items():
            e = (served - fn(req, neighbour).float()).abs().amax(dim=-1)
            fault_least = min(fault_least, e.max().item())
            fault_median_least = min(fault_median_least,
                                     e.median().item())
            what = f"req {neighbour.req_id}'s {name}" \
                if name in ("state", "KV cache") else name
            readings += f"; planted fault ({what}) {e.max().item():.4f}" \
                f"{median(e)}"
        if cfg.family == "moe":
            # the prefill's L entries first, then L a decode step
            L = cfg.n_layers
            forced_ids = torch.stack(sink[L:]).reshape(-1, L, cfg.top_k)
            served_ids = torch.stack([ids[:, req.slot, 0]
                                      for _, ids in mine])
            flips = (served_ids != forced_ids).any(-1).sum(0).cpu().numpy()
            flips_total += flips
            readings += (f"; tokens whose top-{cfg.top_k} experts differ, "
                         f"by layer {flips.tolist()}")
        log(f"[parity bf16] {cfg.name} req {req.req_id} prompt "
            f"{len(req.prompt)}: max |dlogit| {err.max().item():.4f}"
            f"{median(err)}, argmax "
            f"agrees {int(agree.sum())}/{len(agree)}, min margin "
            f"{margin.min().item():.4f}{readings}")
        if err.max().item() > tol:
            raise AssertionError(f"bf16 logits off by {err.max().item()}")
        if step_tol and err.median().item() > step_tol:
            raise AssertionError(f"bf16 logits off by {err.median().item()}"
                                 f" at the median step")
        if not bool(agree[margin > tol].all()):
            raise AssertionError("argmax differs where the margin exceeds "
                                 "the tolerance")
        worst, checked = max(worst, err.max().item()), checked + len(err)
    log(f"[parity bf16] {cfg.name}: {checked} teacher-forced steps, max "
        f"|dlogit| {worst:.4f} (tol {tol}"
        + (f", median step tol {step_tol}" if step_tol else "") + ")"
        + (f", planted fault at least {fault_least:.4f}" if faults else "")
        + (f", tokens with other top-{cfg.top_k} experts by layer "
           f"{flips_total.tolist()} of {checked} a layer"
           if cfg.family == "moe" else ""))
    if faults and fault_least <= tol:
        raise AssertionError(f"a planted fault moved logits by only "
                             f"{fault_least} (tol {tol}): the check cannot "
                             f"see it")
    if step_tol and fault_median_least <= step_tol:
        raise AssertionError(f"a planted fault moved the median step's "
                             f"logits by only {fault_median_least} (tol "
                             f"{step_tol}): the check cannot see it")


def prefill_fp32_full_depth(cfg, rng):
    """One fp32 prefill of 1536 tokens at full depth, with the kernels and
    with the plain versions: logits and every SSM state. The two sum in
    another order only (~1e-6 relative a layer); a wrong scan or state
    moves them by order 1."""
    from repro_torch.models.transformer import build_model
    cfg32 = replace(cfg, param_dtype=torch.float32,
                    compute_dtype=torch.float32)
    model, plain = build_model(cfg32, device=DEV), plain_model(cfg32)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, 1536),
                             device=DEV)[None]
    got, cache = model.prefill(params, {"tokens": tokens},
                               model.init_cache(1, S))
    want, want_cache = plain.prefill(params, {"tokens": tokens},
                                     plain.init_cache(1, S))
    stats = {"arch": cfg.name, "layers": cfg.n_layers,
             "logits_err": max_err(got, want, 1e-2),
             "ssm_state_err": max_err(cache["state"].ssm,
                                      want_cache["state"].ssm, 1e-2),
             "logits_max": want.abs().max().item()}
    log(f"[parity fp32 prefill] {json.dumps(stats)}")


def parity_fp32(cfg, rng, n_layers=None):
    """fp32 engine streams at ``n_layers`` (all by default) against the
    sequential single-request reference with the plain versions."""
    from repro_torch.models.transformer import build_model
    from repro_torch.serve.engine import Request, ServingEngine
    cfg32 = replace(cfg, param_dtype=torch.float32,
                    compute_dtype=torch.float32,
                    n_layers=n_layers or cfg.n_layers)
    model = build_model(cfg32, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    plain = plain_model(cfg32)
    lens = (8, 1100, 400, 57, 700) if cfg.family in ("dense", "moe",
                                                     "vlm") else \
        (8, 1024, 256, 57, 512)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    reqs = [Request(p, max_new_tokens=16) for p in prompts]
    ServingEngine(model, params, n_slots=4, max_len=S).run(reqs)
    equal = 0
    for req in reqs:
        # the sequential reference: greedy on the plain model, step by step
        want, cache = [], plain.init_cache(1, S)
        logits, cache = plain.prefill(params, {"tokens": torch.as_tensor(
            req.prompt.astype(np.int64), device=DEV)[None]}, cache)
        for _ in range(req.max_new_tokens):
            row = logits[0, -1]
            top2 = row.topk(2).values
            want.append((int(row.argmax()), (top2[0] - top2[1]).item()))
            if len(want) == req.max_new_tokens:
                break
            logits, cache = plain.decode(params, torch.tensor(
                [[want[-1][0]]], device=DEV), cache)
        for i, (tok, margin) in enumerate(want):
            if req.generated[i] != tok:
                if margin < FP32_TIE_MARGIN:
                    log(f"[parity fp32] req {req.req_id}: near-tie at step "
                        f"{i} (margin {margin:.2e}); compared up to it")
                    break
                raise AssertionError(
                    f"fp32 stream differs at step {i}: {req.generated} vs "
                    f"{[t for t, _ in want]} (margin {margin:.3e})")
        else:
            equal += 1
    log(f"[parity fp32] {cfg.name} at {cfg32.n_layers} layers: {equal}/"
        f"{len(reqs)} greedy streams equal the sequential reference with the "
        "plain versions")


# --------------------------------------------------------------- phase 7 --
def flash_inputs(B, T, S, Hq, Hkv, hd, dtype, seed):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device=DEV
                                   ).to(dtype)
    return r(B, T, Hq, hd), r(B, S, Hkv, hd), r(B, S, Hkv, hd), \
        r(B, T, Hq, hd)


def check_flash_attention():
    """Forward against the plain version, dq/dk/dv against autograd
    through it, fp32 and bf16, at every shape of FLASH_SHAPES."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    rows = []
    for i, (name, B, T, S, Hq, Hkv, hd, causal) in enumerate(FLASH_SHAPES):
        row = {"shape": name, "B": B, "T": T, "S": S, "Hq": Hq, "Hkv": Hkv,
               "hd": hd, "causal": causal,
               "bf16_fwd_route": fk.fwd_route(torch.bfloat16, hd),
               "bf16_bwd_route": fk.bwd_route(torch.bfloat16, hd)}
        for dtype, key in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            if fk.library_fwd_route(dtype, hd) != fk.fwd_route(dtype, hd) \
                    or fk.library_bwd_route(dtype, hd) != \
                    fk.bwd_route(dtype, hd):
                raise AssertionError(f"route table of the library and of "
                                     f"the wrapper differ at {dtype} {hd}")
            q, k, v, do = flash_inputs(B, T, S, Hq, Hkv, hd, dtype, SEED + i)
            out, lse = fk.flash_attention_fwd(q, k, v, causal)
            grads = fk.flash_attention_bwd(q, k, v, out, lse, do, causal)
            again, again_lse = fk.flash_attention_fwd(q, k, v, causal)
            if not (torch.equal(again, out) and torch.equal(again_lse, lse)):
                raise AssertionError("repeated flash forwards differ")
            torch.cuda.synchronize()
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            want = ref.flash_attention_ref(*leaves, causal=causal)
            want.backward(do)
            torch.cuda.synchronize()
            row[f"fwd_err_{key}"] = max_err(out, want, TOL[dtype])
            row[f"bwd_err_{key}"] = max(
                max_err(g, w.grad, GRAD_TOL[dtype])
                for g, w in zip(grads, leaves))
        log(f"[kernel] flash_attention check {json.dumps(row)}")
        rows.append(row)
    return rows


def bwd_kernel_ms(bwd, n: int) -> dict:
    """Device ms a call of each backward kernel (delta pre-pass, dK/dV,
    dQ), from the profiler over n eager backward launches."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            bwd(i)
        torch.cuda.synchronize()
    parts = {"delta": "delta", "dkdv": "dkdv", "dq": "_dq_"}
    return {part: sum(ms for name, _, ms in device_kernels(prof, n)
                      if key in name) for part, key in parts.items()}


def time_flash_attention():
    """Kernel, plain version and SDPA at the training shape in bf16:
    forward, forward + backward (autograd) and, for the kernel, the
    backward launch alone. The backward of the plain version and of SDPA
    is their forward + backward less their forward."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    _, B, T, S, Hq, Hkv, hd, _ = FLASH_SHAPES[0]
    q, k, v, do = flash_inputs(B, T, S, Hq, Hkv, hd, torch.bfloat16, SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    impls = {
        "": (lambda q, k, v: fk.flash_attention(q, k, v), do),
        "plain_": (lambda q, k, v: ref.flash_attention_ref(q, k, v,
                                                           causal=True), do),
        "library_": (lambda q, k, v: sdpa(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True), do.transpose(1, 2))}
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    times = {}
    for key, (f, grad_out) in impls.items():
        fwd = lambda i, f=f: f(q, k, v)
        both = lambda i, f=f, g=grad_out: torch.autograd.grad(
            f(*leaves), leaves, g)
        times[f"{key}fwd_ms"] = device_ms(fwd, 10)
        times[f"{key}fwd_eager_ms"] = eager_ms(fwd, 10)
        times[f"{key}fwd_bwd_ms"] = device_ms(both, 5)
        times[f"{key}fwd_bwd_eager_ms"] = eager_ms(both, 5)
        times[f"{key}bwd_ms"] = times[f"{key}fwd_bwd_ms"] - \
            times[f"{key}fwd_ms"]
    out, lse = fk.flash_attention_fwd(q, k, v, True)
    bwd = lambda i: fk.flash_attention_bwd(q, k, v, out, lse, do, True)
    times["bwd_ms"] = device_ms(bwd, 5)
    times["bwd_eager_ms"] = eager_ms(bwd, 5)
    times["bwd_kernel_ms"] = bwd_kernel_ms(bwd, 5)
    elt = 2
    io = (2 * B * T * Hq * hd + 2 * B * S * Hkv * hd) * elt   # q, k, v, out
    flops = 4 * B * Hq * hd * T * (T + 1) // 2
    bounds = {}
    for key, nbytes, ops in (
            ("fwd", io + 4 * B * Hq * T, flops),
            # reads q, k, v, out, dout, lse; writes dq, dk, dv
            ("bwd", 2 * io + B * T * Hq * hd * elt + 4 * B * Hq * T,
             2.5 * flops)):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / BF16_FLOPS_PER_S * 1e3
        bounds[f"{key}_bound_ms"] = max(bytes_ms, ops_ms)
        bounds[f"{key}_bound_by"] = "bytes" if bytes_ms >= ops_ms \
            else "operations"
    row = {"shape": FLASH_SHAPES[0][0],
           "fwd_route": fk.fwd_route(torch.bfloat16, hd),
           "bwd_route": fk.bwd_route(torch.bfloat16, hd), **times, **bounds,
           "fwd_tflop_per_s": flops / times["fwd_ms"] / 1e9,
           "bwd_tflop_per_s": 2.5 * flops / times["bwd_ms"] / 1e9}
    log(f"[kernel] flash_attention timing {json.dumps(row)}")
    return row


# --------------------------------------------------------------- phase 8 --
def train_full_width(cfg):
    """``launch.train`` at full width; returns the run's result and the
    flash kernels' launches in it."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.launch import train
    torch.cuda.reset_peak_memory_stats()
    fk.flash_attention_fwd.launches = 0
    fk.flash_attention_bwd.launches = 0
    result = train.main(["--arch", cfg.name, "--steps", str(TRAIN_STEPS),
                         "--batch", str(TRAIN_B), "--seq", str(TRAIN_T),
                         "--lr", "3e-3", "--warmup", "2", "--ckpt-every",
                         "0", "--log-every", "1", "--seed", str(SEED)])
    launches = (fk.flash_attention_fwd.launches,
                fk.flash_attention_bwd.launches)
    losses = result["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    # remat="block" runs every layer's forward again in the backward
    passes = 2 if cfg.remat == "block" else 1
    want = (passes * cfg.n_layers * TRAIN_STEPS, cfg.n_layers * TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"flash_attention launches (fwd, bwd) "
                             f"{launches}, want {want}")
    step_ms = float(np.mean(result["step_s"][1:])) * 1e3
    stats = {"arch": cfg.name, "batch": TRAIN_B, "seq": TRAIN_T,
             "steps": TRAIN_STEPS, "step_ms_after_first": step_ms,
             "median_step_ms_after_first":
                 float(np.median(result["step_s"][1:])) * 1e3,
             "first_step_ms": result["step_s"][0] * 1e3,
             "tokens_per_s": TRAIN_B * TRAIN_T / step_ms * 1e3,
             "losses": losses, "grad_norms": result["grad_norms"],
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "flash_fwd_launches": launches[0],
             "flash_bwd_launches": launches[1]}
    log(f"[train] {json.dumps(stats)}")
    return stats, launches


def fresh_training(cfg, flash_attention=None):
    from repro_torch.models.transformer import DenseLM
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import OptimizerConfig, build_optimizer
    from repro_torch.train.train_step import (build_train_step,
                                              init_train_state)
    kw = {} if flash_attention is None else \
        {"flash_attention": flash_attention}
    model = DenseLM(cfg, device=DEV, **kw)
    opt = build_optimizer(OptimizerConfig(peak_lr=3e-3, warmup=2,
                                          total_steps=100))
    state = init_train_state(model, opt, torch.Generator(device=DEV)
                             .manual_seed(SEED))
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_T, TRAIN_B,
                                  seed=SEED), device=DEV)
    return model, state, build_train_step(model, opt), data


def profile_train_step(cfg, step_ms):
    """One train step under the profiler: device busy time by kernel
    against the step time of the train phase (host clock)."""
    from torch.profiler import ProfilerActivity, profile
    _, state, step, data = fresh_training(cfg)
    for i in range(2):
        state, m = step(state, data.batch(i))
        float(m["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = step(state, data.batch(2))
        float(m["loss"])
        torch.cuda.synchronize()
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy_ms = sum(ms for _, _, ms in kernels)
    top = sorted(kernels, key=lambda k: -k[2])[:8]
    flash = {part: sum(ms for name, _, ms in kernels if f"flash_{part}" in name)
             for part in ("fwd", "delta", "dkdv", "dq")}
    stats = {"train_step_ms": step_ms, "device_busy_ms_per_step": busy_ms,
             "device_idle_share": 1 - busy_ms / step_ms,
             "flash_ms_per_step": flash,
             "top_kernels_per_step": [[name[:80], calls, ms]
                                      for name, calls, ms in top]}
    log(f"[profile train] {json.dumps(stats)}")


# --------------------------------------------------------------- phase 9 --
def train_parity(cfg, n_layers=4, bf16=True, B=2, T=1024):
    """One step's loss and gradients, kernel against plain attention: fp32
    at ``n_layers`` on B x T tokens, then bf16 at the full config if
    ``bf16``. The enc-dec batch adds seeded frames (B, enc_len, d), the
    vlm batch seeded patch embeddings (B, n_patches, d) before the text.
    Returns the flash kernels' launches (forward, backward) in the
    phase."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import DenseLM, EncDecLM, MoELM
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.train_step import value_and_grad
    lm = {"moe": MoELM, "encdec": EncDecLM}.get(cfg.family, DenseLM)
    extra = {"encdec": ("frames", cfg.enc_len),
             "vlm": ("patch_embeds", cfg.n_patches)}.get(cfg.family)
    fk.flash_attention_fwd.launches = 0
    fk.flash_attention_bwd.launches = 0
    cfg32 = replace(cfg, n_layers=n_layers, param_dtype=torch.float32,
                    compute_dtype=torch.float32)
    cases = [("fp32", cfg32, B, T)]
    if bf16:
        cases.append(("bf16", cfg, TRAIN_B, TRAIN_T))
    for label, c, B, T in cases:
        model = lm(c, device=DEV)
        plain = lm(c, device=DEV, flash_attention=ref.flash_attention_ref)
        params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
        batch = SyntheticLM(DataConfig(c.vocab_size, T, B, seed=SEED + 1),
                            device=DEV).batch(0)
        if extra:
            name, n = extra
            batch[name] = torch.randn(
                (B, n, c.d_model), device=DEV, generator=torch.Generator(
                    device=DEV).manual_seed(SEED + 2)).to(c.compute_dtype)
        loss, grads = value_and_grad(model.loss_fn, params, batch)
        want_loss, want = value_and_grad(plain.loss_fn, params, batch)
        dloss = abs(float(loss) - float(want_loss))
        worst = 0.0
        for g, w in zip(tree_leaves(grads), tree_leaves(want)):
            g, w = g.float(), w.float()
            if label == "fp32":
                err = ((g - w).abs().max() / w.abs().max()).item()
            else:
                err = ((g - w).norm() / w.norm()).item()
            worst = max(worst, err)
        stats = {"arch": c.name, "dtype": label, "layers": c.n_layers,
                 "B": B, "T": T, **({extra[0]: extra[1]} if extra else {}),
                 "loss": float(loss), "plain_loss": float(want_loss),
                 "abs_dloss": dloss, "worst_leaf_grad_err": worst}
        log(f"[parity train] {json.dumps(stats)}")
        if label == "fp32" and (dloss > FP32_LOSS_RTOL * abs(float(want_loss))
                                or worst > FP32_GRAD_TOL):
            raise AssertionError(f"fp32 train parity off: {stats}")
        if label == "bf16" and (dloss > BF16_LOSS_ATOL
                                or worst > BF16_GRAD_RTOL):
            raise AssertionError(f"bf16 train parity off: {stats}")
        del model, plain, params, grads, want
    return fk.flash_attention_fwd.launches, fk.flash_attention_bwd.launches


def deterministic_runs(cfg):
    """Two identical 2-step runs: bit-identical losses and grad norms."""
    runs = []
    for _ in range(2):
        _, state, step, data = fresh_training(cfg)
        run = []
        for i in range(2):
            state, m = step(state, data.batch(i))
            run.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append(run)
        del state
    if runs[0] != runs[1]:
        raise AssertionError(f"two identical runs differ: {runs}")
    log(f"[parity train] two 2-step runs bit-identical: {runs[0]}")


# -------------------------------------------------------------- phase 10 --
# (name, B, T, H, P, N, Q, h0): the prefill shapes of the two served
# families first, the timed one at [0]; then a single chunk of 37 tokens at
# B 8, an initial state over several chunks, the sweep of
# tests/test_kernels.py:130-135.
SSD_SHAPES = [("mamba2-1.3b prefill", 1, 2048, 64, 64, 128, 256, False),
              ("zamba2-2.7b prefill", 1, 2048, 80, 64, 64, 256, False),
              ("single chunk T 37", 8, 37, 64, 64, 128, 37, False),
              ("h0, 3 chunks", 2, 768, 64, 64, 128, 256, True),
              ("sweep 1", 1, 32, 2, 16, 8, 8, False),
              ("sweep 2", 2, 64, 3, 16, 8, 16, False),
              ("sweep 3", 1, 128, 4, 32, 16, 32, False),
              ("sweep 4", 2, 64, 1, 64, 64, 64, False)]
# fp32 against the chunked plain version: the same products summed in
# another order; against the sequential recurrence the state gets 1e-3, as
# tests/test_kernels.py:148 allows.
SSD_TOL, SSD_STATE_TOL = 2e-4, 1e-3


def ssd_inputs(B, T, H, P, N, h0, seed):
    """The reference test's distributions: u ~ 0.5 N, loga ~ -U(0, 0.5),
    B and C ~ 0.3 N, h0 ~ N."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device=DEV)
    loga = -0.5 * torch.rand((B, T, H), generator=gen, device=DEV)
    return (0.5 * r(B, T, H, P), loga, 0.3 * r(B, T, N), 0.3 * r(B, T, N),
            r(B, H, N, P) if h0 else None)


def check_ssd_scan():
    """The kernel against the chunked plain version and the sequential
    recurrence at every shape of SSD_SHAPES; chunk 64 against chunk 256."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    rows = []
    for i, (name, B, T, H, P, N, Q, h0) in enumerate(SSD_SHAPES):
        u, loga, Bm, Cm, init = ssd_inputs(B, T, H, P, N, h0, SEED + i)
        y, state = ssd_scan(u, loga, Bm, Cm, chunk=Q, h0=init)
        torch.cuda.synchronize()
        y_c, s_c = ref.ssd_scan_ref(u, loga, Bm, Cm, chunk=Q, h0=init)
        y_s, s_s = ref.ssd_ref(u, loga, Bm, Cm, h0=init)
        row = {"shape": name, "B": B, "T": T, "H": H, "P": P, "N": N,
               "chunk": Q, "h0": h0,
               "y_err_chunked": max_err(y, y_c, SSD_TOL),
               "state_err_chunked": max_err(state, s_c, SSD_TOL),
               "y_err_sequential": max_err(y, y_s, SSD_TOL),
               "state_err_sequential": max_err(state, s_s, SSD_STATE_TOL)}
        if i == 0:
            y64, s64 = ssd_scan(u, loga, Bm, Cm, chunk=64, h0=init)
            row["chunk_64_vs_256_y_err"] = max_err(y64, y, SSD_TOL)
            row["chunk_64_vs_256_state_err"] = max_err(s64, state, SSD_TOL)
        log(f"[kernel] ssd_scan check {json.dumps(row)}")
        rows.append(row)
    return rows


def time_ssd_scan(index: int):
    """Kernel and chunked plain version at SSD_SHAPES[index] (a served
    prefill shape), with the device ms of each of the kernel's passes. No
    single PyTorch call computes the scan, so there is no library time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_plan, ssd_scan
    name, B, T, H, P, N, Q, _ = SSD_SHAPES[index]
    u, loga, Bm, Cm, _ = ssd_inputs(B, T, H, P, N, False, SEED)
    calls = {"": lambda i: ssd_scan(u, loga, Bm, Cm, chunk=Q),
             "plain_": lambda i: ref.ssd_scan_ref(u, loga, Bm, Cm, chunk=Q)}
    times = {}
    for key, fn in calls.items():
        times[f"{key}ms"] = device_ms(fn, 10)
        times[f"{key}eager_ms"] = eager_ms(fn, 10)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(5):
            calls[""](i)
        torch.cuda.synchronize()
    times["pass_ms"] = {key: sum(ms for k, _, ms in device_kernels(prof, 5)
                                 if f"ssd_{key}_kernel" in k)
                        for key in ("cb", "summary", "state", "output")}
    # the model's chunked formulation: C B^T once per chunk, then for every
    # head (C B^T * L) u, C h and B^T u; the causal mask leaves Q (Q + 1) / 2
    # of each chunk's (Q, Q) products. All fp32 FMAs on the CUDA cores.
    nc, tri = T // Q, Q * (Q + 1) // 2
    flops = 2 * B * nc * (tri * N + H * tri * P + 2 * H * Q * N * P)
    nbytes = 4 * (2 * B * T * H * P + B * T * H + 2 * B * T * N
                  + B * H * N * P)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    plan = ssd_plan(B, T, H, P, N, Q)
    row = {"shape": name, "route": "fp32 FMAs, CUDA cores, four passes",
           "blocks_per_pass": {k: int(np.prod(g))
                               for k, g in plan["grids"].items()},
           "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
           **times, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "tflop_per_s": flops / times["ms"] / 1e9,
           "library_ms": None,
           "library_note": "no single PyTorch call computes the SSD scan"}
    log(f"[kernel] ssd_scan timing {json.dumps(row)}")
    return row


# -------------------------------------------------------------- phase 15 --
def fabric_phase():
    """``launch.rlhf`` at full width, twice, each with a fresh engine and
    executor; the kernels' launches counted over both runs. Returns the
    ``[fabric]`` stats."""
    from repro_torch.core.torch_executor import TorchExecutor
    from repro_torch.launch import rlhf
    fabric_launches(reset=True)
    t0 = time.perf_counter()
    runs = []
    for _ in range(2):
        executor = TorchExecutor(seed=SEED, full_width=True, device=DEV)
        t_run = time.perf_counter()
        eng = rlhf.run_fabric(executor)
        wall = time.perf_counter() - t_run
        runs.append((eng, executor, rlhf.check(eng), wall))
    launches = fabric_launches()
    (eng_a, _, s, _), (eng_b, _, _, _) = runs
    both = set(eng_a.result_index) & set(eng_b.result_index)
    differ = [h for h in both
              if eng_a.result_index[h] != eng_b.result_index[h]]
    if not both or differ:
        raise AssertionError(f"{len(differ)} of {len(both)} H_tasks that "
                             f"both runs ran published different outputs")
    alone = [rlhf.check_alone(eng, ex) for eng, ex, _, _ in runs]
    stats = {"arch": runs[0][1].cfg.name, "workflows": s["tasks"],
             "executions": s["executions"],
             "dedup_savings": s["dedup_savings"],
             "mean_batch": s["mean_batch"], "model_loads": s["model_loads"],
             "hot_hits": s["hot_hits"],
             "median_op_ms": [rlhf.median_op_ms(ex) for _, ex, _, _ in runs],
             "run_wall_s": [wall for *_, wall in runs],
             "h_tasks_per_run": [len(eng_a.result_index),
                                 len(eng_b.result_index)],
             "h_tasks_both_ran": len(both),
             "payloads_checked_alone": alone,
             "launches": launches,
             "modelled_cost_usd": s["total_cost_usd"],
             "modelled_energy_kj": s["total_energy_kj"],
             "phase_s": time.perf_counter() - t0}
    log(f"[fabric] {json.dumps(stats)}")
    return stats


# -------------------------------------------------------------- phase 16 --
def wait_for(what: str, predicate, timeout_s: float):
    """Poll ``predicate`` until it returns a true value; raises after
    ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout_s} s waiting for {what}")


def durable_view(svc) -> dict:
    """What a journal restore rebuilds: every job's view, lineage and trace,
    the tenants' event-sourced usage (less the engine-local pool and
    latency meters, which die with a process) and the result index."""
    tenants = sorted({rec.tenant for rec in svc.jobs.values()})
    return {"jobs": {j: svc.job(j) for j in svc.jobs},
            "lineage": {j: svc.lineage(j) for j in svc.jobs},
            "trace": {j: json.dumps(svc.trace(j), sort_keys=True)
                      for j in svc.jobs},
            "usage": {t: {k: v for k, v in svc.usage(t).items()
                          if k not in ("pool", "latency")} for t in tenants},
            "index": dict(svc.engine.result_index)}


def require_equal(what: str, got: dict, want: dict) -> None:
    for key in want:
        if got[key] != want[key]:
            raise AssertionError(f"{what}: {key} differs")


def completed_by_tenant(metrics_text: str) -> dict:
    """``fabric_events_total{kind="workflow_completed",tenant=...}`` of a
    Prometheus exposition, by tenant."""
    out = {}
    for line in metrics_text.splitlines():
        if line.startswith('fabric_events_total{kind="workflow_completed"'):
            series, value = line.rsplit(" ", 1)
            tenant = series.split('tenant="', 1)[1].split('"', 1)[0]
            out[tenant] = float(value)
    return out


def service_phase() -> dict:
    """The tenants through the journaled service over loopback HTTP, a
    follower tailing it, then two restores (before and after compaction).
    Returns the ``[service]`` stats."""
    import shutil
    import threading
    from repro_torch.core.cas import DiskCAS
    from repro_torch.core.torch_executor import TorchExecutor
    from repro_torch.fabric.api import FabricAPI
    from repro_torch.fabric.follower import FollowerAPI, FollowerFabric
    from repro_torch.fabric.http import FabricHTTPServer, RemoteAPI
    from repro_torch.fabric.service import TERMINAL_STATUSES
    from repro_torch.launch import rlhf

    store = ROOT / "build" / "service-cas"
    shutil.rmtree(store, ignore_errors=True)
    fabric_launches(reset=True)
    t0 = time.perf_counter()
    executor = TorchExecutor(seed=SEED, full_width=True, device=DEV)
    svc = rlhf.service(executor, str(store))
    follower = FollowerFabric(DiskCAS(str(store)))
    server = FabricHTTPServer(FabricAPI(svc), host="127.0.0.1", port=0,
                              auto_pump=True)
    standby = FabricHTTPServer(FollowerAPI(follower), host="127.0.0.1",
                               port=0, auto_pump=False)
    tail_stop = threading.Event()
    tail = threading.Thread(target=follower.tail_loop,
                            args=(tail_stop, standby.lock), daemon=True)
    server.start()
    standby.start()
    tail.start()
    try:
        client = RemoteAPI(server.url, timeout_s=300.0)
        replica = RemoteAPI(standby.url, timeout_s=60.0)
        t_run = time.perf_counter()
        jobs = rlhf.submit_tenants(client)

        def statuses(api):
            return [api.handle("GET", f"/jobs/{j}")[1].get("status")
                    for j in jobs]

        wait_for("every job terminal", lambda: all(
            s in TERMINAL_STATUSES for s in statuses(client)), 900.0)
        run_wall = time.perf_counter() - t_run
        if set(statuses(client)) != {"completed"}:
            raise AssertionError(f"jobs {statuses(client)}")
        wait_for("the follower caught up", lambda: (
            replica.handle("GET", "/admin/replication")[1]["caught_up"]
            and set(statuses(replica)) == {"completed"}), 120.0)
        code, metrics = client.handle("GET", "/metrics")
        completed = completed_by_tenant(metrics)
        want = {t: 1.0 for _, t, _ in rlhf.SERVICE_TENANTS}
        if code != 200 or completed != want:
            raise AssertionError(f"GET /metrics workflow_completed "
                                 f"{completed}, want {want}")
        for path in ["/jobs"] + [f"/jobs/{j}/trace" for j in jobs]:
            got, primary = replica.handle("GET", path), client.handle(
                "GET", path)
            if got != primary:
                raise AssertionError(f"follower GET {path} differs")
    finally:
        tail_stop.set()
        tail.join(timeout=30.0)
        standby.stop()
        server.stop()
    launches = fabric_launches()
    s = rlhf.check(svc.engine)
    alone = rlhf.check_alone(svc.engine, executor)
    live = durable_view(svc)
    chain = svc.journal.chain_stats()

    # restore with a fresh executor, then resubmit t0's workflow
    executor2 = TorchExecutor(seed=SEED, full_width=True, device=DEV)
    svc2 = rlhf.service(executor2, str(store))
    t_restore = time.perf_counter()
    restored = svc2.restore_from_journal()
    restore_ms = (time.perf_counter() - t_restore) * 1e3
    require_equal("restored service", durable_view(svc2), live)
    [again] = rlhf.submit_tenants(FabricAPI(svc2),
                                  rlhf.SERVICE_TENANTS[:1])
    svc2.run_until_idle()
    if svc2.job(again)["status"] != "completed" \
            or svc2.engine.telemetry.executions != 0:
        raise AssertionError(f"resubmission after restore: "
                             f"{svc2.job(again)['status']}, "
                             f"{svc2.engine.telemetry.executions} "
                             f"executions (want none)")
    before = svc2.journal.chain_stats()
    compacted = svc2.compact()
    swept = svc2.gc()
    after = svc2.journal.chain_stats()
    svc3 = rlhf.service(executor2, str(store))
    t_restore = time.perf_counter()
    restored3 = svc3.restore_from_journal()
    restore3_ms = (time.perf_counter() - t_restore) * 1e3
    require_equal("compacted, restored service", durable_view(svc3),
                  durable_view(svc2))
    stats = {"arch": executor.cfg.name, "jobs": len(jobs),
             "executions": s["executions"],
             "dedup_savings": s["dedup_savings"],
             "mean_batch": s["mean_batch"],
             "payloads_checked_alone": alone,
             "metrics_workflow_completed": completed,
             "journal_live": {"segments": chain["segments"],
                              "bytes": chain["bytes"]},
             "journal_before_compaction": {"segments": before["segments"],
                                           "bytes": before["bytes"]},
             "journal_after_compaction": {"segments": after["segments"],
                                          "bytes": after["bytes"]},
             "compaction": {"folded_segments":
                            compacted["folded_segments"],
                            "reclaimed_blobs": swept["reclaimed_blobs"],
                            "reclaimed_bytes": swept["reclaimed_bytes"]},
             "restore_ms": restore_ms, "restore_events": restored["events"],
             "restore_after_compaction_ms": restore3_ms,
             "restore_after_compaction_from_snapshot":
                 restored3["from_snapshot"],
             "resubmit_executions": svc2.engine.telemetry.executions,
             "median_op_ms": rlhf.median_op_ms(executor),
             "run_wall_s": run_wall, "launches": launches,
             "phase_s": time.perf_counter() - t0}
    log(f"[service] {json.dumps(stats)}")
    return stats


# -------------------------------------------------------------- phase 17 --
#: ``scenarios/steady_mix.yaml`` and ``scenarios/worker_preemption.yaml``
#: as their documents (``yaml.safe_load``): the machine with the card has no
#: PyYAML. ``tests/test_torch_scenarios.py`` holds them equal to the files.
SCENARIOS = {
    "steady_mix": {
        "name": "steady-mix", "seed": 11, "duration_s": 120,
        "time_scale": 0.05, "settle_s": 90,
        "arrivals": {"process": "poisson", "rate_per_s": 0.4,
                     "diurnal": {"period_s": 120, "floor": 0.3}},
        "deadlines": {"fraction": 0.3, "min_s": 500, "max_s": 3000},
        "dedup": {"distinct_inputs": 4, "dataset": "gsm8k"},
        "slo": {"target_hit_rate": 0.95},
        "tenants": [
            {"name": "acme", "weight": 2.0,
             "workload": [{"template": "distill"}]},
            {"name": "globex", "weight": 1.0,
             "workload": [{"template": "agent-loop",
                           "params": {"rounds": 2}}]},
            {"name": "initech", "weight": 1.0,
             "workload": [{"template": "batch-eval"}]}]},
    "worker_preemption": {
        "name": "worker-preemption", "seed": 23, "duration_s": 60,
        "time_scale": 0.1, "settle_s": 120,
        "arrivals": {"process": "poisson", "rate_per_s": 0.3},
        "deadlines": {"fraction": 0.0},
        "dedup": {"distinct_inputs": 3, "dataset": "gsm8k"},
        "faults": [{"at_s": 20, "kind": "worker_kill",
                    "target": "worker-a"}],
        "tenants": [
            {"name": "acme", "weight": 1.0,
             "workload": [{"template": "distill"}]},
            {"name": "globex", "weight": 1.0,
             "workload": [{"template": "batch-eval"}]}]},
}


def scenario_run(stem: str, mode: str) -> dict:
    """One scenario through ``launch.scenario`` on a fresh full-width
    ``TorchExecutor``; ``worker_kill`` faults crash the service's first lane
    as ``tests/test_scenarios.py`` does. Returns the ``[scenario]`` stats."""
    from repro_torch.core.torch_executor import TorchExecutor
    from repro_torch.launch import rlhf, scenario
    from repro_torch.scenarios import (REPORT_KEYS, FaultActions,
                                       compile_scenario, run_virtual)
    sc = compile_scenario(SCENARIOS[stem])
    # every op is executed once or deduped: the total is the schedule's
    sim = run_virtual(sc)["dedup"]
    executor = TorchExecutor(seed=SEED, full_width=True, device=DEV)
    svc = scenario.service(executor, sc.seed)
    crash = {}
    lane = sorted(svc.engine.workers)[0]

    def preempt():
        worker = svc.engine.workers[lane]
        crash.update(lane=lane, at_s=svc.engine.now,
                     batch_in_flight=worker.current is not None,
                     queued_batches=sum(len(q) for q in
                                        worker.queues.values()))
        svc.engine.inject_crash(lane, svc.engine.now)

    fabric_launches(reset=True)
    t0 = time.perf_counter()
    report = scenario.run(sc, svc, mode=mode,
                          actions=FaultActions({"worker-a": preempt}))
    run_s = time.perf_counter() - t0
    launches = fabric_launches()
    if tuple(report) != REPORT_KEYS:
        raise AssertionError(f"report keys {tuple(report)}")
    engine = scenario.check(svc, report)
    ops = report["dedup"]["executed"] + report["dedup"]["deduped"]
    if ops != sim["executed"] + sim["deduped"]:
        raise AssertionError(f"{ops} ops executed or deduped, the schedule "
                             f"has {sim['executed'] + sim['deduped']}")
    fired = [f["fired"] for f in report["faults"]]
    if fired != [True] * len(sc.faults):
        raise AssertionError(f"faults {report['faults']}")
    alone = rlhf.check_alone(svc.engine, executor)
    stats = {"scenario": stem, "arch": executor.cfg.name,
             "report": {k: v for k, v in report.items() if k != "cost"},
             "modelled_cost": report["cost"],
             "sim_executor_dedup": sim, "engine": engine,
             "crash": crash or None, "payloads_checked_alone": alone,
             "median_op_ms": rlhf.median_op_ms(executor),
             "launches": launches, "run_s": run_s}
    log(f"[scenario] {json.dumps(stats)}")
    return stats


def scenario_phase() -> list:
    """``steady_mix`` and ``worker_preemption`` on the virtual driver, then
    ``steady_mix`` open loop over loopback HTTP."""
    return [scenario_run(stem, mode) for stem, mode in (
        ("steady_mix", "virtual"), ("worker_preemption", "virtual"),
        ("steady_mix", "open-loop"))]


# -------------------------------------------------------------- phase 18 --
def moe_breakdown(model, params, profile_stats):
    """Device ms a step of ``moe_block``'s parts (routing and the sort,
    the dispatch into the expert buffer, the expert products, the combine,
    the shared experts) at the decode shape (8 slots) and a 1500-token
    prefill: each part alone on one layer's weights, replayed from a CUDA
    graph, times the layers. Beside the profiled decode step's device time,
    its bound: the bytes of the weights a step reads (the embedding but one
    row a token) and of the KV rows, over the memory rate."""
    from repro_torch.models import ffn
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import unstack
    cfg = model.cfg
    E, k, L = cfg.n_experts, cfg.top_k, cfg.n_layers
    lp = unstack(params["layers"])[0].moe
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    parts = {}
    for shape, n in (("decode", B), ("prefill_1500", 1500)):
        x = torch.randn((1, n, cfg.d_model), generator=gen, device=DEV
                        ).to(cfg.compute_dtype)
        C = ffn._capacity(n, cfg)
        _, gates, ids = ffn.route(lp, x, cfg)
        dest = ffn.dispatch_plan(ids, E, C)
        buf = ffn.dispatch(x, dest, k, E, C)
        y = ffn.expert_products(lp, buf, cfg)
        calls = {
            "route_and_sort": lambda i: ffn.dispatch_plan(
                ffn.route(lp, x, cfg)[2], E, C),
            "dispatch": lambda i: ffn.dispatch(x, dest, k, E, C),
            "expert_products": lambda i: ffn.expert_products(lp, buf, cfg),
            "combine": lambda i: ffn.combine(y, dest, gates),
            "shared_experts": lambda i: ffn.swiglu(lp.shared, x,
                                                   cfg.compute_dtype),
            "moe_block": lambda i: ffn.moe_block(lp, x, cfg)}
        parts[shape] = {"capacity": C, **{
            f"{name}_ms": device_ms(fn, 10) * L for name, fn in calls.items()}}
    layers = params["layers"]
    weights = [t for name, leaf in layers._asdict().items() if name != "moe"
               for t in tree_leaves(leaf)]
    weights += [layers.moe.router, layers.moe.w_gate[:, :E],
                layers.moe.w_up[:, :E], layers.moe.w_down[:, :E],
                *tree_leaves(layers.moe.shared), params["lm_head"],
                params["final_norm"]]
    stats = {**decode_step_bound(cfg, weights, profile_stats),
             "routed_expert_gb": 3 * L * E * cfg.d_model * cfg.d_ff * 2 / 1e9,
             "parts_ms_per_step": parts}
    log(f"[profile moe] {json.dumps(stats)}")
    return stats


def decode_step_bound(cfg, weights, profile_stats) -> dict:
    """A decode step's bound beside its profiled device and host ms: the
    bytes of ``weights`` (what a step reads of the params) and of the KV
    rows the profiled steps read, over the memory rate."""
    weight_bytes = sum(t.numel() * t.element_size() for t in weights)
    kv_bytes = 2 * cfg.n_layers * profile_stats["kv_rows"] * \
        cfg.n_kv_heads * cfg.hd * 2
    return {"arch": cfg.name, "weight_gb_read_a_step": weight_bytes / 1e9,
            "kv_gb_read_a_step": kv_bytes / 1e9,
            "decode_step_bound_ms":
                (weight_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3,
            "decode_step_device_busy_ms":
                profile_stats["device_busy_ms_per_step"],
            "decode_step_host_ms": profile_stats["decode_step_ms"]}


def moe_determinism(model, params, reqs):
    """Two decode steps on one cache and the same tokens give the same
    bits, with no host sync in a step (CUDA's sync debug mode set to
    error); then every served stream equals its prompt run alone through
    an engine of the same 8 slots."""
    from repro_torch.serve.engine import Request, ServingEngine
    eng = ServingEngine(model, params, n_slots=B, max_len=S, seed=SEED)
    for r in reqs[:B]:
        eng.submit(Request(r.prompt, max_new_tokens=2))
    eng._admit()
    toks = torch.tensor([[eng.active[s].generated[-1]] for s in range(B)],
                        device=DEV)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first, _ = model.decode(params, toks, eng.cache)
        again, _ = model.decode(params, toks, eng.cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not torch.equal(first, again):
        raise AssertionError("two decode steps on one cache differ")
    del eng
    alone = ServingEngine(model, params, n_slots=B, max_len=S, seed=SEED)
    t0 = time.perf_counter()
    for r in reqs:
        solo = Request(r.prompt, max_new_tokens=r.max_new_tokens)
        alone.run([solo])
        if solo.generated != r.generated:
            raise AssertionError(f"req {r.req_id}: served {r.generated}, "
                                 f"alone {solo.generated}")
    log(f"[parity moe] {model.cfg.name}: two decode steps on one cache "
        f"bit-identical, no host sync in a step; {len(reqs)} served streams "
        f"equal their prompts run alone ({time.perf_counter() - t0:.1f} s)")


def moe_phase(cfg, rng):
    """Phase 18 at ``cfg`` (qwen2-moe-a2.7b). Returns the decode kernel's
    launches in the served run and the flash kernels' (forward, backward)
    in the train step's parity."""
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, params, reqs, records, counts = serve_full_width(cfg, rng)
    moe_breakdown(model, params, where_the_time_goes(model, params, rng))
    parity_bf16(model, params, reqs, records)
    moe_determinism(model, params, reqs)
    del model, params, records
    torch.cuda.empty_cache()
    parity_fp32(cfg, rng, n_layers=4)
    torch.cuda.empty_cache()
    flash = train_parity(cfg, n_layers=2, bf16=False)
    if min(flash) == 0:
        raise AssertionError(f"flash launches (fwd, bwd) {flash} in the "
                             f"MoE train step")
    torch.cuda.empty_cache()
    serve.main(["--arch", cfg.name, "--requests", "8", "--max-new", "16",
                "--slots", "8", "--max-len", "512"])
    log(f"[moe] phase {time.perf_counter() - t0:.1f} s, flash launches "
        f"(fwd, bwd) {flash}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return counts["decode_attention"], flash


# ---------------------------------------------------------- phases 19, 20 --
def greedy_decode(model, params, batch, cache, steps, feed=None,
                  after_prefill=None):
    """Serving at the model's level, without the engine: ``batch``
    prefilled into ``cache``, then ``steps`` decode steps, greedy or fed
    the tokens ``feed`` (B, steps) (teacher-forced). ``after_prefill``, if
    given, is called with the cache after the prefill (to read it or plant
    a fault). Returns the steps' logits (B, steps, V), the tokens (B, steps
    + 1) (the prefill's argmax, then each step's) and the cache."""
    logits, cache = model.prefill(params, batch, cache)
    if after_prefill is not None:
        after_prefill(cache)
    toks, out = [logits[:, -1].argmax(-1)], []
    for t in range(steps):
        tok = toks[t] if feed is None else feed[:, t]
        logits, cache = model.decode(params, tok[:, None], cache)
        out.append(logits[:, -1])
        toks.append(logits[:, -1].argmax(-1))
    return torch.stack(out, 1), torch.stack(toks, 1), cache


def first_difference(got, want, want_logits, what):
    """Greedy token streams (B, n) ``got`` against ``want``, whose step
    logits (B, n - 1, V) are ``want_logits``: equal, or differing first
    after a step whose top-2 margin is under FP32_TIE_MARGIN. Returns the
    rows equal in full."""
    equal = 0
    for row in range(want.shape[0]):
        diff = (got[row] != want[row]).nonzero()
        if not len(diff):
            equal += 1
            continue
        j = int(diff[0])
        if j == 0:
            raise AssertionError(f"{what}: row {row}'s prefill token differs")
        top2 = want_logits[row, j - 1].topk(2).values
        margin = (top2[0] - top2[1]).item()
        if margin >= FP32_TIE_MARGIN:
            raise AssertionError(f"{what}: row {row} differs at token {j} "
                                 f"(margin {margin:.3e})")
        log(f"[parity fp32] {what}: row {row} near-tie at token {j} (margin "
            f"{margin:.2e}); compared up to it")
    return equal


ENCDEC_MAX_LEN, ENCDEC_PROMPT, ENCDEC_STEPS = 448, 4, 32


def encdec_phase(cfg):
    """Phase 19 at ``cfg`` (whisper-tiny): 8 rows of seeded frames and
    4-token prompts, prefill and 32 greedy decode steps on a cache of 448
    in bf16 (``decode_attention`` on every decoder layer of every step);
    the encoder's device ms, the decode step's host and device ms; bf16
    logits against the plain decode attention fed the same tokens, beside
    a control (the plain model a row at a time) and a planted fault (a
    neighbouring row's cross K/V); two decode steps on one cache
    bit-identical; fp32 greedy streams against the plain path; one fp32
    train step, flash kernels against plain attention. Returns the decode
    kernel's launches in the served run and the flash kernels' (forward,
    backward) in the train step's parity."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import build_model
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, plain = build_model(cfg, device=DEV), plain_model(cfg)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    frames = torch.randn((B, cfg.enc_len, cfg.d_model), generator=gen,
                         device=DEV)
    prompt = torch.randint(0, cfg.vocab_size, (B, ENCDEC_PROMPT),
                           generator=gen, device=DEV)

    def run(m, params, rows=slice(None), **kw):
        batch = {"tokens": prompt[rows], "frames": frames[rows]}
        cache = m.init_cache(batch["tokens"].shape[0], ENCDEC_MAX_LEN)
        return greedy_decode(m, params, batch, cache, ENCDEC_STEPS, **kw)

    run(model, params)                                       # warm-up
    launch_counts(reset=True)
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    logits, tokens, cache = run(model, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = launch_counts()["decode_attention"]
    if launches != cfg.n_layers * ENCDEC_STEPS:
        raise AssertionError(f"decode_attention launches {launches}, want "
                             f"{cfg.n_layers} x {ENCDEC_STEPS}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits in an enc-dec decode step")

    step = lambda i: model.decode(params, tokens[:, -1:], cache)
    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    t_step = time.perf_counter()
    for i in range(10):
        step(i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t_step) / 10 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(10):
            step(i)
        torch.cuda.synchronize()
    busy_ms = sum(ms for _, _, ms in device_kernels(prof, 10))
    first, _ = model.decode(params, tokens[:, -1:], cache)
    again, _ = model.decode(params, tokens[:, -1:], cache)
    if not torch.equal(first, again):
        raise AssertionError("two enc-dec decode steps on one cache differ")
    stats = {"arch": cfg.name, "B": B, "enc_len": cfg.enc_len,
             "max_len": ENCDEC_MAX_LEN, "prompt": ENCDEC_PROMPT,
             "steps": ENCDEC_STEPS, "wall_s": wall,
             "decode_attention_launches": launches,
             "encoder_device_ms": device_ms(
                 lambda i: model.encode(params, frames), 5),
             "decode_step_ms": step_ms,
             "decode_step_device_busy_ms": busy_ms,
             "device_idle_share": 1 - busy_ms / step_ms,
             "top_kernels_per_step": [[name[:60], calls, ms] for name, calls,
                                      ms in device_kernels(prof, 10)[:6]]}
    log(f"[encdec] {json.dumps(stats)}")

    # bf16: the served logits against the plain decode attention fed the
    # same tokens; a control and a planted fault beside them
    feed = tokens[:, :-1]
    want = run(plain, params, feed=feed)[0].float()
    err = (logits.float() - want).abs().amax(-1)                # (B, steps)
    control = max((run(plain, params, slice(i, i + 1), feed=feed[i:i + 1])[0]
                   [0].float() - want[i]).abs().max().item() for i in (1, 3))
    rolled = lambda c: [c[n].copy_(c[n].roll(1, dims=1))
                        for n in ("cross_k", "cross_v")]
    fault = (logits.float() - run(plain, params, feed=feed,
                                  after_prefill=rolled)[0]
             .float()).abs().amax(-1).amax(-1).min().item()
    top2 = want.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    agree = logits.argmax(-1) == want.argmax(-1)
    log(f"[parity bf16] {cfg.name}: {err.numel()} steps, max |dlogit| "
        f"{err.max().item():.4f} (median step {err.median().item():.4f}, "
        f"tol {BF16_ENCDEC_LOGIT_ATOL}), argmax agrees {int(agree.sum())}/"
        f"{agree.numel()}; control (the plain model a row at a time, rows 1 "
        f"and 3) {control:.4f}; planted fault (a neighbouring row's cross "
        f"K/V) at least {fault:.4f}")
    if err.max().item() > BF16_ENCDEC_LOGIT_ATOL:
        raise AssertionError(f"bf16 logits off by {err.max().item()}")
    if not bool(agree[margin > BF16_ENCDEC_LOGIT_ATOL].all()):
        raise AssertionError("argmax differs where the margin exceeds the "
                             "tolerance")
    if fault <= BF16_ENCDEC_LOGIT_ATOL:
        raise AssertionError(f"a planted fault moved logits by only {fault}")
    del model, plain, params, cache

    # fp32: greedy streams of the kernel path against the plain path
    cfg32 = replace(cfg, param_dtype=torch.float32,
                    compute_dtype=torch.float32)
    model, plain = build_model(cfg32, device=DEV), plain_model(cfg32)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    _, got, _ = run(model, params)
    want_logits, want_tokens, _ = run(plain, params)
    equal = first_difference(got, want_tokens, want_logits, cfg.name)
    log(f"[parity fp32] {cfg.name}: {equal}/{B} greedy streams of "
        f"{ENCDEC_STEPS + 1} tokens equal the plain path's")
    del model, plain, params
    flash = train_parity(cfg, n_layers=cfg.n_layers, bf16=False, B=B,
                         T=ENCDEC_MAX_LEN)
    if min(flash) == 0:
        raise AssertionError(f"flash launches (fwd, bwd) {flash} in the "
                             f"enc-dec train step")
    log(f"[encdec] phase {time.perf_counter() - t0:.1f} s, flash launches "
        f"(fwd, bwd) {flash}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return launches, flash


VLM_TEXT, VLM_STEPS = 64, 8


def vlm_patches(model, params):
    """A model-level prefill of seeded patch embeddings (B 2, n_patches, d)
    before 64 text tokens, then 8 greedy decode steps: ``index`` must read
    n_patches + 64, and the steps' logits must match the plain decode
    attention fed the same tokens within BF16_VLM_LOGIT_ATOL. Returns the
    decode kernel's launches (one a layer a step)."""
    cfg = model.cfg
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    batch = {"patch_embeds": torch.randn(
        (2, cfg.n_patches, cfg.d_model), generator=gen, device=DEV
        ).to(cfg.compute_dtype),
        "tokens": torch.randint(0, cfg.vocab_size, (2, VLM_TEXT),
                                generator=gen, device=DEV)}
    index = []
    launch_counts(reset=True)
    logits, tokens, cache = greedy_decode(
        model, params, batch, model.init_cache(2, S), VLM_STEPS,
        after_prefill=lambda c: index.append(c["index"].tolist()))
    launches = launch_counts()["decode_attention"]
    if index != [[cfg.n_patches + VLM_TEXT] * 2]:
        raise AssertionError(f"index {index} after the prefill, want "
                             f"{cfg.n_patches + VLM_TEXT}")
    del cache
    plain = plain_model(cfg)
    want, _, _ = greedy_decode(plain, params, batch,
                                   plain.init_cache(2, S), VLM_STEPS,
                                   feed=tokens[:, :-1])
    err = (logits.float() - want.float()).abs().max().item()
    log(f"[parity bf16] {cfg.name} patches: prefill of {cfg.n_patches} "
        f"patches + {VLM_TEXT} tokens, index {index[0]} after it, "
        f"{VLM_STEPS} steps, max |dlogit| {err:.4f} (tol "
        f"{BF16_VLM_LOGIT_ATOL}), decode_attention launches {launches}")
    if err > BF16_VLM_LOGIT_ATOL or launches != cfg.n_layers * VLM_STEPS:
        raise AssertionError(f"vlm patches: max |dlogit| {err}, launches "
                             f"{launches}")
    return launches


def vlm_phase(cfg, rng):
    """Phase 20 at ``cfg`` (llava-next-34b). Returns the decode kernel's
    launches (the served run and the prefill with patches) and the flash
    kernels' (forward, backward) in the train step's parity."""
    from repro_torch.launch import serve
    from repro_torch.models.common import tree_leaves
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, params, reqs, records, counts = serve_full_width(cfg, rng)
    bound = decode_step_bound(
        cfg, tree_leaves([params["layers"], params["lm_head"],
                          params["final_norm"]]),
        where_the_time_goes(model, params, rng))
    log(f"[profile vlm] {json.dumps(bound)}")
    parity_bf16(model, params, reqs, records)
    launches = counts["decode_attention"] + vlm_patches(model, params)
    del model, params, records
    torch.cuda.empty_cache()
    parity_fp32(cfg, rng, n_layers=4)
    torch.cuda.empty_cache()
    flash = train_parity(cfg, n_layers=2, bf16=False, B=2, T=512)
    if min(flash) == 0:
        raise AssertionError(f"flash launches (fwd, bwd) {flash} in the "
                             f"vlm train step")
    torch.cuda.empty_cache()
    serve.main(["--arch", cfg.name, "--requests", "8", "--max-new", "16",
                "--slots", "8", "--max-len", "512"])
    log(f"[vlm] phase {time.perf_counter() - t0:.1f} s, flash launches "
        f"(fwd, bwd) {flash}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return launches, flash


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = build.build(["decode_attention", "flash_attention", "ssd_scan"])
    log(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(logs)}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "entry function" in line or "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log_dynamic_smem(build)

    rng = np.random.default_rng(SEED)
    smollm, llama, mamba, zamba, qwen, whisper, llava = (
        get_config(a) for a in (
            "smollm-135m", "llama-3.2-1b", "mamba2-1.3b", "zamba2-2.7b",
            "qwen2-moe-a2.7b", "whisper-tiny", "llava-next-34b"))
    rows = [check_and_time_decode_attention(
        c.name, c.n_heads, c.n_kv_heads, c.hd,
        c.n_layers // max(c.attn_every, 1), rng)
        for c in (smollm, llama, zamba, qwen, llava)]
    # whisper's decoder cache is its text context, 448
    check_and_time_decode_attention(
        whisper.name, whisper.n_heads, whisper.n_kv_heads, whisper.hd,
        whisper.n_layers, rng, S=ENCDEC_MAX_LEN, lengths=np.concatenate(
            [[0, 1, ENCDEC_MAX_LEN, ENCDEC_MAX_LEN + 5],
             rng.integers(8, ENCDEC_MAX_LEN, B - 4)]))
    for arch in ("phi3-mini-3.8b", "kimi-k2-1t-a32b"):
        c = get_config(arch)
        check_and_time_decode_attention(c.name, c.n_heads, c.n_kv_heads,
                                        c.hd, 0, rng)

    model, params, reqs, records, counts = serve_full_width(smollm, rng)
    launches = counts["decode_attention"]
    where_the_time_goes(model, params, rng)
    parity_bf16(model, params, reqs, records)
    del model, params, records
    parity_fp32(smollm, rng)

    from repro_torch.launch import serve
    serve.main(["--arch", "smollm-135m", "--requests", "8", "--max-new",
                "16", "--slots", "8", "--max-len", "512"])

    flash_rows = check_flash_attention()
    check_and_time_decode_attention(
        "smollm-135m fabric serve", smollm.n_heads, smollm.n_kv_heads,
        smollm.hd, 0, rng, B=4, S=256, lengths=[0, 12, 19, 256 + 5])
    timing = time_flash_attention()
    train_stats, (fwd_launches, bwd_launches) = train_full_width(smollm)
    profile_train_step(smollm, train_stats["step_ms_after_first"])
    train_parity(smollm)
    deterministic_runs(smollm)

    ssd_rows = check_ssd_scan()
    ssd_timing, _ = time_ssd_scan(0), time_ssd_scan(1)   # mamba2, zamba2
    ssd_launches = 0
    # fp32 parity at reduced depth: 4 SSM layers; 12 hybrid layers, two
    # groups of attn_every 6
    for cfg, depth in ((mamba, 4), (zamba, 12)):
        model, params, reqs, records, counts = serve_full_width(cfg, rng)
        ssd_launches += counts["ssd_scan"]
        where_the_time_goes(model, params, rng)
        parity_bf16(model, params, reqs, records)
        del model, params, records
        torch.cuda.empty_cache()
        parity_fp32(cfg, rng, n_layers=depth)
        prefill_fp32_full_depth(cfg, rng)
    serve.main(["--arch", "mamba2-1.3b", "--requests", "8", "--max-new",
                "16", "--slots", "8", "--max-len", "512"])
    torch.cuda.empty_cache()
    fabric_phase()
    service_phase()
    t0 = time.perf_counter()
    scenario_phase()
    log(f"[scenario] phase {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    for phase in (lambda: moe_phase(qwen, rng),
                  lambda: encdec_phase(whisper),
                  lambda: vlm_phase(llava, rng)):
        torch.cuda.empty_cache()
        phase_launches, (fwd, bwd) = phase()
        launches += phase_launches
        fwd_launches += fwd
        bwd_launches += bwd

    served = rows[0]
    kernels = [{"name": "decode_attention", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                "replaces": "src/repro/kernels/decode_attention.py:26",
                "launches": launches,
                "max_abs_err": served["max_abs_err_bf16"],
                "ms": served["ms"], "plain_ms": served["plain_ms"],
                "bound_ms": served["bound_ms"],
                "bound_by": served["bound_by"],
                "library_ms": served["library_ms"]}]
    for name, launches in (("fwd", fwd_launches), ("bwd", bwd_launches)):
        kernels.append({
            "name": f"flash_attention_{name}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:23",
            "launches": launches,
            "max_abs_err": flash_rows[0][f"{name}_err_bf16"],
            "ms": timing[f"{name}_ms"],
            "plain_ms": timing[f"plain_{name}_ms"],
            "bound_ms": timing[f"{name}_bound_ms"],
            "bound_by": timing[f"{name}_bound_by"],
            "library_ms": timing[f"library_{name}_ms"]})
    kernels.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:24",
        "launches": ssd_launches,
        "max_abs_err": ssd_rows[0]["y_err_chunked"],
        "ms": ssd_timing["ms"], "plain_ms": ssd_timing["plain_ms"],
        "bound_ms": ssd_timing["bound_ms"],
        "bound_by": ssd_timing["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
