#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each fatal on failure (nothing is caught):
  1. the card's name and power limit (``nvidia-smi``); TF32 off for
     matrix products and cuDNN, so fp32 results compare in full fp32;
  2. builds every kernel of the served and trained paths from
     ``src/repro_torch/kernels/csrc`` with ``nvcc`` (one process per source,
     three sources, started together) and prints each kernel's registers,
     shared memory and spills (the dynamic shared memory of the bf16 flash
     kernels at every head dim and of the scan's passes, forward and
     backward, from the libraries);
  3. holds the decode kernel against its plain PyTorch version on the card
     at the decode shapes of smollm-135m, llama-3.2-1b, zamba2-2.7b (hd 80),
     qwen2-moe-a2.7b (16/16, hd 128), llava-next-34b (56/8, hd 128, a
     group of 7) and whisper-tiny (6/6, hd 64, S 448), and at the head dims
     of phi3-mini (96) and kimi-k2 (112)
     (B 8, S 2048; lengths 0, 1, S and past S among them), fp32 at 1e-4 and
     bf16 at 2e-2, repeated calls bit-identical, the call with
     ``return_lse`` (its fp32 output and log-sum-exp, -inf at length 0)
     against the plain version's too, and times kernel, plain version, a
     library call and the ``return_lse`` call beside the served one (with
     the split plan, the achieved GB/s and the kernel on a head-major copy
     of the cache); the tensor-parallel "kv_seq" split of
     llava-next-34b x ``decode_32k`` emulated on the card: 16 calls on
     blocks of 2048 positions of one cache of 32768 (B 8, 56/8, hd 128;
     fp32 and bf16), merged by the route's merge
     (``ref.merge_attention_partials``) against one whole call, and one
     rank's call timed beside SDPA (``[kernel] decode_attention kv_seq
     split``), and the same for whisper-tiny x ``decode_32k``'s decoder
     (6/6, hd 64); and at zamba2's
     ``long_500k`` cell (S 524288, 32/32, hd 80: checked at B 3 with
     lengths 0, S and a ragged one, timed at B 1 with its split plan);
  4. serves 16 requests at the full width of smollm-135m in bf16 through
     ``ServingEngine`` (8 slots, max_len 2048, prompts of 8 to 1500 tokens,
     32 new tokens, one request submitted mid-flight) and checks that every
     decode step of every layer launched the kernel. The traffic runs
     twice, through the graphed engine (its decode step a CUDA graph,
     ``repro_torch.graphs``) and an eager one (``_decode.fn``), each step's
     logits recorded from the engine's ``logits``: bit for bit equal at
     every step; a third, graphed run with a stale token buffer in one
     replay must fail that check. ``[profile]`` prints host ms, device
     ms and the idle share of a decode step, graphed (the top-level keys)
     and eager (``eager``); over the profiled replays the launch counters
     equal the profiler's count of ``decode_attention_kernel``;
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
     shape (B 4, T 32), whisper-tiny's decoder (B 8, T 448, 6/6/64),
     llava-next-34b's 576 patches + 512 tokens (B 2, T 1088, 56/8/128),
     zamba2's training shape (B 8, T 2048, 32/32/80), hd 32 (B 2, T
     1024, 16/4) and phase 23's ``train_4k`` microbatch (B 16, T 4096,
     9/3/64), each at query offset 0, the path without one (the bf16
     forward and backward on wgmma at every head dim, the library's route
     tables checked against the wrapper's;
     repeated forwards bit-identical), and times kernel, plain version and
     SDPA at the training shape, forward and backward (with achieved
     TFLOP/s, the routes and the device ms of each backward kernel), and
     the kernels beside SDPA at every bf16 head dim and fp32 hd 64
     (``ROUTE_SHAPES``); and the decode kernel against its plain version
     at the fabric executor's serving shape (4 slots, S 256, 9/3/64);
  8. trains full-width smollm-135m in bf16 with ``remat="block"`` through
     ``repro_torch.launch.train`` (its step ``make_training``'s, graphed;
     AdamW, 6 steps of 8 x 2048 tokens) and checks falling finite losses
     and that every layer's attention went through the kernels (2 x 30
     forward and 30 backward launches a step); then the eager and the
     graphed step from the seed, 4 steps each: losses and grad norms bit
     for bit equal, the graphed peak at most 1.05 times the eager, and the
     last step of each profiled (``[profile train]``: host ms, device ms,
     idle share, peak memory, graphed beside ``eager``; in the graphed
     step the flash counters equal the profiler's kernel counts); and the
     same with Adafactor (kimi-k2's optimizer), 2 steps a side, the
     graphed step's second call its capture: losses and grad norms bit
     for bit equal, the graphed peak at most 1.05 times the eager
     (``[profile train adafactor]``);
  9. train parity: one step's loss and gradients with the kernels against
     the plain attention (fp32 at 4 layers, bf16 at the full config) (two
     identical runs from the seed are phase 8's eager and graphed ones,
     bit-identical over 4 steps);
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
     prefill, holds the graphed steps to the eager ones and the planted
     stale buffer as phase 4 does, and profiles decode steps (graphed and
     eager) and a prefill;
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
     phase's launches and seconds, the graph captures and their seconds
     in the runs and in the "alone" checks, each of which makes a fresh
     engine; dollars and energy are the cost model's, labelled
     modelled);
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
     the second. Prints a ``[service]`` line (with the graph captures,
     as phase 15's);
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
     retries, the launches and seconds, the graph captures);
 18. the MoE family: serves 16 requests at the full width of
     qwen2-moe-a2.7b in bf16 as in phase 4 (24 ``decode_attention``
     launches a decode step), profiles decode steps and prefills with the
     device ms of ``moe_block``'s parts against the step's bound (the
     weights' bytes); the graphed decode steps bit for bit equal to the
     eager ones, whose routing (``recording_routing``) the parity reads,
     and the planted stale buffer caught, as in phase 4; bf16 parity as
     in phase 5 with the count of tokens
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
     step; graphed against eager and the planted fault as there), the
     decode step's device ms against its bound (the weights'
     and KV rows' bytes), bf16 parity with a control (the kernels at batch
     1) and a planted fault (a neighbouring request's KV cache); a prefill
     of 576 seeded patch embeddings and 64 tokens (``index`` 640) and 8
     decode steps against the plain decode attention; fp32 engine streams
     at 4 layers; one fp32 train step at 2 layers on 576 patches + 512
     tokens (flash at a group of 7); ``repro_torch.launch.serve --arch
     llava-next-34b``; the phase's peak memory;
 21. SSM and hybrid training ((a) and (b) right after phase 10, where the
     profiler reads the passes' times): the SSD scan's backward kernel
     against its written-out plain version (``ref.ssd_scan_bwd_ref``) and autograd
     through ``ref.ssd_scan_ref`` at every shape of phase 10 and both
     training shapes (B 8, T 2048, 64/64/128 and 80/64/64), fp32, within
     1e-4 of each gradient's max, repeated calls and CUDA-graph replays
     bit-identical; times the backward, each of its six passes (b1 to b6)
     and the plain version at mamba2's training shape, and flash at
     zamba2's hd 80 beside SDPA (with each backward kernel's ms); trains full-width mamba2-1.3b and zamba2-2.7b through
     ``repro_torch.launch.train`` (bf16, remat "block", AdamW, 3 steps of 8
     x 2048 tokens: finite falling losses, 2 x layers forward and 1 x
     layers backward scan launches a step, for zamba2 2 x 9 and 9 flash
     launches), then holds each graphed step to the eager one as phase 8
     does (``[profile train ssm]``, with the scan's counters against the
     profiler's counts); train parity
     against the plain scan (and attention): fp32 at 4 and 6 layers at
     phase 9's tolerances, bf16 at full depth within 3x a control (the
     plain scan at chunk 128) that a planted fault (dloga dropped) must
     exceed (two identical runs are the eager and graphed ones above);
 22. the distributed layer (run right after phase 9), in a process group
     of one rank over NCCL (a ``FileStore`` under ``build/``; no other
     backend), the EP policy installed only inside ``logical.policy``:
     (a) ``sharding.shard_train_step`` on a (1, 1) ("data", "model") mesh
     at full-width smollm-135m (bf16, remat "block", AdamW, 3 steps of 8 x
     2048) through the tensor-parallel route (a route a step, over a
     "model" axis of one rank): each step's loss and grad norm and the
     params after 3 steps bit-identical to the unsharded step's, 2 x 30
     forward and 30 backward flash launches a step, both steps' ms, device
     busy ms, NCCL ms and peak memory; 6 steps with the int8
     error-feedback compressor, finite falling losses, the residual
     ``corrected - dequantized`` exactly; (b)
     ``pipeline`` over a one-rank ("stage",) mesh running the 30 layers on
     4 microbatches of 2 x 2048, bit-identical to the sequential trunk,
     120 flash forward launches; (c) ``moe_block`` under the policy
     (``moe_block_ep``) against ``moe_block`` on one layer of
     qwen2-moe-a2.7b under grad mode (fp32 at a capacity factor where
     neither drops: the output 2e-5, aux 1e-4 relative, the gradients of
     the router, the expert stacks and x 2e-5 of each one's largest) at 8
     and 1536 tokens, and both paths' forward and backward device ms in
     bf16 at the config's capacity factor; (d) ``launch.build.serve_step``
     on the (1, 1) mesh (run after (a): a prefill of 8 x 256 tokens into a
     cache of 512, then 4 greedy decode steps) through the route, its
     logits bit-identical to ``model.prefill``/``decode``'s at every step;
     (e) mamba2-1.3b's sharded step on the (1, 1) mesh at 4 of its 48
     layers (full width, 3 steps of 8 x 2048) through the route (SSM heads
     "local" over one rank) bit-identical to the unsharded step, 2 x 4
     forward and 4 backward scan launches a step; (f) qwen2-moe-a2.7b's
     sharded step on the (1, 1) mesh at 4 of its 24 layers (full width,
     fp32, 3 steps of 2 x 1024, capacity factor E / k) through the route
     (its MoE layers by expert parallelism over the one rank) against the
     unsharded step's grouped dispatch: losses and grad norms within 1e-5
     relative, 2 x 4 forward and 4 backward flash launches a step; (g)
     whisper-tiny on the (1, 1) mesh through the route (the decoder's
     plan with the encoder's): its sharded step (full width, bf16, 3
     steps of 8 x 448 tokens and 8 x 1500 seeded frames) bit-identical to
     the unsharded step, 2 x 4 forward and 4 backward flash launches a
     step, and ``serve_step`` (the frames and 4 tokens into a cache of
     448, 4 greedy decode steps) bit-identical to ``model.prefill`` and
     ``decode``, 4 ``decode_attention`` launches a decode step;
 23. the launch tooling (run last): (a) ``python -m
     repro_torch.launch.dryrun`` in a process per cell (after (b)'s
     predictions; the processes start after phase 21's timed trainings
     and count on the host while the card runs phase 21's parity checks,
     (c)'s kernel checks and (b))
     for llava-next-34b x ``train_4k`` on both
     production meshes, mamba2-1.3b x ``train_4k`` and (c)'s 14
     cells on (c)'s ranks, a ``[dryrun]`` line each with its
     tensor-parallel plan
     (the other cells are counted on the CPU: ``--all`` and
     ``tests/test_torch_launch.py``);
     (b) two table cells built by ``launch.build.build_cell`` on the card on a
     (1, 1) ("data", "model") mesh of one NCCL rank, each beside its dry
     run on the same mesh (a fake world of one rank; the dry run's peak of
     one smollm-135m train step equal to ``MemTracker``'s): zamba2-2.7b x
     ``long_500k`` (one token against a populated cache of 524288
     positions, 9 ``decode_attention`` launches, logits bit-identical to
     ``model.decode``) and smollm-135m x ``train_4k`` at the smallest
     grad_accum that the dry run fits on the card (a step bit-identical
     to the unsharded step's, 2 x 30 forward and 30 backward flash
     launches a microbatch); the card's peak may exceed the predicted one
     by ``PEAK_MARGIN`` and no more; (c) one rank's share of 14
     tensor-parallel cells (``TP_CELLS``), each train cell one step after
     a warm-up (2 x 32 forward and 32 backward flash launches; zamba2 2 x
     9 and 9 flash, 2 x 54 and 54 scan; qwen2-moe 2 x 24 and 24;
     whisper-tiny 2 x 4 and 4; llava-next-34b 2 x 60 and 60; kimi-k2 2 x
     61 and 61), the flash launches of a profiled step counted by the
     profiler too, and the optimizer update's device ms, each decode
     cell 2 steps (32
     ``decode_attention`` launches a step; zamba2 9, qwen2-moe 24,
     llava-next-34b 60, whisper-tiny 4):
     phi3-mini-3.8b x ``train_4k`` and x ``decode_32k`` (attention
     "local"), llama-3.1-8b x ``train_4k`` and x ``decode_32k``
     ("kv_replicated": 2 query heads on one KV head a rank, the rank's KV
     head's cache), minitron-4b x ``train_4k`` on its last rank along
     "model" ("q_seq": query rows 3840 to 4096, flash at that offset) and
     zamba2-2.7b x ``train_4k`` and x ``decode_32k`` (the shared block's
     2/2 heads and 5 of the 80 SSM heads "local", the rank's SSM state and
     conv channels, ``in_proj``, ``conv_w`` and ``conv_b`` stored by rank:
     the rank's block, B and C all-gathered along "model") and
     qwen2-moe-a2.7b x ``train_4k`` and x ``decode_32k`` (1/1 heads and
     352 of the shared experts' 5632 columns "local", one of the 256
     padded experts a rank, its block of
     tokens sent by all-to-all) and llava-next-34b x ``decode_32k``
     ("kv_seq": all 56/8 heads on the rank's 2048 of the cache's 32768
     positions, its partials merged across the ranks; 60
     ``decode_attention`` launches a step) and whisper-tiny x ``train_4k``
     on rank 15 (the decoder "q_seq" from rows 3840 to 4096, the encoder
     "gathered", the whole-vocab loss on the rank's own positions) and x
     ``decode_32k`` ("kv_seq", the cross K/V whole along "model") and
     llava-next-34b x ``train_4k`` on rank 15 ("q_seq": all 56/8 heads on
     query rows 3840 to 4096) and kimi-k2-1t-a32b x ``train_4k`` at full
     depth (61 layers; "kv_replicated": 4 query heads of hd 112 on one KV
     head, 2 of the 512 padded experts a rank, Adafactor: the first time
     it runs on the card), built by ``build_cell`` on the card in a
     fake world of 256 ranks on the (16, 16) mesh, each layer's leaves
     gathered when the layer runs (the collectives move no data, so no
     value is checked), a ``[launch] tp`` line each beside the dry run of
     the same cell and rank (run in (a)'s pool), the peak within
     ``PEAK_MARGIN`` of it, and beside the share's peak, host and device
     ms before the mamba2 blocks were stored by rank
     (``PARENT_SHARES``); first of all (before (b)), ``decode_attention``,
     flash (with and without a query offset) and the scan, forward and
     backward, held to their plain versions at the shapes the shares give
     them (``TP_FLASH_SHAPES``, ``TP_SSD_SHAPES``), and each timed there
     (kimi-k2's hd 112 beside its bound and SDPA).

After each group of phases a ``[time]`` line gives the seconds since the
start. It then prints the kernels line and, last, the device line as JSON. Exits
non-zero without a CUDA card or outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import functools
import gc
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
# zamba2-2.7b's shared attention in its train step (B 8, T 2048, 32/32/80)
ZAMBA_FLASH_TRAIN = ("zamba2-2.7b train", 8, 2048, 2048, 32, 32, 80, True)
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
                 1088, 56, 8, 128, True),
                ZAMBA_FLASH_TRAIN,
                ("hd 32", 2, 1024, 1024, 16, 4, 32, True),
                # phase 23's train_4k microbatch (the plain version's fp32
                # forward and backward peak at 30 GB)
                ("smollm-135m train_4k", 16, 4096, 4096, 9, 3, 64, True)]
# Phase 7's route timing: each bf16 head dim at its shape above (hd 80 at
# zamba2's training shape), and fp32 at smollm-135m's training shape.
ROUTE_SHAPES = [(torch.bfloat16, FLASH_SHAPES[i]) for i in (13, 0, 12, 4, 5, 2)
                ] + [(torch.float32, FLASH_SHAPES[0])]
# Forward and dq, dk, dv against autograd through the plain version.
# fp32: sums in another order only. bf16: both accumulate in fp32 and round
# the results once; the kernel also rounds P and dS to bf16 as tensor-core
# operands and reads the bf16 O in rowsum(dO * O), each a 2^-9 relative
# difference in one term of a sum.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TRAIN_STEPS = 6
# phase 21's launch.train runs of mamba2-1.3b and zamba2-2.7b (6 until PR
# 26, cut to fit the graphed-against-eager steps in the smoke's time)
SSM_TRAIN_STEPS = 3
TRAIN_B, TRAIN_T = 8, 2048
# graphed against eager train steps: this many from the seed, bit-identical
# (the graph's warm-up, capture and two replays), the last profiled; the
# graph's private pool may raise the step's peak by this factor and no more
GRAPH_TRAIN_STEPS = 4
GRAPH_PEAK_RATIO = 1.05
# phase 8's check with Adafactor: steps a side (the graphed step's second
# call is its capture and first replay)
ADAFACTOR_GRAPH_STEPS = 2
# decode steps that phases 11, 12, 18 and 20 time and profile, graphed and
# eager (``where_the_time_goes``; phase 4 profiles 10: the later phases'
# windows are cut to fit phase 23's tensor-parallel shares in the smoke's
# time)
LATE_PROFILE_STEPS = 2
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
    prints only the static part): the bf16 flash kernels (forward, dK/dV
    and dQ on wgmma) at every head dim, and the SSD scan's passes, forward
    and backward, at the two SSM families' shapes."""
    import ctypes

    from repro_torch.kernels.flash_attention import HEAD_DIMS
    flash = build.load("flash_attention").repro_flash_smem
    scan = build.load("ssd_scan").repro_ssd_smem
    for fn in (flash, scan):
        fn.restype = ctypes.c_int
    flash.argtypes = [ctypes.c_int] * 2
    scan.argtypes = [ctypes.c_int] * 3
    for hd in HEAD_DIMS:
        log(f"[build] flash_attention wgmma hd {hd}: dynamic shared memory "
            f"forward {flash(hd, 2)} B, dK/dV {flash(hd, 0)} B, dQ "
            f"{flash(hd, 1)} B")
    for name, N, P in (("mamba2-1.3b", 128, 64), ("zamba2-2.7b", 64, 64)):
        log(f"[build] ssd_scan {name} (N {N}, P {P}): dynamic shared memory "
            + ", ".join(f"pass {i} {scan(N, P, i)} B" for i in (1, 2, 4))
            + "; backward " + ", ".join(f"pass b{i - 4} {scan(N, P, i)} B"
                                        for i in (5, 6, 8, 9, 10)))


# --------------------------------------------------------------- phase 3 --
# the log-sum-exp of the ``return_lse`` call against the plain version's:
# both in fp32 from the same inputs, the kernel's in log2 units (exp2 of
# pre-scaled scores) then M ln 2 + ln(den), so they differ by sums in
# another order (an H100 run: 9.5e-7 at most on values near 8, at
# smollm-135m's and llava-next-34b's shapes and merged over 16 blocks)
LSE_TOL = 1e-4


def lse_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs error of a log-sum-exp where finite; raises unless -inf
    sits at the same places (length 0) and the rest is within
    ``LSE_TOL``."""
    if not torch.equal(torch.isinf(got), torch.isinf(want)) or \
            not torch.all(got[torch.isinf(got)] < 0):
        raise AssertionError("the log-sum-exp's -inf (length 0) differs")
    fin = torch.isfinite(want)
    return max_err(got[fin], want[fin], LSE_TOL)


def check_kv_seq_split(name="llava-next-34b", Hq=56, Hkv=8, hd=128, m=16,
                       S=32768, B=8, L=8):
    """The "kv_seq" decode of ``name`` x ``decode_32k`` emulated on one
    card: m calls with ``return_lse`` on m blocks of S / m positions of
    one cache (B 8; llava-next-34b's 56/8 heads of hd 128, whisper-tiny's
    decoder's 6/6 of 64), each with its own lengths, as m ranks along
    ``"model"`` run it, merged in rank order by the route's merge
    (``ref.merge_attention_partials``) against one whole call: the output
    within phase 3's bounds (fp32 and bf16) and the merged log-sum-exp
    within ``LSE_TOL``. Lengths 0, 1, a block's end and one past it, S,
    past S and ragged ones. Then one rank's call (S / m positions, every
    slot full, as rank 0's in phase 23's share) timed over L layers,
    served, with ``return_lse`` and as SDPA (one query row against the
    block), with its bound."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import ref
    dev = torch.device(DEV)
    n = S // m
    lengths = torch.tensor([0, 1, n, n + 1, S, S + 5, 20001, 4097],
                           dtype=torch.int32, device=dev)[:B]
    row = {"shape": f"{name} kv_seq split", "ranks": m, "B": B,
           "S": S, "Hq": Hq, "Hkv": Hkv, "hd": hd, "positions_a_rank": n,
           "lengths": lengths.tolist()}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)
        q = torch.randn((B, Hq, hd), generator=gen, device=dev).to(dtype)
        kv = torch.randn((2, B, S, Hkv, hd), generator=gen, device=dev
                         ).to(dtype)
        parts = [dk.decode_attention(
            q, kv[0][:, r * n:(r + 1) * n], kv[1][:, r * n:(r + 1) * n],
            (lengths - r * n).clamp(0, n).to(torch.int32), return_lse=True)
            for r in range(m)]
        outs = torch.stack([o for o, _ in parts])
        lses = torch.stack([lse for _, lse in parts])
        merged = ref.merge_attention_partials(outs, lses)
        whole, whole_lse = dk.decode_attention(q, kv[0], kv[1], lengths,
                                               return_lse=True)
        torch.cuda.synchronize()
        name = "fp32" if dtype == torch.float32 else "bf16"
        row[f"merged_max_abs_err_{name}"] = max_err(merged, whole,
                                                    TOL[dtype])
        row[f"merged_lse_max_abs_err_{name}"] = lse_err(
            torch.logsumexp(lses, dim=0), whole_lse)
        if not torch.all(merged[0] == 0):
            raise AssertionError("length 0 must merge to zeros")
        del q, kv, parts, outs, lses, merged, whole, whole_lse
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    q = torch.randn((L, B, Hq, hd), generator=gen, device=dev
                    ).to(torch.bfloat16)
    k, v = (torch.randn((L, B, n, Hkv, hd), generator=gen, device=dev
                        ).to(torch.bfloat16) for _ in range(2))
    full = torch.full((B,), n, dtype=torch.int32, device=dev)
    row["rank_ms"] = device_ms(
        lambda i: dk.decode_attention(q[i % L], k[i % L], v[i % L], full),
        3 * L)
    row["rank_lse_ms"] = device_ms(
        lambda i: dk.decode_attention(q[i % L], k[i % L], v[i % L], full,
                                      return_lse=True), 3 * L)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row["rank_library_ms"] = device_ms(
        lambda i: sdpa(q[i % L][:, :, None], k[i % L].transpose(1, 2),
                       v[i % L].transpose(1, 2), enable_gqa=True), 3 * L)
    # the return_lse call's bytes: K/V and q read, fp32 output and lse
    nbytes = 2 * B * n * Hkv * hd * 2 + B * Hq * hd * (2 + 4) + 4 * B * Hq
    flops = 4 * B * n * Hq * hd
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    row.update(rank_bound_ms=max(bytes_ms, ops_ms),
               rank_bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    del q, k, v
    torch.cuda.empty_cache()
    log(f"[kernel] decode_attention kv_seq split {json.dumps(row)}")
    return row


def check_and_time_decode_attention(name, Hq, Hkv, hd, L, rng, B=B, S=S,
                                    lengths=None, timed_lengths=None):
    """Kernel against plain on the card in fp32 and bf16, then timings in
    bf16 over L layers of cache (more bytes than the 50 MB L2 holds, as a
    decode step finds them); L = 0 checks only. B slots of S keys; the
    slots' lengths are drawn unless given (the first must be 0). The
    timings take the same slots, or ``timed_lengths`` where given (with the
    split plan of that batch). Each dtype's inputs are freed before the
    next are drawn (S 524288 is 32 GB of fp32 cache at B 3)."""
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
        got32, got_lse = decode_attention(q, kv[0], kv[1], lens,
                                          return_lse=True)
        torch.cuda.synchronize()
        want32, want_lse = ref.decode_attention_ref(q, kv[0], kv[1], lens,
                                                    return_lse=True)
        torch.cuda.synchronize()
        errs[dtype] = max_err(got, want32.to(dtype), TOL[dtype])
        errs[f"fp32_out_{dtype}"] = max_err(got32, want32, TOL[dtype])
        errs[f"lse_{dtype}"] = lse_err(got_lse, want_lse)
        if not (torch.all(got[0] == 0) and torch.all(got32[0] == 0)):
            raise AssertionError("length 0 must give zeros")
        if not torch.equal(got32.to(dtype), got):
            raise AssertionError("the served output is not the lse call's "
                                 "fp32 output rounded")
        for _ in range(2):
            if not torch.equal(decode_attention(q, kv[0], kv[1], lens), got):
                raise AssertionError("repeated decode_attention calls differ")
        del q, kv, got, got32, got_lse, want32, want_lse
    splits, tps = dk.split_plan(B, Hkv, S, dk._sm_count(dev))
    row = {"shape": name, "B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "hd": hd,
           "splits": splits, "tiles_per_split": tps,
           "lengths": lengths.tolist(),
           "max_abs_err_fp32": errs[torch.float32],
           "max_abs_err_bf16": errs[torch.bfloat16],
           "lse_call_max_abs_err": {
               "out_fp32": errs[f"fp32_out_{torch.float32}"],
               "out_bf16": errs[f"fp32_out_{torch.bfloat16}"],
               "lse_fp32": errs[f"lse_{torch.float32}"],
               "lse_bf16": errs[f"lse_{torch.bfloat16}"]}}
    if not L:
        log(f"[kernel] decode_attention check {json.dumps(row)}")
        return row
    if timed_lengths is not None:
        lengths = np.asarray(timed_lengths, np.int32)
        lens = torch.from_numpy(lengths).to(dev)
        B = len(lengths)
        row["timed_lengths"] = lengths.tolist()
        row["timed_splits"], row["timed_tiles_per_split"] = dk.split_plan(
            B, Hkv, S, dk._sm_count(dev))
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
        "lse_": lambda i: decode_attention(q[i % L], k[i % L], v[i % L],
                                           lens, return_lse=True),
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


def graph_captures(since: dict | None = None) -> dict:
    """Every compiled step's captures so far and their host seconds, or
    those since ``since`` (an earlier reading)."""
    from repro_torch.graphs import CompiledStep
    now = {"captures": CompiledStep.captures,
           "capture_s": CompiledStep.capture_s}
    return now if since is None else {k: now[k] - since[k] for k in now}


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


def served_run(model, params, prompts, *, eager=False, routing=None,
               fault=False):
    """The phase's traffic through a fresh engine (8 slots of 2048): 16
    requests of 32 new tokens, the last submitted after the first step.
    The engine is graphed, or eager with its decode step called unwrapped
    (``_decode.fn``). Returns (engine, requests, records): a record a
    decode step of (slot -> req_id, the step's logits (B, V) as the engine
    exposes them, cloned, and with ``routing`` (the sink
    ``recording_routing`` fills) its top-k expert ids by layer, (L, B, 1,
    k), else None). ``fault`` plants a stale token buffer: at the first
    replay whose tokens differ from the last step's, ``_feed`` is skipped;
    the run stops a step later (the step is ``eng.planted``)."""
    from repro_torch.serve.engine import Request, ServingEngine
    eng = ServingEngine(model, params, n_slots=B, max_len=S, seed=SEED)
    if eager:
        eng._decode = eng._decode.fn
    eng.planted = None
    if fault:
        feed = eng._feed

        def stale():
            want = [eng.active[s].generated[-1] if s in eng.active else 0
                    for s in range(B)]
            if eng.planted is None and eng.steps >= 2 and \
                    want != eng.tokens[:, 0].tolist():
                eng.planted = eng.steps + 1
                return
            feed()

        eng._feed = stale
    reqs = [Request(p, max_new_tokens=32, tenant=f"tenant-{i % 4}")
            for i, p in enumerate(prompts)]
    records, L = [], model.cfg.n_layers

    def step():
        n = eng.steps
        done = eng.step()
        if eng.steps > n:
            slots = {s: r.req_id for s, r in eng.active.items()}
            slots.update({r.slot: r.req_id for r in done})
            # the last L entries are the decode step's, the rest prefills'
            records.append((slots, eng.logits.clone(),
                            torch.stack(routing[-L:]) if routing else None))
        if routing is not None:
            routing.clear()
        return done

    for r in reqs[:-1]:
        eng.submit(r)
    step()
    eng.submit(reqs[-1])                         # arrives mid-flight
    while eng.waiting or eng.active:
        step()
        if eng.planted is not None and eng.steps > eng.planted:
            break
    if fault:
        del eng._feed      # the closure holds eng: free it with the engine
    return eng, reqs, records


def same_steps(got, want, what: str) -> None:
    """Raises unless two runs' decode steps gave the same logits bit for
    bit, with the same requests (by their place in the run) in the same
    slots. ``got`` and ``want`` are (requests, records) of a run."""
    (got_reqs, got), (want_reqs, want) = got, want
    place = [{r.req_id: i for i, r in enumerate(reqs)}
             for reqs in (got_reqs, want_reqs)]
    if len(got) > len(want):
        raise AssertionError(f"{what}: {len(got)} decode steps against "
                             f"{len(want)}")
    for i, ((slots, logits, _), (want_slots, want_logits, _)) in enumerate(
            zip(got, want)):
        slots = {s: place[0][r] for s, r in slots.items()}
        want_slots = {s: place[1][r] for s, r in want_slots.items()}
        if slots != want_slots or not torch.equal(logits, want_logits):
            err = (logits.float() - want_logits.float()).abs().max().item()
            raise AssertionError(f"{what}: decode step {i + 1} differs (max "
                                 f"|dlogit| {err}, slots {slots} against "
                                 f"{want_slots})")


def serve_full_width(cfg, rng):
    """Serves 16 requests at full width in bf16, eagerly and graphed. The
    graphed engine's logits equal the eager engine's bit for bit at every
    decode step, and a planted stale token buffer must break that check.
    Returns the model, its params, the eager run's requests and records
    (each decode step's slot map, logits and, for MoE, top-k expert ids by
    layer; routing is recorded in the eager run, where Python runs every
    step), and the graphed run's kernel launches: ``decode_attention`` on
    every attention layer of every decode step, ``ssd_scan`` on every SSM
    layer of every prefill."""
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

    routing = [] if cfg.family == "moe" else None
    walls = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (recording_routing(routing) if routing is not None
          else contextlib.nullcontext()):
        eng, reqs, records = served_run(model, params, prompts, eager=True,
                                        routing=routing)
    torch.cuda.synchronize()
    walls["eager"] = time.perf_counter() - t0
    del eng
    launch_counts(reset=True)
    t0 = time.perf_counter()
    eng, graphed_reqs, graphed = served_run(model, params, prompts)
    torch.cuda.synchronize()
    walls["graphed"] = time.perf_counter() - t0
    launches = launch_counts()
    steps, generated = eng.steps, eng.tokens_generated
    replays = eng._decode.replays
    del eng           # its cache and graph pool, before the fault run's
    if len(graphed) != len(records):
        raise AssertionError(f"{len(graphed)} graphed decode steps, "
                             f"{len(records)} eager")
    same_steps((graphed_reqs, graphed), (reqs, records),
               f"{cfg.name} graphed against eager")
    if [r.generated for r in graphed_reqs] != [r.generated for r in reqs]:
        raise AssertionError("graphed and eager streams differ")
    del graphed
    faulty, stale_reqs, stale = served_run(model, params, prompts,
                                           fault=True)
    try:
        same_steps((stale_reqs, stale), (reqs, records), "planted fault")
    except AssertionError as caught:
        planted = f"step {faulty.planted}: {caught}"
    else:
        raise AssertionError(f"a stale token buffer at step "
                             f"{faulty.planted} went unseen")
    del faulty, stale, stale_reqs

    done = [r for r in graphed_reqs if r.done]
    if len(done) != len(reqs) or not all(r.done for r in reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    if not all(bool(torch.isfinite(lg).all()) for _, lg, _ in records):
        raise AssertionError("non-finite logits in a served decode step")
    attn_layers = {"dense": cfg.n_layers, "moe": cfg.n_layers,
                   "vlm": cfg.n_layers, "ssm": 0,
                   "hybrid": cfg.n_layers // max(cfg.attn_every, 1)}
    want = {"decode_attention": attn_layers[cfg.family] * steps,
            "ssd_scan": cfg.n_layers * len(reqs)
            if cfg.family in ("ssm", "hybrid") else 0}
    if launches != want or steps == 0 or replays != steps - 1:
        raise AssertionError(f"launches {launches} in {steps} steps "
                             f"({replays} replayed) and {len(reqs)} "
                             f"prefills, want {want}")
    stats = {"arch": cfg.name, "requests": len(done),
             "routing_recorded": cfg.family == "moe",
             "prompt_tokens": int(lens.sum()),
             "tokens_generated": generated,
             "engine_steps": steps, "graph_replays": replays,
             "wall_s": walls["graphed"],
             "tok_per_s": generated / walls["graphed"],
             "eager_wall_s": walls["eager"],
             "eager_tok_per_s": generated / walls["eager"],
             "logits_bit_identical_steps": len(records),
             "mean_occupancy": generated / (steps * B),
             **{f"{k}_launches": v for k, v in launches.items()}}
    log(f"[serve] {json.dumps(stats)}")
    log(f"[serve] {cfg.name}: graphed logits equal the eager engine's at "
        f"all {len(records)} decode steps; planted stale token buffer "
        f"caught at {planted}")
    return model, params, reqs, records, launches


# which kernel of each wrapper's launch the profiler counts
PROFILED_KERNEL = {"decode_attention": "decode_attention_kernel",
                   "flash_attention_fwd": "flash_fwd_",
                   "flash_attention_bwd": "flash_delta_kernel",
                   "ssd_scan_fwd": "ssd_output_kernel",
                   "ssd_scan_bwd": "ssd_grad_du_kernel"}


def kernel_counters() -> dict:
    """Every kernel wrapper's launch counter, by wrapper."""
    from repro_torch import graphs
    return {fn.__name__: fn.launches for fn in graphs.counters()}


def launches_against_profiler(what: str, before: dict, prof,
                              expect: tuple) -> dict:
    """Raises unless, over a profiled window of replays, each launch
    counter moved by the number of executions the profiler counted of its
    wrapper's kernel (``PROFILED_KERNEL``), and the wrappers in ``expect``
    launched; the counters advance at a replay by the delta its capture
    recorded. Returns the counts."""
    moved = {name: n - before[name] for name, n in kernel_counters().items()}
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    counted = {name: sum(e.count for e in events if kernel in e.key)
               for name, kernel in PROFILED_KERNEL.items()}
    log(f"[launches] {what}: counters moved {moved}, profiler counted "
        f"{counted}")
    if moved != counted or not all(moved[name] for name in expect):
        raise AssertionError(f"{what}: launch counters {moved}, the "
                             f"profiler's kernel executions {counted}, "
                             f"want launches of {expect}")
    return counted


def hold_launches(what: str, before: dict, prof, expect: tuple,
                  window) -> None:
    """``launches_against_profiler`` over a profiled window already run
    (``before``, ``prof``); on a mismatch once more, over ``window()`` run
    under the profiler, which must agree. The profiler has read one kernel
    execution fewer than ran in a train step's replay (95 of 96
    ``ssd_output_kernel`` at mamba2-1.3b, 17 of 18 flash forwards at
    zamba2-2.7b: twice in about 30 windows, the next window right), while
    the counters move only by what a replay launched."""
    from torch.profiler import ProfilerActivity, profile
    try:
        launches_against_profiler(what, before, prof, expect)
    except AssertionError as missed:
        log(f"[launches] {what}: {missed}; profiling one more window")
        before = kernel_counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as again:
            window()
            torch.cuda.synchronize()
        launches_against_profiler(what, before, again, expect)


def require_device_time(what: str, parts: dict) -> None:
    """Raises where the profiler read no device time for a part that ran:
    a kernel it did not trace would otherwise print as a time of 0."""
    zero = [part for part, ms in parts.items() if not ms > 0]
    if zero:
        raise AssertionError(f"{what}: the profiler read no device time "
                             f"for {zero}")


# The profiler drops the first kernel records of a session, more the
# older the process (H100 runs: the first of five calls about 90 s in,
# all five of flash's backward about 550 s in, a wait before the calls
# notwithstanding). A kernel breakdown therefore runs its calls twice in
# a session, with this wait between, and averages what was recorded.
PROFILE_LEAD_S = 0.1


def kernel_breakdown(fn, parts: dict, what: str, n: int = 5
                     ) -> tuple[dict, dict]:
    """Device ms a launch of each part's kernels (those whose name holds
    the part's key; one launch a call of ``fn(i)``), over the launches
    the profiler recorded, and those launches. A session runs ``fn`` n
    times, waits ``PROFILE_LEAD_S`` and runs it n times more; one that
    recorded no launch of some part is taken again with four times the
    calls, twice at most. Raises if a part still has none."""
    from torch.profiler import ProfilerActivity, profile
    for calls in (n, 4 * n, 16 * n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fn(i)
            torch.cuda.synchronize()
            time.sleep(PROFILE_LEAD_S)
            for i in range(calls):
                fn(i)
            torch.cuda.synchronize()
        kernels = device_kernels(prof, 1)
        ms, seen = {}, {}
        for part, key in parts.items():
            hits = [(c, t) for name, c, t in kernels if key in name]
            seen[part] = int(sum(c for c, _ in hits))
            ms[part] = sum(t for _, t in hits) / max(seen[part], 1)
        if all(seen.values()):
            break
    require_device_time(what, ms)
    return ms, seen


def device_kernels(prof, per: int) -> list:
    """(name, calls, device ms) of every CUDA kernel in a profile, per
    ``per`` repetitions, largest first."""
    kernels = [(e.key, e.count / per, e.self_device_time_total / per / 1e3)
               for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    return sorted(kernels, key=lambda k: -k[2])


def decode_steps_timed(model, params, prompts, n_steps, eager: bool
                       ) -> dict:
    """A full engine (8 busy slots), graphed or eager: 3 steps (the graph's
    warm-up and capture among them), then ``n_steps`` by host clock, then
    ``n_steps`` under the profiler for device busy time by kernel; in the
    graphed profiled window the launch counters against the profiler's
    kernel executions. Returns the step's stats."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request, ServingEngine
    eng = ServingEngine(model, params, n_slots=B, max_len=S, seed=SEED)
    if eager:
        eng._decode = eng._decode.fn
    # every slot stays busy through the warm-up, both windows and the
    # retake of ``hold_launches`` (3 + 3 x n_steps steps, with a margin)
    for p in prompts:
        eng.submit(Request(p, max_new_tokens=max(4 * n_steps,
                                                 3 * n_steps + 5)))
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_steps * 1e3
    rows = [eng.cache["index"].clamp(max=S).sum().item()]
    before = kernel_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    rows.append(eng.cache["index"].clamp(max=S).sum().item())
    if not eager:
        attends = model.cfg.family != "ssm"
        hold_launches(f"{model.cfg.name} decode, {n_steps} replays", before,
                      prof, ("decode_attention",) if attends else (),
                      lambda: [eng.step() for _ in range(n_steps)])
    kernels = device_kernels(prof, n_steps)
    busy_ms = sum(ms for _, _, ms in kernels)
    require_device_time(f"{model.cfg.name} decode step", {"step": busy_ms})
    return {"decode_step_ms": step_ms,
            "kv_rows": sum(rows) / 2,     # cached rows a profiled step reads
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1 - busy_ms / step_ms,
            "top_kernels_per_step": [[name[:60], calls, ms]
                                     for name, calls, ms in kernels[:6]]}


def where_the_time_goes(model, params, rng, n_steps=10):
    """Decode steps of a full engine, graphed and eager on the same
    prompts (``decode_steps_timed``); prefill time of one request at a few
    prompt lengths, and the longest prefill under the profiler. The
    graphed step's numbers are the top-level keys."""
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    if cfg.family in ("dense", "moe", "vlm"):
        lens, prefill_lens = (8, 1500, 1024, 300, 500, 700, 900, 100), \
            (1500, 1024, 300)
    else:
        lens, prefill_lens = (8, 1536, 1024, 256, 512, 100, 200, 37), \
            (1536, 1024, 256)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    graphed = decode_steps_timed(model, params, prompts, n_steps, False)
    eager = decode_steps_timed(model, params, prompts, n_steps, True)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
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
    stats = {"arch": cfg.name, **graphed,
             "eager": {k: eager[k] for k in (
                 "decode_step_ms", "device_busy_ms_per_step",
                 "device_idle_share")},
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
def forced_decode_step(model, compiled: bool = True):
    """``step(params, tokens, cache)`` -> the (B, V) logits of one decode
    step of ``model`` on ``cache``, the tokens (B, 1) copied into a static
    buffer first: the engine's own step (``serve.engine.greedy_step``),
    graphed as the engine's is unless ``compiled`` is False (where Python
    must run at every step, as ``recording_routing`` needs). The logits
    are the step's output, overwritten by its next call."""
    from repro_torch.graphs import CompiledStep
    from repro_torch.serve.engine import greedy_step
    run = functools.partial(greedy_step, model)
    if compiled:
        run = CompiledStep(run, DEV)
    held = []

    def step(params, tokens, cache):
        if not held:
            held.append(torch.empty_like(tokens, dtype=torch.int64))
        held[0].copy_(tokens)
        return run(params, held[0], cache)[0]
    return step


def teacher_forced_logits(model, params, prompt, generated,
                          state_from=None, compiled=True):
    """(n - 1, V) logits of the decode steps of one stream of n tokens, fed
    its own tokens, on a one-slot cache (``forced_decode_step``).
    ``state_from``, another prompt, plants a fault: the SSM state its
    prefill leaves (without one, its KV cache) replaces the stream's own
    before the first decode step, as a slot mix-up would."""
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
    step = forced_decode_step(model, compiled)
    fed = torch.as_tensor(np.asarray(generated[:-1], np.int64), device=DEV)
    return torch.stack([step(params, fed[t].reshape(1, 1), cache)[0].clone()
                        for t in range(fed.shape[0])])


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
    step = forced_decode_step(model)
    return torch.stack([step(params, toks[:, t:t + 1], eng.cache).clone()
                        for t in range(toks.shape[1])], dim=1)


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
            # routing is recorded where Python runs every step: eagerly
            want = forced(plain, req, compiled=cfg.family != "moe").float()
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


def q_offset_of(shape) -> int:
    """A flash shape's causal query offset: its ninth entry, else 0."""
    return shape[8] if len(shape) > 8 else 0


def check_flash_attention(shapes=FLASH_SHAPES):
    """Forward against the plain version, dq/dk/dv against autograd
    through it, fp32 and bf16, at every shape of ``shapes`` (each at its
    ``q_offset_of``)."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    rows = []
    for i, shape in enumerate(shapes):
        name, B, T, S, Hq, Hkv, hd, causal = shape[:8]
        off = q_offset_of(shape)
        row = {"shape": name, "B": B, "T": T, "S": S, "Hq": Hq, "Hkv": Hkv,
               "hd": hd, "causal": causal, "q_offset": off,
               "bf16_fwd_route": fk.fwd_route(torch.bfloat16, hd),
               "bf16_bwd_route": fk.bwd_route(torch.bfloat16, hd)}
        for dtype, key in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            if fk.library_fwd_route(dtype, hd) != fk.fwd_route(dtype, hd) \
                    or fk.library_bwd_route(dtype, hd) != \
                    fk.bwd_route(dtype, hd):
                raise AssertionError(f"route table of the library and of "
                                     f"the wrapper differ at {dtype} {hd}")
            q, k, v, do = flash_inputs(B, T, S, Hq, Hkv, hd, dtype, SEED + i)
            out, lse = fk.flash_attention_fwd(q, k, v, causal, off)
            grads = fk.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                           off)
            again, again_lse = fk.flash_attention_fwd(q, k, v, causal, off)
            if not (torch.equal(again, out) and torch.equal(again_lse, lse)):
                raise AssertionError("repeated flash forwards differ")
            torch.cuda.synchronize()
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            want = ref.flash_attention_ref(*leaves, causal=causal,
                                           q_offset=off)
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
    dQ), from the profiler over eager backward launches
    (``kernel_breakdown``), and the launches it recorded."""
    times, seen = kernel_breakdown(
        bwd, {"delta": "delta", "dkdv": "dkdv", "dq": "_dq_"},
        "flash backward kernels", n)
    return {**times, "recorded": seen}


def time_flash_attention(shape=FLASH_SHAPES[0]):
    """Kernel, plain version and SDPA at a training shape (smollm-135m's
    unless given) in bf16: forward, forward + backward (autograd) and, for
    the kernel, the backward launch alone. The backward of the plain
    version and of SDPA is their forward + backward less their forward."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    _, B, T, S, Hq, Hkv, hd, _ = shape
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
    bounds = flash_bound(shape, torch.bfloat16)
    flops = bounds.pop("flops")
    row = {"shape": shape[0],
           "fwd_route": fk.fwd_route(torch.bfloat16, hd),
           "bwd_route": fk.bwd_route(torch.bfloat16, hd), **times, **bounds,
           "fwd_tflop_per_s": flops / times["fwd_ms"] / 1e9,
           "bwd_tflop_per_s": 2.5 * flops / times["bwd_ms"] / 1e9}
    log(f"[kernel] flash_attention timing {json.dumps(row)}")
    return row


def flash_bound(shape, dtype) -> dict:
    """The least time of a causal forward and backward at a shape: their
    operations at the peak for the inputs' type (the tensor cores for bf16,
    the CUDA cores for fp32) or their bytes (each input read once, each
    output written once), whichever is larger. Query row i sees
    ``q_offset + i + 1`` keys (``q_offset_of``; T == S at offset 0)."""
    _, B, T, S, Hq, Hkv, hd, _ = shape[:8]
    off = q_offset_of(shape)
    elt = torch.finfo(dtype).bits // 8
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    io = (2 * B * T * Hq * hd + 2 * B * S * Hkv * hd) * elt   # q, k, v, out
    flops = 4 * B * Hq * hd * (T * off + T * (T + 1) // 2)
    bounds = {"flops": flops}
    for key, nbytes, ops in (
            ("fwd", io + 4 * B * Hq * T, flops),
            # reads q, k, v, out, dout, lse; writes dq, dk, dv
            ("bwd", 2 * io + B * T * Hq * hd * elt + 4 * B * Hq * T,
             2.5 * flops)):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / peak * 1e3
        bounds[f"{key}_bound_ms"] = max(bytes_ms, ops_ms)
        bounds[f"{key}_bound_by"] = "bytes" if bytes_ms >= ops_ms \
            else "operations"
    return bounds


def time_flash_route(dtype, shape) -> dict:
    """The kernel's forward and backward launches and SDPA's forward and
    backward (its forward + backward less its forward), device ms from
    graph replays, at one causal shape with T == S."""
    from repro_torch.kernels import flash_attention as fk
    name, B, T, S, Hq, Hkv, hd, causal = shape
    q, k, v, do = flash_inputs(B, T, S, Hq, Hkv, hd, dtype, SEED)
    out, lse = fk.flash_attention_fwd(q, k, v, causal)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    leaves = [x.clone().requires_grad_(True) for x in (qt, kt, vt)]
    lib_fwd = lambda i: sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
    lib_both = lambda i: torch.autograd.grad(
        sdpa(*leaves, is_causal=causal, enable_gqa=True), leaves,
        do.transpose(1, 2))
    times = {
        "fwd_ms": device_ms(lambda i: fk.flash_attention_fwd(q, k, v,
                                                             causal), 10),
        "bwd_ms": device_ms(lambda i: fk.flash_attention_bwd(
            q, k, v, out, lse, do, causal), 5),
        "library_fwd_ms": device_ms(lib_fwd, 10)}
    times["library_bwd_ms"] = device_ms(lib_both, 5) - times["library_fwd_ms"]
    bounds = flash_bound(shape, dtype)
    row = {"shape": name, "dtype": str(dtype).split(".")[-1], "hd": hd,
           "fwd_route": fk.fwd_route(dtype, hd),
           "bwd_route": fk.bwd_route(dtype, hd), **times, **bounds,
           "fwd_over_library": times["fwd_ms"] / times["library_fwd_ms"],
           "bwd_over_library": times["bwd_ms"] / times["library_bwd_ms"],
           "fwd_tflop_per_s": bounds["flops"] / times["fwd_ms"] / 1e9,
           "bwd_tflop_per_s": 2.5 * bounds["flops"] / times["bwd_ms"] / 1e9}
    log(f"[kernel] flash_attention route timing {json.dumps(row)}")
    return row


def time_flash_offset(shape) -> dict:
    """bf16 at a causal shape with a query offset: the kernel's forward and
    backward launches, the same at offset 0 (the same T and S: rows that
    see fewer keys), the plain version's and SDPA's (its mask the offset
    rows', K and V repeated to the query heads before the timing) forward
    and backward (forward + backward less forward), device ms from graph
    replays, beside the bound of the offset call."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref
    name, B, T, S, Hq, Hkv, hd, _ = shape[:8]
    off = q_offset_of(shape)
    q, k, v, do = flash_inputs(B, T, S, Hq, Hkv, hd, torch.bfloat16, SEED)
    times = {}
    for key, o in (("", off), ("offset0_", 0)):
        out, lse = fk.flash_attention_fwd(q, k, v, True, o)
        times[f"{key}fwd_ms"] = device_ms(
            lambda i, o=o: fk.flash_attention_fwd(q, k, v, True, o), 10)
        times[f"{key}bwd_ms"] = device_ms(
            lambda i, o=o, out=out, lse=lse: fk.flash_attention_bwd(
                q, k, v, out, lse, do, True, o), 5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = Hq // Hkv
    mask = torch.arange(T, device=DEV)[:, None] + off >= \
        torch.arange(S, device=DEV)[None, :]
    impls = {"plain_": (lambda a, b, c: ref.flash_attention_ref(
                 a, b, c, causal=True, q_offset=off), (q, k, v), do),
             "library_": (lambda a, b, c: sdpa(a, b, c, attn_mask=mask),
                          (q.transpose(1, 2),
                           k.repeat_interleave(g, 2).transpose(1, 2),
                           v.repeat_interleave(g, 2).transpose(1, 2)),
                          do.transpose(1, 2))}
    for key, (f, args, grad_out) in impls.items():
        leaves = [t.clone().requires_grad_(True) for t in args]
        times[f"{key}fwd_ms"] = device_ms(lambda i, f=f, a=args: f(*a), 5)
        both = device_ms(lambda i, f=f, lv=leaves, go=grad_out:
                         torch.autograd.grad(f(*lv), lv, go), 3)
        times[f"{key}bwd_ms"] = both - times[f"{key}fwd_ms"]
        del leaves
    bounds = flash_bound(shape, torch.bfloat16)
    row = {"shape": name, "dtype": "bfloat16", "q_offset": off,
           **times, **bounds,
           "fwd_tflop_per_s": bounds["flops"] / times["fwd_ms"] / 1e9,
           "bwd_tflop_per_s": 2.5 * bounds["flops"] / times["bwd_ms"] / 1e9}
    log(f"[kernel] flash_attention offset timing {json.dumps(row)}")
    torch.cuda.empty_cache()
    return row


def time_flash_routes() -> list:
    """``time_flash_route`` at every entry of ROUTE_SHAPES."""
    rows = [time_flash_route(dtype, shape) for dtype, shape in ROUTE_SHAPES]
    torch.cuda.empty_cache()
    return rows


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


def fresh_training(cfg, mesh=None, compress=None, graphed=False,
                   B=TRAIN_B, T=TRAIN_T, opt_cfg=None):
    """(model, train state, step, data of B x T batches) from the seed; on
    ``mesh`` the state is placed by its specs and the step is the sharded
    one; ``graphed``: the state and compiled step of ``make_training``;
    ``opt_cfg``: the optimizer (AdamW by default)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.transformer import build_model
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import OptimizerConfig, build_optimizer
    from repro_torch.train.train_step import (build_train_step,
                                              init_train_state,
                                              make_training)
    model = build_model(cfg, device=DEV)
    opt_cfg = opt_cfg or OptimizerConfig(peak_lr=3e-3, warmup=2,
                                         total_steps=100)
    generator = torch.Generator(device=DEV).manual_seed(SEED)
    data = SyntheticLM(DataConfig(cfg.vocab_size, T, B, seed=SEED),
                       device=DEV)
    if graphed:
        return (model, *make_training(model, opt_cfg, generator), data)
    opt = build_optimizer(opt_cfg)
    state = init_train_state(model, opt, generator)
    if mesh is None:
        return model, state, build_train_step(model, opt,
                                              compress=compress), data
    pspecs = shd.fit_tree(mesh, shd.param_specs(cfg, mesh), state["params"])
    specs = shd.train_state_specs(state, opt_cfg.name, pspecs)
    state = shd.place_state(cfg, mesh, state, shd.to_named(mesh, specs))
    return model, state, shd.shard_train_step(model, opt, mesh,
                                              compress=compress), data


def train_graphed_against_eager(cfg, label="[profile train]"):
    """The eager train step (``build_train_step``) and the graphed one
    (``make_training``), each from the seed on the same batches (B 8, T
    2048), ``GRAPH_TRAIN_STEPS`` steps, the last under the profiler: the
    losses and grad norms bit-identical; each run's host ms a step (step
    3, the graph's first replay alone), device busy ms by
    kernel, idle share and peak memory, the graphed peak at most
    ``GRAPH_PEAK_RATIO`` times the eager; in the graphed profiled step,
    each launch counter's delta equal to the profiler's count of its
    kernel. Returns the graphed run's stats with the eager run's beside
    them; with the SSD scan the scan's forward passes (2 to 4), backward
    passes (b2 to b6) and C B^T (pass 1, which both run) where the model
    has them."""
    from torch.profiler import ProfilerActivity, profile
    runs = {}
    for mode in ("eager", "graphed"):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, state, step, data = fresh_training(cfg, graphed=mode == "graphed")
        metrics, host = [], []
        for i in range(GRAPH_TRAIN_STEPS):
            last = i == GRAPH_TRAIN_STEPS - 1
            before = kernel_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) if last
                  else contextlib.nullcontext()) as prof:
                state, m = step(state, data.batch(i))
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
                torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        if mode == "graphed":
            if step.compiled.replays != GRAPH_TRAIN_STEPS - 1:
                raise AssertionError(f"{step.compiled.replays} replays of "
                                     f"{GRAPH_TRAIN_STEPS} steps")
            expect = (("flash_attention_fwd", "flash_attention_bwd")
                      if cfg.family != "ssm" else ()) + \
                (("ssd_scan_fwd", "ssd_scan_bwd") if cfg.ssm_state else ())
            hold_launches(f"{cfg.name} train step, one replay", before,
                          prof, expect, lambda: float(step(
                              state, data.batch(GRAPH_TRAIN_STEPS))[1]
                              ["loss"]))
        kernels = [(e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and e.self_device_time_total]
        busy_ms = sum(ms for _, _, ms in kernels)
        step_ms = host[2]
        top = sorted(kernels, key=lambda k: -k[2])[:8]
        flash = {part: sum(ms for name, _, ms in kernels
                           if f"flash_{part}" in name)
                 for part in ("fwd", "delta", "dkdv", "dq")}
        require_device_time(f"{label} {cfg.name} {mode}", {"step": busy_ms})
        if cfg.family != "ssm":
            require_device_time(f"{label} {cfg.name} {mode} flash", flash)
        stats = {"train_step_ms": step_ms, "step_ms": host,
                 "device_busy_ms_per_step": busy_ms,
                 "device_idle_share": 1 - busy_ms / step_ms,
                 "peak_memory_gb": (torch.cuda.max_memory_allocated()
                                    - base) / 1e9,
                 "flash_ms_per_step": flash,
                 "top_kernels_per_step": [[name[:80], calls, ms]
                                          for name, calls, ms in top]}
        if cfg.ssm_state:
            stats["scan_ms_per_step"] = {
                part: sum(ms for name, _, ms in kernels
                          if any(f"ssd_{k}_kernel" in name for k in keys))
                for part, keys in (("forward", ("summary", "state",
                                                "output")),
                                   ("backward", ("grad_summary",
                                                 "grad_state", "grad_panel",
                                                 "grad_du", "grad_bc")),
                                   ("cb", ("cb",)))}
            require_device_time(f"{label} {cfg.name} {mode} ssd_scan",
                                stats["scan_ms_per_step"])
        runs[mode] = stats, metrics
        del state, step, data, m, prof
    (eager, want), (graphed, got) = runs["eager"], runs["graphed"]
    ratio = graphed["peak_memory_gb"] / eager["peak_memory_gb"]
    stats = {"arch": cfg.name, **graphed, "eager": eager,
             "loss_grad_norm": got, "bit_identical": got == want,
             "graphed_over_eager_peak": ratio}
    log(f"{label} {json.dumps(stats)}")
    if got != want:
        raise AssertionError(f"{cfg.name}: graphed train steps {got}, eager "
                             f"{want}")
    if ratio > GRAPH_PEAK_RATIO:
        raise AssertionError(f"{cfg.name}: the graphed step's peak is "
                             f"{ratio:.4f} times the eager step's")
    return stats


def adafactor_graphed_against_eager(cfg) -> dict:
    """Phase 8's graphed-against-eager check with Adafactor, the optimizer
    of kimi-k2-1t-a32b (``launch.build.OPT_FOR_ARCH``: no momentum; each
    stacked leaf updated a layer at a time, its RMS clip over the whole
    leaf), at ``cfg``'s full width: the eager step and ``make_training``'s
    (call 1 eager, call 2 its capture and first replay),
    ``ADAFACTOR_GRAPH_STEPS`` steps each from the seed on the same batches
    (B 8, T 2048): losses and grad norms bit-identical, the graphed peak at
    most ``GRAPH_PEAK_RATIO`` times the eager. Adafactor's capture on the
    card."""
    from repro_torch.launch.build import OPT_FOR_ARCH
    opt_cfg = replace(OPT_FOR_ARCH["kimi-k2-1t-a32b"], peak_lr=3e-3,
                      warmup=2, total_steps=100)
    runs = {}
    for mode in ("eager", "graphed"):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, state, step, data = fresh_training(
            cfg, graphed=mode == "graphed", opt_cfg=opt_cfg)
        metrics, host = [], []
        for i in range(ADAFACTOR_GRAPH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, data.batch(i))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            host.append((time.perf_counter() - t0) * 1e3)
        if mode == "graphed" and \
                step.compiled.replays != ADAFACTOR_GRAPH_STEPS - 1:
            raise AssertionError(f"{step.compiled.replays} replays of "
                                 f"{ADAFACTOR_GRAPH_STEPS} Adafactor steps")
        runs[mode] = {"loss_grad_norm": metrics, "step_ms": host,
                      "peak_memory_gb": (torch.cuda.max_memory_allocated()
                                         - base) / 1e9}
        del state, step, data, m
    eager, graphed = runs["eager"], runs["graphed"]
    ratio = graphed["peak_memory_gb"] / eager["peak_memory_gb"]
    stats = {"arch": cfg.name, "optimizer": "adafactor", **graphed,
             "eager": eager, "bit_identical": (graphed["loss_grad_norm"]
                                               == eager["loss_grad_norm"]),
             "graphed_over_eager_peak": ratio}
    log(f"[profile train adafactor] {json.dumps(stats)}")
    if not stats["bit_identical"] or not all(
            np.isfinite(eager["loss_grad_norm"]).flat):
        raise AssertionError(f"{cfg.name}: graphed Adafactor steps "
                             f"{graphed['loss_grad_norm']}, eager "
                             f"{eager['loss_grad_norm']}")
    if ratio > GRAPH_PEAK_RATIO:
        raise AssertionError(f"{cfg.name}: the graphed Adafactor step's "
                             f"peak is {ratio:.4f} times the eager step's")
    return stats


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


def check_ssd_scan(shapes=SSD_SHAPES):
    """The kernel against the chunked plain version and the sequential
    recurrence at every shape of ``shapes``; the first also at chunk 64
    against chunk 256."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    rows = []
    for i, (name, B, T, H, P, N, Q, h0) in enumerate(shapes):
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


def time_ssd_scan(shape):
    """Kernel and chunked plain version at ``shape`` (an entry of
    SSD_SHAPES or TP_SSD_SHAPES), with the device ms of each of the
    kernel's passes. No single PyTorch call computes the scan, so there is
    no library time."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_plan, ssd_scan
    name, B, T, H, P, N, Q, _ = shape
    u, loga, Bm, Cm, _ = ssd_inputs(B, T, H, P, N, False, SEED)
    calls = {"": lambda i: ssd_scan(u, loga, Bm, Cm, chunk=Q),
             "plain_": lambda i: ref.ssd_scan_ref(u, loga, Bm, Cm, chunk=Q)}
    times = {}
    for key, fn in calls.items():
        times[f"{key}ms"] = device_ms(fn, 10)
        times[f"{key}eager_ms"] = eager_ms(fn, 10)
    times["pass_ms"], times["pass_recorded"] = kernel_breakdown(
        calls[""], {key: f"ssd_{key}_kernel"
                    for key in ("cb", "summary", "state", "output")},
        f"ssd_scan passes at {name}")
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
    captured = graph_captures()
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
    in_runs, captured = graph_captures(captured), graph_captures()
    t_alone = time.perf_counter()
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
             "alone_s": time.perf_counter() - t_alone,
             "graph_captures": {"runs": in_runs,
                                "alone": graph_captures(captured)},
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
    captured = graph_captures()
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
    in_runs, captured = graph_captures(captured), graph_captures()
    t_alone = time.perf_counter()
    alone = rlhf.check_alone(svc.engine, executor)
    alone_s = time.perf_counter() - t_alone
    in_alone = graph_captures(captured)
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
             "payloads_checked_alone": alone, "alone_s": alone_s,
             "graph_captures": {"runs": in_runs, "alone": in_alone},
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
    captured = graph_captures()
    t0 = time.perf_counter()
    report = scenario.run(sc, svc, mode=mode,
                          actions=FaultActions({"worker-a": preempt}))
    run_s = time.perf_counter() - t0
    in_run, captured = graph_captures(captured), graph_captures()
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
    t_alone = time.perf_counter()
    alone = rlhf.check_alone(svc.engine, executor)
    alone_s = time.perf_counter() - t_alone
    stats = {"scenario": stem, "arch": executor.cfg.name,
             "report": {k: v for k, v in report.items() if k != "cost"},
             "modelled_cost": report["cost"],
             "sim_executor_dedup": sim, "engine": engine,
             "crash": crash or None, "payloads_checked_alone": alone,
             "alone_s": alone_s,
             "graph_captures": {"run": in_run,
                                "alone": graph_captures(captured)},
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
    moe_breakdown(model, params, where_the_time_goes(
        model, params, rng, n_steps=LATE_PROFILE_STEPS))
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
        where_the_time_goes(model, params, rng,
                            n_steps=LATE_PROFILE_STEPS))
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


# -------------------------------------------------------------- phase 21 --
# The SSD scan's backward kernel against ref.ssd_scan_bwd_ref and autograd
# through ref.ssd_scan_ref, fp32: max |error| <= 1e-4 of each gradient's
# max |value|, as phase 9 holds fp32 leaves. All three accumulate in fp32,
# in another order (the kernel over 64 x 64 tiles and heads in order); an
# H100 run read 7.9e-6 at most (zamba2's training shape), a dropped or
# misplaced term reads order 1.
SSD_BWD_TOL = 1e-4
# the two training shapes (name, B, T, H, P, N, Q, h0), the timed one first
SSD_TRAIN_SHAPES = [("mamba2-1.3b train", 8, 2048, 64, 64, 128, 256, False),
                    ("zamba2-2.7b train", 8, 2048, 80, 64, 64, 256, False)]
SSD_GRADS = ("du", "dloga", "dBm", "dCm", "dh0")
# bf16 train parity of the SSM families at full depth (B 8, T 2048): the
# kernels against the plain scan (and, for zamba2, the plain attention) on
# one step's loss and gradients. These bf16 models amplify fp32-level
# differences (see BF16_SSM_LOGIT_ATOL), so the bound is set by a control
# measured in the same run: the plain scan at chunk 128 against chunk 256,
# the same products summed in another order. The kernels may differ from
# the plain path by SSM_TRAIN_CONTROL_FACTOR times the control, in each
# leaf's relative L2 error and in the loss (plus one bf16 ulp of the loss,
# 2^-8 of it, as both paths round to bf16 at other places). The planted
# fault, the kernels with the dloga term dropped, must exceed the leaf
# bound (A_log's gradient comes through dloga alone). H100 run: mamba2's
# kernels 0.062 against a control of 0.054, zamba2's 0.132 against 0.060
# (its kernels also round flash's P and dS to bf16, which the control
# leaves alone); the fault 1.0 in both.
SSM_TRAIN_CONTROL_FACTOR = 3.0


def ssd_grad_inputs(B, T, H, P, N, h0, seed):
    """``ssd_inputs``, then dy ~ N and the final state's gradient ~ N."""
    *args, init = ssd_inputs(B, T, H, P, N, h0, seed)
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    dy = torch.randn((B, T, H, P), generator=gen, device=DEV)
    dstate = torch.randn((B, H, N, P), generator=gen, device=DEV)
    return (*args, init, dy, dstate)


def scan_bwd_call(u, loga, Bm, Cm, init, dy, dstate, Q):
    """The kernels' forward (keeping the chunk states), then a function
    that launches the backward on them and the forward's (y, final state,
    chunk states)."""
    from repro_torch.kernels import ssd_scan as sk
    B, T, H, P = u.shape
    states = torch.empty((B, T // Q, H, Bm.shape[-1], P), device=DEV)
    y, state = sk.ssd_scan_fwd(u, loga, Bm, Cm, chunk=Q, h0=init,
                               chunk_states=states)
    return (lambda i=0: sk.ssd_scan_bwd(u, loga, Bm, Cm, states, dy, dstate,
                                        chunk=Q)), (y, state, states)


def check_ssd_scan_bwd(shapes=SSD_SHAPES + SSD_TRAIN_SHAPES):
    """(a) The backward kernel against both plain versions at every shape
    of ``shapes`` (those of SSD_SHAPES and both training shapes unless
    given), with a nonzero dstate (and h0 where the shape has one);
    repeated calls bit-identical. The forward that keeps the chunk states,
    against the chunked plain version: y, the final state and the states
    entering each chunk, which the backward reads. Returns the rows."""
    from repro_torch.kernels import ref
    rows = []
    for i, (name, B, T, H, P, N, Q, h0) in enumerate(shapes):
        u, loga, Bm, Cm, init, dy, ds = ssd_grad_inputs(B, T, H, P, N, h0,
                                                        SEED + 100 + i)
        bwd, (y, state, states) = scan_bwd_call(u, loga, Bm, Cm, init, dy,
                                                ds, Q)
        got = bwd()
        torch.cuda.synchronize()
        row = {"shape": name, "B": B, "T": T, "H": H, "P": P, "N": N,
               "chunk": Q, "h0": h0}
        y_c, s_c = ref.ssd_scan_ref(u, loga, Bm, Cm, chunk=Q, h0=init)
        row["fwd_y_err"] = max_err(y, y_c, SSD_TOL)
        row["fwd_state_err"] = max_err(state, s_c, SSD_TOL)
        row["fwd_chunk_states_err"] = max_err(
            states, ref.ssd_chunk_states(u, loga, Bm, chunk=Q, h0=init)[0],
            SSD_TOL)
        del y, state, y_c, s_c
        plain = ref.ssd_scan_bwd_ref(u, loga, Bm, Cm, init, dy, ds, chunk=Q)
        row["max_abs_err"] = max((g - w).abs().max().item()
                                 for g, w in zip(got, plain))
        leaves = [x.clone().requires_grad_(True)
                  for x in (u, loga, Bm, Cm, init) if x is not None]
        y, s = ref.ssd_scan_ref(*leaves[:4], chunk=Q,
                                h0=leaves[4] if h0 else None)
        auto = torch.autograd.grad((y * dy).sum() + (s * ds).sum(), leaves)
        del y, s, leaves
        for label, want in (("plain", plain), ("autograd", auto)):
            for g_name, g, w in zip(SSD_GRADS, got, want):
                err = ((g - w).abs().max() / w.abs().max()).item()
                row[f"{g_name}_err_{label}"] = err
                if not err <= SSD_BWD_TOL:
                    raise AssertionError(f"ssd_scan backward {g_name} at "
                                         f"{name} off {label}: {err:.3e}")
        del plain, auto
        for _ in range(2):
            if not all(torch.equal(a, b) for a, b in zip(bwd(), got)):
                raise AssertionError(f"ssd_scan backward at {name}: "
                                     "repeated calls differ")
        log(f"[kernel] ssd_scan backward check {json.dumps(row)}")
        rows.append(row)
        del got, bwd, states, u, loga, Bm, Cm, init, dy, ds
        torch.cuda.empty_cache()
    return rows


def ssd_bwd_graph_replays():
    """The backward kernel under CUDA-graph replay at the h0 shape of
    SSD_SHAPES: bit-identical replays, also after new inputs are copied
    into the captured tensors."""
    name, B, T, H, P, N, Q, h0 = SSD_SHAPES[3]
    args = list(ssd_grad_inputs(B, T, H, P, N, h0, SEED + 7))
    bwd, _ = scan_bwd_call(*args, Q)
    first = [g.clone() for g in bwd()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bwd()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = bwd()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(static, first)):
            raise AssertionError("ssd_scan backward: a graph replay differs")
    # new inputs in the captured tensors (the chunk states stay as the
    # forward left them: replay and eager call read the same)
    for dst, src in zip(args, ssd_grad_inputs(B, T, H, P, N, h0, SEED + 8)):
        if dst is not None:
            dst.copy_(src)
    graph.replay()
    eager = bwd()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(static, eager)):
        raise AssertionError("ssd_scan backward: a replay on new inputs "
                             "differs from the eager call")
    log(f"[kernel] ssd_scan backward: graph replays bit-identical "
        f"({name})")


def time_ssd_scan_bwd(shape=SSD_TRAIN_SHAPES[0]):
    """(b) The backward kernel, each of its passes and the plain version
    (autograd through ref.ssd_scan_ref: its forward + backward less its
    forward) at ``shape`` (mamba2-1.3b's training shape unless given),
    beside the bound. No single PyTorch call computes the scan or its
    gradient."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_bwd_plan
    name, B, T, H, P, N, Q, _ = shape
    u, loga, Bm, Cm, _, dy, _ = ssd_grad_inputs(B, T, H, P, N, False, SEED)
    bwd, _ = scan_bwd_call(u, loga, Bm, Cm, None, dy, None, Q)
    times = {"ms": device_ms(bwd, 5), "eager_ms": eager_ms(bwd, 5)}
    times["pass_ms"], times["pass_recorded"] = kernel_breakdown(
        bwd, {key: f"ssd_{key}_kernel"
              for key in ("cb", "grad_summary", "grad_state", "grad_panel",
                          "grad_du", "grad_bc")},
        f"ssd_scan backward passes at {name}")
    del bwd
    leaves = [x.clone().requires_grad_(True) for x in (u, loga, Bm, Cm)]
    fwd = lambda i: ref.ssd_scan_ref(u, loga, Bm, Cm, chunk=Q)
    both = lambda i: torch.autograd.grad(
        ref.ssd_scan_ref(*leaves, chunk=Q)[0], leaves, dy)
    times["plain_fwd_ms"] = device_ms(fwd, 2)
    times["plain_fwd_bwd_ms"] = device_ms(both, 2)
    times["plain_ms"] = times["plain_fwd_bwd_ms"] - times["plain_fwd_ms"]
    del leaves
    torch.cuda.empty_cache()
    # what the gradient needs, the causal half of each (Q, Q) product
    # counted: per chunk and head, b2's C^T dy, du's (C B^T * L)^T dy and
    # B g, the panel's dy u^T, dC's h dy^T and dB's u g^T; per chunk, C B^T
    # and the panel's products with B and C. dcum's C_k h dy_k term is C_k
    # dotted with dC's h dy_k, and its u_k g^T B_k term u_k dotted with
    # du's B g: Q N and Q P a head, left out as the bound's lower order.
    # The bytes: u, dy, du, loga, dloga, Bm, Cm, dBm, dCm, the chunk states
    # and dh0, each once.
    nc, tri = T // Q, Q * (Q + 1) // 2
    flops = 2 * B * nc * (H * (4 * Q * N * P + 2 * tri * P) + 3 * tri * N)
    nbytes = 4 * (3 * B * T * H * P + 2 * B * T * H + 4 * B * T * N
                  + B * nc * H * N * P + B * H * N * P)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    plan = ssd_bwd_plan(B, T, H, P, N, Q)
    row = {"shape": name, "route": "fp32 FMAs, CUDA cores, six passes",
           "blocks_per_pass": {k: int(np.prod(g))
                               for k, g in plan["grids"].items()},
           "gflop": flops / 1e9, "mbytes": nbytes / 1e6, **times,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "tflop_per_s": flops / times["ms"] / 1e9, "library_ms": None,
           "library_note": "no single PyTorch call computes the SSD scan "
                           "or its gradient"}
    log(f"[kernel] ssd_scan backward timing {json.dumps(row)}")
    return row


def train_ssm_full_width(cfg):
    """(c) ``launch.train`` at the full width of an SSM or hybrid config:
    finite, falling losses and every layer's scan (and, for the hybrid,
    every group's shared attention) through the kernels, forward twice
    under remat and backward once. Returns the run's stats and the
    launches (scan forward, scan backward, flash forward, flash
    backward)."""
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.launch import train
    counters = (sk.ssd_scan_fwd, sk.ssd_scan_bwd, fk.flash_attention_fwd,
                fk.flash_attention_bwd)
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    result = train.main(["--arch", cfg.name, "--steps",
                         str(SSM_TRAIN_STEPS), "--batch", str(TRAIN_B),
                         "--seq", str(TRAIN_T), "--lr", "3e-3", "--warmup",
                         "2", "--ckpt-every", "0", "--log-every", "1",
                         "--seed", str(SEED)])
    launches = tuple(fn.launches for fn in counters)
    losses = result["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name} losses not finite and falling: "
                             f"{losses}")
    passes = 2 if cfg.remat == "block" else 1
    groups = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
    want = tuple(n * SSM_TRAIN_STEPS for n in (passes * cfg.n_layers,
                                           cfg.n_layers, passes * groups,
                                           groups))
    if launches != want:
        raise AssertionError(f"{cfg.name} launches (scan fwd, scan bwd, "
                             f"flash fwd, flash bwd) {launches}, want {want}")
    step_ms = float(np.mean(result["step_s"][1:])) * 1e3
    stats = {"arch": cfg.name, "batch": TRAIN_B, "seq": TRAIN_T,
             "steps": SSM_TRAIN_STEPS, "step_ms_after_first": step_ms,
             "median_step_ms_after_first":
                 float(np.median(result["step_s"][1:])) * 1e3,
             "first_step_ms": result["step_s"][0] * 1e3,
             "tokens_per_s": TRAIN_B * TRAIN_T / step_ms * 1e3,
             "losses": losses, "grad_norms": result["grad_norms"],
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": dict(zip(("scan_fwd", "scan_bwd", "flash_fwd",
                                   "flash_bwd"), launches))}
    return stats, launches


def ssm_train_parity(cfg, n_layers, B=2, T=1024):
    """(d) One step's loss and gradients with the kernels against the plain
    scan (and, for the hybrid, the plain attention): fp32 at ``n_layers``
    on B x T tokens at phase 9's tolerances; bf16 at the full config on
    TRAIN_B x TRAIN_T beside the control and the planted fault of
    SSM_TRAIN_CONTROL_FACTOR."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as sk
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.transformer import HybridLM, MambaLM
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.train_step import value_and_grad

    class ScanWithoutDloga(sk.SSDScan):
        """The planted fault: the kernels with the dloga term dropped."""

        @staticmethod
        def backward(ctx, dy, dstate):
            du, _, *rest = sk.SSDScan.backward(ctx, dy, dstate)
            return du, None, *rest

    def faulty_scan(u, loga, Bm, Cm, *, chunk, h0=None):
        return ScanWithoutDloga.apply(u, loga, Bm, Cm, h0, chunk)

    lm = MambaLM if cfg.family == "ssm" else HybridLM
    plain = {"ssd_scan": ref.ssd_scan_ref}
    if cfg.family == "hybrid":
        plain["flash_attention"] = ref.flash_attention_ref

    def step(c, params, batch, **kw):
        loss, grads = value_and_grad(lm(c, device=DEV, **kw).loss_fn, params,
                                     batch)
        return float(loss), tree_leaves(grads)

    def data(c, B, T):
        return SyntheticLM(DataConfig(c.vocab_size, T, B, seed=SEED + 1),
                           device=DEV).batch(0)

    # fp32 at reduced depth
    c32 = replace(cfg, n_layers=n_layers, param_dtype=torch.float32,
                  compute_dtype=torch.float32)
    params = lm(c32, device=DEV).init(torch.Generator(device=DEV)
                                      .manual_seed(SEED))
    batch = data(c32, B, T)
    loss, grads = step(c32, params, batch)
    want_loss, want = step(c32, params, batch, **plain)
    errs = [((g - w).abs().max() / w.abs().max()).item()
            for g, w in zip(grads, want)]
    worst = max(errs)
    # the worst leaf of both fp32 runs against the plain path in fp64: which
    # of the two sums is the nearer
    at = errs.index(worst)
    c64 = replace(c32, param_dtype=torch.float64, compute_dtype=torch.float64)
    _, exact = step(c64, tree_map(lambda x: x.double(), params), batch,
                    **plain)
    scale = exact[at].abs().max()
    vs64 = {key: ((g[at].double() - exact[at]).abs().max() / scale).item()
            for key, g in (("kernels", grads), ("plain", want))}
    del exact
    stats = {"arch": cfg.name, "dtype": "fp32", "layers": n_layers, "B": B,
             "T": T, "loss": loss, "plain_loss": want_loss,
             "abs_dloss": abs(loss - want_loss), "worst_leaf_grad_err": worst,
             "worst_leaf": [at, list(want[at].shape)],
             "worst_leaf_err_vs_fp64": vs64}
    log(f"[parity train ssm] {json.dumps(stats)}")
    if abs(loss - want_loss) > FP32_LOSS_RTOL * abs(want_loss) or \
            worst > FP32_GRAD_TOL:
        raise AssertionError(f"fp32 SSM train parity off: {stats}")
    del params, grads, want
    torch.cuda.empty_cache()

    # bf16 at full depth
    params = lm(cfg, device=DEV).init(torch.Generator(device=DEV)
                                      .manual_seed(SEED))
    batch = data(cfg, TRAIN_B, TRAIN_T)
    want_loss, want = step(cfg, params, batch, **plain)
    cases = {"kernels": (cfg, {}),
             "control": (replace(cfg, ssm_chunk=128), plain),
             "fault": (cfg, {"ssd_scan": faulty_scan})}
    errs = {}
    for label, (c, kw) in cases.items():
        loss, grads = step(c, params, batch, **kw)
        leaf = [((g.float() - w.float()).norm() / w.float().norm()).item()
                for g, w in zip(grads, want)]
        errs[label] = {"abs_dloss": abs(loss - want_loss),
                       "worst_leaf_grad_err": max(leaf),
                       "worst_leaf": leaf.index(max(leaf))}
        del grads
        torch.cuda.empty_cache()
    leaf_bound = SSM_TRAIN_CONTROL_FACTOR * \
        errs["control"]["worst_leaf_grad_err"]
    loss_bound = SSM_TRAIN_CONTROL_FACTOR * errs["control"]["abs_dloss"] \
        + 2 ** -8 * abs(want_loss)
    stats = {"arch": cfg.name, "dtype": "bf16", "layers": cfg.n_layers,
             "B": TRAIN_B, "T": TRAIN_T, "plain_loss": want_loss, **errs,
             "leaf_bound": leaf_bound, "loss_bound": loss_bound}
    log(f"[parity train ssm] {json.dumps(stats)}")
    kern = errs["kernels"]
    if kern["worst_leaf_grad_err"] > leaf_bound or \
            kern["abs_dloss"] > loss_bound:
        raise AssertionError(f"bf16 SSM train parity off: {stats}")
    if not errs["fault"]["worst_leaf_grad_err"] > leaf_bound:
        raise AssertionError(f"the planted fault passes the bf16 SSM train "
                             f"parity: {stats}")
    del params, want
    torch.cuda.empty_cache()


def ssd_bwd_kernel_phase():
    """Phase 21 (a) and (b), run right after phase 10: in one H100 run,
    after phases 15 to 20, the profiler read no device time over a region
    that launched the kernels of the libraries alone (cause not found), so
    the passes' times are taken here; ``require_device_time`` fails any
    profile that reads 0 for a part. Returns the backward's check rows and
    its timing."""
    rows = check_ssd_scan_bwd()
    ssd_bwd_graph_replays()
    timing = time_ssd_scan_bwd()
    time_flash_attention(ZAMBA_FLASH_TRAIN)
    torch.cuda.empty_cache()
    return rows, timing


def ssm_train_phase(mamba, zamba):
    """Phase 21 (c) and the profiled steps beside it, the timed part of
    the phase ((d), checks only, runs after it). Returns the main path's
    launches (scan forward, scan backward, flash forward, flash backward)
    in the two trainings."""
    t0 = time.perf_counter()
    launches = np.zeros(4, dtype=int)
    for cfg in (mamba, zamba):
        stats, counts = train_ssm_full_width(cfg)
        launches += counts
        torch.cuda.empty_cache()
        profiled = train_graphed_against_eager(
            cfg, label="[profile train ssm]")
        stats["profiled_step"] = {k: profiled[k] for k in (
            "device_busy_ms_per_step", "device_idle_share",
            "scan_ms_per_step", "flash_ms_per_step")}
        log(f"[train ssm] {json.dumps(stats)}")
        torch.cuda.empty_cache()
    log(f"[train ssm] trainings {time.perf_counter() - t0:.1f} s, launches "
        f"(scan fwd, scan bwd, flash fwd, flash bwd) {launches.tolist()}")
    return [int(n) for n in launches]


# -------------------------------------------------------------- phase 22 --
DIST_STEPS, COMPRESS_STEPS = 3, 6
# (e) mamba2-1.3b's sharded step at this many of its 48 layers
DIST_SSM_LAYERS = 4
PIPE_MICRO, PIPE_B = 4, 2
# (d) serve_step on the (1, 1) mesh: 8 prompts of 256 tokens into a cache
# of 512, then greedy decode steps
SERVE_B, SERVE_PROMPT, SERVE_LEN, SERVE_DECODES = 8, 256, 512, 4
# moe_block_ep against moe_block at qwen2-moe-a2.7b's width: the decode
# shape (8 slots) and a prefill; fp32 at a capacity factor where neither
# drops, the bounds of tests/test_distributed.py's EP test
EP_SHAPES = (("decode", B), ("prefill_1536", 1536))
EP_OUT_ATOL, EP_AUX_RTOL = 2e-5, 1e-4
EP_TIMED = 5
EP_GRADS = ("router", "w_gate", "w_up", "w_down", "x")
# (f) qwen2-moe-a2.7b's sharded step at this many of its 24 layers, fp32,
# on 2 x 1024 tokens; the bound of tests/test_torch_moe_parallel.py's
# losses
DIST_MOE_LAYERS, DIST_MOE_B, DIST_MOE_T = 4, 2, 1024
DIST_MOE_RTOL = 1e-5
# (g) whisper-tiny's sharded train step on 8 rows of this many decoder
# tokens (and 1500 seeded frames), and serve_step on a prompt of this many
# tokens into its text context
DIST_ENCDEC_T, DIST_ENCDEC_PROMPT = 448, 4


@contextlib.contextmanager
def nccl_group():
    """A process group of one rank over NCCL (a ``FileStore`` under
    ``build/``), destroyed on exit. An all-reduce starts the communicator:
    if NCCL cannot, the phase fails; there is no other backend."""
    import torch.distributed as dist
    store = ROOT / "build" / "nccl-store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        probe = torch.full((4,), 3.0, device=DEV)
        dist.all_reduce(probe)
        if dist.get_backend() != "nccl" or probe.tolist() != [3.0] * 4:
            raise AssertionError(f"NCCL did not start: {dist.get_backend()}"
                                 f" {probe.tolist()}")
        yield
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def profiled_ms(fn, n: int) -> dict:
    """``fn()`` n times under the profiler after a warm-up: the device busy
    ms a call (every kernel's) and the NCCL kernels' ms a call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof, n)
    return {"device_ms": sum(ms for _, _, ms in kernels),
            "nccl_ms": sum(ms for name, _, ms in kernels
                           if "nccl" in name.lower())}


@contextlib.contextmanager
def counting_routes():
    """The plans of the tensor-parallel routes the models take in the
    block (``tensor_parallel.route`` calls that return one)."""
    from repro_torch.distributed import tensor_parallel
    plans = []
    route = tensor_parallel.route

    def counted(*args, **kwargs):
        r = route(*args, **kwargs)
        if r is not None:
            plans.append(r.plan)
        return r

    tensor_parallel.route = counted
    try:
        yield plans
    finally:
        tensor_parallel.route = route


def require_routes(what: str, plans: list, n: int) -> None:
    """Fails unless the block took ``n`` tensor-parallel routes, each
    over a ``"model"`` axis of one rank."""
    if len(plans) != n or any(p.model != 1 for p in plans):
        raise AssertionError(f"{what}: tensor-parallel routes {plans}, "
                             f"want {n} on one rank")


def scan_launches(reset: bool = False) -> tuple[int, int]:
    """The scan's forward and backward launch counts, set to 0 first if
    ``reset``."""
    from repro_torch.kernels import ssd_scan as sk
    if reset:
        sk.ssd_scan_fwd.launches = 0
        sk.ssd_scan_bwd.launches = 0
    return sk.ssd_scan_fwd.launches, sk.ssd_scan_bwd.launches


def flash_launches(reset: bool = False) -> tuple[int, int]:
    from repro_torch.kernels import flash_attention as fk
    if reset:
        fk.flash_attention_fwd.launches = 0
        fk.flash_attention_bwd.launches = 0
    return fk.flash_attention_fwd.launches, fk.flash_attention_bwd.launches


def distributed_train(cfg, mesh) -> tuple[int, int]:
    """(a) The sharded train step on a (1, 1) ("data", "model") mesh
    against the unsharded step from the same seed, 3 steps of 8 x 2048:
    the sharded one through the tensor-parallel route (a route a step,
    its "model" axis of one rank, where each collective is the identity),
    each step's loss and grad norm and the params after 3 steps the same
    bits (on one rank every collective copies, and the loss's share of the
    global token count is 1.0 exactly); 2 x 30 forward and 30 backward
    flash launches a step; step ms, device busy ms, NCCL ms and peak
    memory of each. Then 6 compressed steps: finite falling losses, and the
    residual after the last is ``corrected - dequantized`` exactly.
    Returns the flash launches (forward, backward) in it."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.compression import (
        dequantize_int8, make_error_feedback_compressor, quantize_int8)
    from repro_torch.models.common import tree_leaves
    whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    total = np.zeros(2, dtype=int)
    runs = {}
    for label, on in (("unsharded", None), ("sharded", mesh)):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, state, step, data = fresh_training(cfg, mesh=on)
        flash_launches(reset=True)
        metrics, step_s = [], []
        with counting_routes() as plans:
            for i in range(DIST_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, data.batch(i))
                metrics.append((m["loss"].item(), m["grad_norm"].item()))
                step_s.append(time.perf_counter() - t0)
        require_routes(f"[distributed] {label}", plans,
                       DIST_STEPS if on is not None else 0)
        launches = flash_launches()
        want = (2 * cfg.n_layers * DIST_STEPS, cfg.n_layers * DIST_STEPS)
        if launches != want:
            raise AssertionError(f"{label}: flash launches {launches}, "
                                 f"want {want}")
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        prof = profiled_ms(lambda: step(state, data.batch(DIST_STEPS)), 1)
        require_device_time(f"[distributed] {label} step",
                            {"step": prof["device_ms"]})
        total += flash_launches()
        runs[label] = {"metrics": metrics,
                       "params": [whole(p) for p in
                                  tree_leaves(state["params"])],
                       "stats": {"step_ms": float(np.mean(step_s[1:])) * 1e3,
                                 **prof, "peak_gb": peak,
                                 "flash_launches": launches}}
        del state, step
    got, want = runs["sharded"], runs["unsharded"]
    same = got["metrics"] == want["metrics"] and all(
        torch.equal(a, b) for a, b in zip(got["params"], want["params"]))
    stats = {"arch": cfg.name, "B": TRAIN_B, "T": TRAIN_T,
             "steps": DIST_STEPS, "bit_identical": same,
             "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
             "loss_grad_norm": got["metrics"],
             **{label: run["stats"] for label, run in runs.items()}}
    log(f"[distributed] train {json.dumps(stats)}")
    if not same:
        raise AssertionError(f"sharded step differs: {got['metrics']} "
                             f"against {want['metrics']}")
    del runs, got, want

    seen = {}
    compressor = make_error_feedback_compressor()

    def hook(grads, residual):
        out = compressor(grads, residual)
        seen.update(grads=grads, residual=residual, new_residual=out[1])
        return out

    _, state, step, data = fresh_training(cfg, mesh=mesh, compress=hook)
    flash_launches(reset=True)
    losses = []
    with counting_routes() as plans:
        for i in range(COMPRESS_STEPS):
            state, m = step(state, data.batch(i))
            losses.append(m["loss"].item())
    require_routes("[distributed] compress", plans, COMPRESS_STEPS)
    total += flash_launches()
    exact = True
    for g, r, new in zip(tree_leaves(seen["grads"]),
                         tree_leaves(seen["residual"]),
                         tree_leaves(seen["new_residual"])):
        corrected = whole(g).float() + whole(r)
        exact &= torch.equal(whole(new), corrected - dequantize_int8(
            *quantize_int8(corrected)))
    stats = {"steps": COMPRESS_STEPS, "losses": losses,
             "residual_exact": exact}
    log(f"[distributed] compress {json.dumps(stats)}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0] and exact):
        raise AssertionError(f"compressed training: losses {losses}, "
                             f"residual exact {exact}")
    return tuple(int(n) for n in total)


def distributed_train_ssm(cfg, mesh) -> tuple[int, int]:
    """(e) The sharded train step of mamba2-1.3b at ``DIST_SSM_LAYERS`` of
    its 48 layers (full width, bf16, remat "block", AdamW, 3 steps of 8 x
    2048) on the (1, 1) mesh against the unsharded step from the same
    seed: through the tensor-parallel route (its SSM heads "local" over a
    "model" axis of one rank, where each collective is the identity, the
    rank's columns are the whole leaves and the gated RMSNorm is the
    unsharded one), each step's loss and grad norm and the params after 3
    steps the same bits (the sharded params read back whole in the
    reference's column order, ``sharding.whole_state``: over one rank the
    by-rank order is the reference's); 2 x layers forward and layers
    backward scan launches a step in each. Returns the scan launches
    (forward, backward) in it."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.common import tree_leaves
    cfg = replace(cfg, n_layers=DIST_SSM_LAYERS)
    total = np.zeros(2, dtype=int)
    runs = {}
    for label, on in (("unsharded", None), ("sharded", mesh)):
        torch.cuda.empty_cache()
        _, state, step, data = fresh_training(cfg, mesh=on)
        scan_launches(reset=True)
        metrics = []
        t0 = time.perf_counter()
        with counting_routes() as plans:
            for i in range(DIST_STEPS):
                state, m = step(state, data.batch(i))
                metrics.append((m["loss"].item(), m["grad_norm"].item()))
        seconds = time.perf_counter() - t0
        require_routes(f"[distributed] train ssm {label}", plans,
                       DIST_STEPS if on is not None else 0)
        if any((p.ssm, p.ssm_layout) != ("local", "by_rank")
               for p in plans):
            raise AssertionError(f"the sharded mamba2 step's SSM heads are "
                                 f"not local by rank: {plans}")
        launches = scan_launches()
        want = (2 * cfg.n_layers * DIST_STEPS, cfg.n_layers * DIST_STEPS)
        if launches != want:
            raise AssertionError(f"{label} mamba2 step: scan launches "
                                 f"{launches}, want {want}")
        total += launches
        if on is not None:
            state = shd.whole_state(cfg, on, state)
        runs[label] = {"metrics": metrics, "seconds": seconds,
                       "params": tree_leaves(state["params"])}
        del state, step
    got, want = runs["sharded"], runs["unsharded"]
    same = got["metrics"] == want["metrics"] and all(
        torch.equal(a, b) for a, b in zip(got["params"], want["params"]))
    stats = {"arch": cfg.name, "layers": cfg.n_layers, "B": TRAIN_B,
             "T": TRAIN_T, "steps": DIST_STEPS, "bit_identical": same,
             "loss_grad_norm": got["metrics"],
             "seconds": {k: r["seconds"] for k, r in runs.items()},
             "scan_launches_a_step": [2 * cfg.n_layers, cfg.n_layers]}
    log(f"[distributed] train ssm {json.dumps(stats)}")
    if not same:
        raise AssertionError(f"sharded mamba2 step differs: "
                             f"{got['metrics']} against {want['metrics']}")
    return tuple(int(n) for n in total)


def distributed_serve(cfg, mesh) -> int:
    """(d) ``launch.build.serve_step`` on the (1, 1) mesh at full-width
    smollm-135m (bf16): a prefill of 8 prompts of 256 tokens into a cache
    of 512, then 4 greedy decode steps, through the tensor-parallel route
    (a route a step), against ``model.prefill`` and ``model.decode`` on
    the same params and a cache of their own: the logits of every step
    bit-identical, the same greedy tokens fed to both, 30
    ``decode_attention`` launches a decode step each. Returns the decode
    launches in it."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.build import serve_step
    from repro_torch.models.transformer import build_model
    model = build_model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT),
                           generator=gen, device=DEV, dtype=torch.int32)

    def placed(tree, specs):
        return shd.place(tree, shd.to_named(mesh, shd.fit_tree(mesh, specs,
                                                               tree)))

    def inputs(t):
        return placed({"tokens": t}, shd.batch_specs(cfg, mesh,
                                                     {"tokens": t}))

    ps = placed(params, shd.param_specs(cfg, mesh))
    cache = placed(model.init_cache(SERVE_B, SERVE_LEN),
                   shd.cache_specs(cfg, mesh))
    want_cache = model.init_cache(SERVE_B, SERVE_LEN)
    prefill, decode = serve_step(model, mesh, "prefill"), serve_step(
        model, mesh, "decode")
    launch_counts(reset=True)
    with torch.no_grad(), counting_routes() as plans:
        got, cache = prefill(ps, inputs(tokens), cache)
        want, want_cache = model.prefill(params, {"tokens": tokens},
                                         want_cache)
        same = [torch.equal(got, want)]
        for _ in range(SERVE_DECODES):
            nxt = want.argmax(-1).to(torch.int32)
            got, cache = decode(ps, inputs(nxt), cache)
            want, want_cache = model.decode(params, nxt, want_cache)
            same.append(torch.equal(got, want))
    launches = launch_counts()["decode_attention"]
    require_routes("[distributed] serve", plans, 1 + SERVE_DECODES)
    stats = {"arch": cfg.name, "prompts": [SERVE_B, SERVE_PROMPT],
             "cache": SERVE_LEN, "decode_steps": SERVE_DECODES,
             "logits": list(got.shape), "bit_identical": same,
             "decode_launches": launches}
    log(f"[distributed] serve {json.dumps(stats)}")
    if not all(same) or launches != 2 * cfg.n_layers * SERVE_DECODES:
        raise AssertionError(f"serve_step on (1, 1): {stats}")
    return launches


def distributed_encdec(cfg, mesh) -> tuple[int, int, int]:
    """(g) whisper-tiny at full width (4 + 4 layers, bf16) on the (1, 1)
    mesh through the tensor-parallel route (the decoder's plan with the
    encoder's, each over a "model" axis of one rank, where every
    collective is the identity): ``sharding.shard_train_step`` against the
    unsharded step from the same seed (remat "block", AdamW, 3 steps of 8
    x ``DIST_ENCDEC_T`` tokens with seeded frames), each step's loss and
    grad norm and the params after 3 steps the same bits, 2 x 4 forward
    and 4 backward flash launches a step in each; then
    ``launch.build.serve_step`` against ``model.prefill`` and
    ``model.decode`` on the same params and a cache of their own (the
    frames and a prompt of ``DIST_ENCDEC_PROMPT`` tokens into a cache of
    ``ENCDEC_MAX_LEN``, 4 greedy decode steps), the logits of every step
    bit-identical, 4 ``decode_attention`` launches a decode step each.
    Returns the decode launches and the flash launches (forward,
    backward) in it."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.build import serve_step
    from repro_torch.models.common import tree_leaves
    whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    gen = torch.Generator(device=DEV).manual_seed(SEED + 7)
    frames = torch.randn((TRAIN_B, cfg.enc_len, cfg.d_model), generator=gen,
                         device=DEV).to(cfg.compute_dtype)
    total = np.zeros(2, dtype=int)
    runs = {}
    for label, on in (("unsharded", None), ("sharded", mesh)):
        torch.cuda.empty_cache()
        model, state, step, data = fresh_training(cfg, mesh=on, B=TRAIN_B,
                                                  T=DIST_ENCDEC_T)
        flash_launches(reset=True)
        metrics = []
        t0 = time.perf_counter()
        with counting_routes() as plans:
            for i in range(DIST_STEPS):
                state, m = step(state, {**data.batch(i), "frames": frames})
                metrics.append((m["loss"].item(), m["grad_norm"].item()))
        seconds = time.perf_counter() - t0
        require_routes(f"[distributed] train encdec {label}", plans,
                       DIST_STEPS if on is not None else 0)
        if any(p.encoder is None for p in plans):
            raise AssertionError(f"an enc-dec train route without the "
                                 f"encoder's plan: {plans}")
        launches = flash_launches()
        want = (2 * cfg.n_layers * DIST_STEPS, cfg.n_layers * DIST_STEPS)
        if launches != want:
            raise AssertionError(f"{label} whisper step: flash launches "
                                 f"{launches}, want {want}")
        total += launches
        runs[label] = {"metrics": metrics, "seconds": seconds,
                       "tree": state["params"],
                       "params": [whole(p) for p in
                                  tree_leaves(state["params"])]}
        del state, step
    got, want = runs["sharded"], runs["unsharded"]
    same_train = got["metrics"] == want["metrics"] and all(
        torch.equal(a, b) for a, b in zip(got["params"], want["params"]))
    train = {"loss_grad_norm": got["metrics"],
             "seconds": {k: r["seconds"] for k, r in runs.items()}}
    # serve_step on the unsharded step's final params
    params = want["tree"]
    del runs, got, want
    prompt = torch.randint(0, cfg.vocab_size, (TRAIN_B, DIST_ENCDEC_PROMPT),
                           generator=gen, device=DEV, dtype=torch.int32)

    def placed(tree, specs):
        return shd.place(tree, shd.to_named(mesh, shd.fit_tree(mesh, specs,
                                                               tree)))

    def inputs(batch):
        return placed(batch, shd.batch_specs(cfg, mesh, batch))

    ps = placed(params, shd.param_specs(cfg, mesh))
    cache = placed(model.init_cache(TRAIN_B, ENCDEC_MAX_LEN),
                   shd.cache_specs(cfg, mesh))
    want_cache = model.init_cache(TRAIN_B, ENCDEC_MAX_LEN)
    prefill, decode = serve_step(model, mesh, "prefill"), serve_step(
        model, mesh, "decode")
    batch = {"tokens": prompt, "frames": frames}
    launch_counts(reset=True)
    with torch.no_grad(), counting_routes() as plans:
        out, cache = prefill(ps, inputs(batch), cache)
        ref_out, want_cache = model.prefill(params, batch, want_cache)
        same_serve = [torch.equal(out, ref_out)]
        for _ in range(SERVE_DECODES):
            nxt = ref_out.argmax(-1).to(torch.int32)
            out, cache = decode(ps, inputs({"tokens": nxt}), cache)
            ref_out, want_cache = model.decode(params, nxt, want_cache)
            same_serve.append(torch.equal(out, ref_out))
    decodes = launch_counts()["decode_attention"]
    require_routes("[distributed] serve encdec", plans, 1 + SERVE_DECODES)
    stats = {"arch": cfg.name, "B": TRAIN_B, "T": DIST_ENCDEC_T,
             "enc_len": cfg.enc_len, "steps": DIST_STEPS,
             "train_bit_identical": same_train, **train,
             "flash_launches_a_step": [2 * cfg.n_layers, cfg.n_layers],
             "prompt": DIST_ENCDEC_PROMPT, "cache": ENCDEC_MAX_LEN,
             "decode_steps": SERVE_DECODES,
             "serve_bit_identical": same_serve, "decode_launches": decodes}
    log(f"[distributed] encdec {json.dumps(stats)}")
    if not (same_train and all(same_serve)) or \
            decodes != 2 * cfg.n_layers * SERVE_DECODES:
        raise AssertionError(f"whisper-tiny on (1, 1): {stats}")
    return decodes, int(total[0]), int(total[1])


def distributed_pipeline(cfg) -> int:
    """(b) ``pipeline`` over a one-rank ("stage",) mesh: the 30 layers of
    full-width smollm-135m (bf16, flash forward) on 4 microbatches of 2 x
    2048, the same bits as the layers run on each microbatch in turn, 120
    flash forward launches; its time beside the sequential run's. Returns
    the flash forward launches in it, the timed runs' too."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.pipeline import pipeline, split_stages
    from repro_torch.models.transformer import build_model, unstack
    from repro_torch.train.data import DataConfig, SyntheticLM
    mesh = init_device_mesh(DEV, (1,), mesh_dim_names=("stage",))
    model = build_model(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    tokens = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_T,
                                    PIPE_MICRO * PIPE_B, seed=SEED + 3),
                         device=DEV).batch(0)["tokens"]

    def stage_fn(layers, h):
        for lp in unstack(layers):
            h = model._layer(h, lp)
        return h

    run = pipeline(stage_fn, mesh, n_microbatches=PIPE_MICRO)
    with torch.no_grad():
        x = model._embed(params, tokens).reshape(PIPE_MICRO, PIPE_B,
                                                 TRAIN_T, cfg.d_model)
        flash_launches(reset=True)
        got = run(split_stages(params["layers"], 1), x)
        launches = flash_launches()[0]
        want = torch.stack([stage_fn(params["layers"], x[m])
                            for m in range(PIPE_MICRO)])
        ms = eager_ms(lambda i: run(split_stages(params["layers"], 1), x), 3)
        seq_ms = eager_ms(lambda i: [stage_fn(params["layers"], x[m])
                                     for m in range(PIPE_MICRO)], 3)
        timed = flash_launches()[0]
    same = torch.equal(got, want)
    stats = {"stages": 1, "microbatches": PIPE_MICRO,
             "microbatch": [PIPE_B, TRAIN_T], "layers": cfg.n_layers,
             "bit_identical": same, "flash_fwd_launches": launches,
             "ms": ms, "sequential_ms": seq_ms}
    log(f"[distributed] pipeline {json.dumps(stats)}")
    if not same or launches != PIPE_MICRO * cfg.n_layers:
        raise AssertionError(f"pipeline: bit-identical {same}, flash "
                             f"launches {launches}")
    return timed


def ep_grads(fn, p, x, cot) -> dict:
    """The output, the aux and the gradients (router, the three expert
    stacks, x) of ``(out * cot).sum() + aux`` under grad mode, ``fn(p,
    x)`` giving (out, aux)."""
    leaves = [p.router, p.w_gate, p.w_up, p.w_down, x]
    with torch.enable_grad():
        out, aux = fn(p, x)
        grads = torch.autograd.grad((out.float() * cot).sum() + aux, leaves)
    return {"out": out.detach(), "aux": aux.detach(),
            **dict(zip(EP_GRADS, grads))}


def distributed_ep(cfg, mesh) -> None:
    """(c) ``moe_block`` under an installed policy (so ``moe_block_ep``
    over the one-rank group) against ``moe_block`` without one, on one
    layer's weights of qwen2-moe-a2.7b (60 experts of d 2048, ff 1408,
    top-4, 4 shared; 2.1 GB in fp32) at ``EP_SHAPES``, under grad mode:
    fp32 at a capacity factor where neither drops (E / k: C reaches every
    token) the output within ``EP_OUT_ATOL``, the aux within
    ``EP_AUX_RTOL`` relative, and the gradients of ``(out * cot).sum() +
    aux`` (the router, the three expert stacks, x) within ``EP_OUT_ATOL``
    of each gradient's largest magnitude; then the device ms of both
    forwards and of both backwards in bf16 at the config's capacity
    factor."""
    from repro_torch.distributed import logical
    from repro_torch.models import ffn, moe_ep
    from repro_torch.models.common import tree_map
    gen = torch.Generator(device=DEV).manual_seed(SEED + 4)
    cfg32 = replace(cfg, param_dtype=torch.float32,
                    compute_dtype=torch.float32)
    p = ffn.init_moe(gen, cfg32, DEV)
    pb = ffn.MoEParams(p.router, *tree_map(lambda t: t.to(cfg.param_dtype),
                                           tuple(p[1:])))
    whole = replace(cfg32, capacity_factor=cfg.n_experts / cfg.top_k)
    p = tree_map(lambda t: t.requires_grad_(True), p)
    pb = tree_map(lambda t: t.detach().requires_grad_(True), pb)
    rows = []
    for shape, n in EP_SHAPES:
        x = torch.randn((1, n, cfg.d_model), generator=gen, device=DEV,
                        requires_grad=True)
        cot = torch.randn((1, n, cfg.d_model), generator=gen, device=DEV)
        xb = x.detach().to(cfg.compute_dtype).requires_grad_(True)
        want = ep_grads(lambda p, x: ffn.moe_block(p, x, whole), p, x, cot)
        calls = []
        block = moe_ep.moe_block_ep
        moe_ep.moe_block_ep = lambda *a: calls.append(1) or block(*a)
        try:
            with logical.policy(mesh):
                got = ep_grads(lambda p, x: ffn.moe_block(p, x, whole), p, x,
                               cot)
                ep = timed_forward_backward(pb, xb, cot, cfg)
        finally:
            moe_ep.moe_block_ep = block
        local = timed_forward_backward(pb, xb, cot, cfg)
        row = {"shape": shape, "tokens": n, "ep_calls": len(calls),
               "fp32_max_abs_err": (got["out"] - want["out"]).abs().max()
               .item(),
               "fp32_aux_rel_err": abs(got["aux"].item() - want["aux"].item())
               / abs(want["aux"].item()),
               "fp32_grad_err": {k: ((got[k] - want[k]).abs().max()
                                     / want[k].abs().max()).item()
                                 for k in EP_GRADS},
               "bf16_ep_ms": ep["fwd"]["device_ms"],
               "bf16_ep_nccl_ms": ep["fwd"]["nccl_ms"],
               "bf16_local_ms": local["fwd"]["device_ms"],
               "bf16_ep_bwd_ms": ep["bwd"]["device_ms"],
               "bf16_ep_bwd_nccl_ms": ep["bwd"]["nccl_ms"],
               "bf16_local_bwd_ms": local["bwd"]["device_ms"],
               "ep_capacity": moe_ep._capacity(n, cfg, p.w_gate.shape[0]),
               "local_capacity": ffn._capacity(n, cfg)}
        rows.append(row)
        require_device_time(f"[distributed] ep {shape}",
                            {"ep": ep["fwd"]["device_ms"],
                             "local": local["fwd"]["device_ms"],
                             "ep_bwd": ep["bwd"]["device_ms"],
                             "local_bwd": local["bwd"]["device_ms"]})
        # the fp32 call, then the timed forwards and their warm-up, then
        # the forward the timed backwards differentiate
        if (row["ep_calls"] != 3 + EP_TIMED
                or row["fp32_max_abs_err"] > EP_OUT_ATOL
                or row["fp32_aux_rel_err"] > EP_AUX_RTOL
                or max(row["fp32_grad_err"].values()) > EP_OUT_ATOL):
            raise AssertionError(f"moe_block_ep: {row}")
        del x, xb, cot, want, got
    log(f"[distributed] ep {json.dumps({'arch': cfg.name, 'rows': rows})}")


def timed_forward_backward(p, x, cot, cfg) -> dict:
    """``moe_block``'s device ms in bf16 (``profiled_ms``): the forward
    alone, and the backward of ``(out * cot).sum() + aux`` from one
    forward (its graph kept for the repeats)."""
    from repro_torch.models import ffn
    with torch.no_grad():
        fwd = profiled_ms(lambda: ffn.moe_block(p, x, cfg), EP_TIMED)
    with torch.enable_grad():
        out, aux = ffn.moe_block(p, x, cfg)
        loss = (out.float() * cot).sum() + aux
        leaves = [p.router, p.w_gate, p.w_up, p.w_down, x]
        bwd = profiled_ms(lambda: torch.autograd.grad(
            loss, leaves, retain_graph=True), EP_TIMED)
    return {"fwd": fwd, "bwd": bwd}


def distributed_train_moe(cfg, mesh) -> tuple[int, int]:
    """(f) The sharded train step of qwen2-moe-a2.7b at ``DIST_MOE_LAYERS``
    of its 24 layers (full width, fp32, remat "block", AdamW, 3 steps of
    ``DIST_MOE_B`` x ``DIST_MOE_T``) on the (1, 1) mesh against the
    unsharded step from the same seed, at a capacity factor where neither
    path drops (E / k): the sharded one through the tensor-parallel route
    (a route a step; its MoE layers by expert parallelism over the one
    rank, ``moe_block_tp``), the unsharded one by the grouped dispatch,
    each step's loss and grad norm within ``DIST_MOE_RTOL`` relative (the
    two paths sum a few gradients in another order, a last-bit
    difference); 2 x layers forward and layers backward flash launches a
    step in each. The params' largest difference after 3 steps is printed,
    not held: AdamW scales each element's update by its own gradient's
    size, so an element whose gradient is near zero (an embedding row a
    few positions reach) can move by up to the learning rate for that
    last bit. Returns the flash launches (forward, backward) in it."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.common import tree_leaves
    cfg = replace(cfg, n_layers=DIST_MOE_LAYERS, param_dtype=torch.float32,
                  compute_dtype=torch.float32,
                  capacity_factor=cfg.n_experts / cfg.top_k)
    whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    total = np.zeros(2, dtype=int)
    runs = {}
    for label, on in (("unsharded", None), ("sharded", mesh)):
        torch.cuda.empty_cache()
        _, state, step, data = fresh_training(cfg, mesh=on, B=DIST_MOE_B,
                                               T=DIST_MOE_T)
        flash_launches(reset=True)
        metrics = []
        t0 = time.perf_counter()
        with counting_routes() as plans:
            for i in range(DIST_STEPS):
                state, m = step(state, data.batch(i))
                metrics.append((m["loss"].item(), m["grad_norm"].item()))
        seconds = time.perf_counter() - t0
        require_routes(f"[distributed] train moe {label}", plans,
                       DIST_STEPS if on is not None else 0)
        launches = flash_launches()
        want = (2 * cfg.n_layers * DIST_STEPS, cfg.n_layers * DIST_STEPS)
        if launches != want:
            raise AssertionError(f"{label} qwen2-moe step: flash launches "
                                 f"{launches}, want {want}")
        total += launches
        # the unsharded run's params wait on the host (11.6 GB) while the
        # sharded run trains; the sharded run's stay on the card
        runs[label] = {"metrics": metrics, "seconds": seconds,
                       "params": [whole(p).to("cpu" if on is None else DEV)
                                  for p in tree_leaves(state["params"])]}
        del state, step
    got, want = runs["sharded"], runs["unsharded"]
    metric_err = max(abs(a - b) / abs(b) for g, w in zip(
        got["metrics"], want["metrics"]) for a, b in zip(g, w))
    param_err = max((a - b.to(DEV)).abs().max().item()
                    for a, b in zip(got["params"], want["params"]))
    same = got["metrics"] == want["metrics"] and param_err == 0.0
    stats = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": "float32",
             "capacity_factor": cfg.capacity_factor, "B": DIST_MOE_B,
             "T": DIST_MOE_T, "steps": DIST_STEPS, "bit_identical": same,
             "metric_rel_err": metric_err, "param_max_abs_err": param_err,
             "loss_grad_norm": got["metrics"],
             "unsharded_loss_grad_norm": want["metrics"],
             "seconds": {k: r["seconds"] for k, r in runs.items()},
             "flash_launches_a_step": [2 * cfg.n_layers, cfg.n_layers]}
    log(f"[distributed] train moe {json.dumps(stats)}")
    if metric_err > DIST_MOE_RTOL:
        raise AssertionError(f"sharded qwen2-moe step: {stats}")
    return tuple(int(n) for n in total)


def distributed_phase(smollm, qwen, mamba, whisper
                      ) -> tuple[int, int, int, int, int]:
    """Phase 22, run after phase 9 (the profiler reads device time there).
    Returns the decode launches, the flash launches (forward, backward)
    and the scan launches (forward, backward) in it."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import logical
    t0 = time.perf_counter()
    with nccl_group():
        mesh = init_device_mesh(DEV, (1, 1),
                                mesh_dim_names=("data", "model"))
        fwd, bwd = distributed_train(smollm, mesh)
        torch.cuda.empty_cache()
        decode = distributed_serve(smollm, mesh)
        torch.cuda.empty_cache()
        fwd += distributed_pipeline(smollm)
        torch.cuda.empty_cache()
        distributed_ep(qwen, mesh)
        torch.cuda.empty_cache()
        scan_fwd, scan_bwd = distributed_train_ssm(mamba, mesh)
        torch.cuda.empty_cache()
        moe_fwd, moe_bwd = distributed_train_moe(qwen, mesh)
        fwd, bwd = fwd + moe_fwd, bwd + moe_bwd
        torch.cuda.empty_cache()
        n, encdec_fwd, encdec_bwd = distributed_encdec(whisper, mesh)
        decode, fwd, bwd = decode + n, fwd + encdec_fwd, bwd + encdec_bwd
        torch.cuda.empty_cache()
    if logical.active():
        raise AssertionError("a logical policy outlived phase 22")
    log(f"[distributed] phase {time.perf_counter() - t0:.1f} s, decode "
        f"launches {decode}, flash launches (fwd, bwd) ({fwd}, {bwd}), "
        f"scan launches (fwd, bwd) ({scan_fwd}, {scan_bwd})")
    return decode, fwd, bwd, scan_fwd, scan_bwd


# -------------------------------------------------------------- phase 23 --
# (a) cells dry-run on the production meshes by ``python -m
# repro_torch.launch.dryrun``, a subprocess each: (arch, shape, multi_pod,
# the rank counted). The dry run never touches the card, so the card's host
# runs the largest cell on both meshes, to show the tooling on the card's
# PyTorch, and the tensor-parallel cells of (c) on the rank (c) runs, their
# predictions; the other cells are counted on the CPU (``--all``).
# (c) runs one rank's share of each of these (arch, shape, rank): phi3-mini
# (attention "local"), llama-3.1-8b ("kv_replicated"), minitron-4b's last
# rank along "model" ("q_seq": rank 15 of the (16, 16) mesh is data 0,
# model 15, the rank with the most attention), zamba2-2.7b (its shared
# block's heads and its SSM heads "local") and qwen2-moe-a2.7b (heads and
# shared experts "local", one of the 256 padded experts a rank, its tokens
# by all-to-all over the fake world) and llava-next-34b x decode_32k
# ("kv_seq": the cache split over its positions, the ranks' decode
# partials merged; before it the share did not fit the card) and
# whisper-tiny x train_4k on rank 15 (the decoder "q_seq" on its last
# rows, the encoder "gathered", the whole-vocab loss on the rank's own
# positions) and x decode_32k ("kv_seq", the cross K/V whole along
# "model") and llava-next-34b x train_4k on rank 15 (the heaviest "q_seq"
# rank; its share fits the card since each layer's leaves are gathered
# when the layer runs) and kimi-k2-1t-a32b x train_4k at full depth (its
# share fits the card since the optimizer step holds one layer's fp32
# temporaries, and its build draws the rank's 2 of 512 padded experts a
# layer, never the 2.06 TB stacks whole)
TP_CELLS = [("phi3-mini-3.8b", "train_4k", 0),
            ("phi3-mini-3.8b", "decode_32k", 0),
            ("llama-3.1-8b", "train_4k", 0),
            ("llama-3.1-8b", "decode_32k", 0),
            ("minitron-4b", "train_4k", 15),
            ("zamba2-2.7b", "train_4k", 0),
            ("zamba2-2.7b", "decode_32k", 0),
            ("qwen2-moe-a2.7b", "train_4k", 0),
            ("qwen2-moe-a2.7b", "decode_32k", 0),
            ("llava-next-34b", "decode_32k", 0),
            ("whisper-tiny", "train_4k", 15),
            ("whisper-tiny", "decode_32k", 0),
            ("llava-next-34b", "train_4k", 15),
            ("kimi-k2-1t-a32b", "train_4k", 0)]
# each share's card peak (GB), mean host ms and device busy ms a step
# before a mamba2 block's in_proj, conv_w and conv_b were stored by rank
# (PERF.md section 6, the optimizer step a layer at a time, a run on an
# H100 80GB HBM3 at 700 W), printed beside this run's
PARENT_SHARES = {
    ("phi3-mini-3.8b", "train_4k", 0): (3.589, 783.0, 635.6),
    ("phi3-mini-3.8b", "decode_32k", 0): (6.498, 222.0, 13.51),
    ("llama-3.1-8b", "train_4k", 0): (10.545, 1168.0, 926.8),
    ("llama-3.1-8b", "decode_32k", 0): (4.490, 282.0, 14.00),
    ("minitron-4b", "train_4k", 15): (18.398, 1154.0, 852.3),
    ("zamba2-2.7b", "train_4k", 0): (9.239, 1799.0, 1427.4),
    ("zamba2-2.7b", "decode_32k", 0): (1.643, 388.0, 18.33),
    ("qwen2-moe-a2.7b", "train_4k", 0): (12.932, 1425.0, 1085.2),
    ("qwen2-moe-a2.7b", "decode_32k", 0): (3.743, 265.0, 12.35),
    ("llava-next-34b", "decode_32k", 0): (4.643, 564.0, 64.07),
    ("whisper-tiny", "train_4k", 15): (5.010, 329.0, 102.3),
    ("whisper-tiny", "decode_32k", 0): (0.222, 70.0, 3.35),
    ("llava-next-34b", "train_4k", 15): (11.712, 3862.0, 3638.0),
    ("kimi-k2-1t-a32b", "train_4k", 0): (35.095, 10329.0, 8482.0)}
DRYRUN_CELLS = [("llava-next-34b", "train_4k", False, 0),
                ("llava-next-34b", "train_4k", True, 0),
                ("mamba2-1.3b", "train_4k", False, 0),
                *((arch, shape, False, rank)
                  for arch, shape, rank in TP_CELLS)]
# (c) the shares run in a fake world of this many ranks on the (16, 16)
# production mesh; a decode cell takes this many steps against a cache
# filled to its last positions
TP_WORLD = 256
TP_DECODE_STEPS = 2
TP_DECODE_S = 32768         # decode_32k's cache
# the train shares' attention (name, B, T, S, Hq, Hkv, hd, causal[,
# q_offset]): 2 of phi3-mini's 32 heads (heads local; the plain version's
# fp32 scores are 2.1 GB), minitron-4b's last rank along "model" (q_seq: all
# 24/8 heads, query rows 3840 to 4096 against keys 0 to 4096), llama-3.1-8b's
# 2 query heads on their one KV head (kv_replicated), zamba2-2.7b's 2 of 32
# heads, qwen2-moe-a2.7b's 1 of 16, whisper-tiny's decoder on its last rank
# along "model" (q_seq: all 6/6 heads of hd 64), llava-next-34b's last
# rank (q_seq: all 56/8 heads of hd 128), a ragged offset (rows and keys
# that no tile divides) and kimi-k2-1t-a32b's 4 query heads on their one
# KV head (kv_replicated, hd 112)
TP_FLASH_SHAPES = [
    ("phi3-mini-3.8b TP share", 16, 4096, 4096, 2, 2, 96, True),
    ("minitron-4b q_seq share, last rank", 16, 256, 4096, 24, 8, 128, True,
     3840),
    ("llama-3.1-8b kv_replicated share", 16, 4096, 4096, 2, 1, 128, True),
    ("zamba2-2.7b TP share", 16, 4096, 4096, 2, 2, 80, True),
    ("qwen2-moe-a2.7b TP share", 16, 4096, 4096, 1, 1, 128, True),
    ("whisper-tiny q_seq share, last rank", 16, 256, 4096, 6, 6, 64, True,
     3840),
    ("llava-next-34b q_seq share, last rank", 16, 256, 4096, 56, 8, 128,
     True, 3840),
    ("ragged q_offset", 2, 100, 357, 6, 2, 64, True, 257),
    ("kimi-k2-1t-a32b kv_replicated share", 16, 4096, 4096, 4, 1, 112,
     True)]
# the scan at the SSM shares' shapes (name, B, T, H, P, N, Q, h0): a rank's
# 5 of zamba2-2.7b's 80 heads (N 64) in train_4k, and 4 of mamba2-1.3b's 64
# (N 128), the cell of (a) whose share is not run
TP_SSD_SHAPES = [("zamba2-2.7b TP share", 16, 4096, 5, 64, 64, 256, False),
                 ("mamba2-1.3b TP share", 16, 4096, 4, 64, 128, 256, False)]
DRYRUN_WORKERS = 8          # the card's host has 8 cores
DRYRUN_TIMEOUT_S = 300
LONG_S = 524288             # long_500k's cache
# (b) smollm-135m x train_4k runs at the smallest grad_accum whose (1, 1)
# dry run fits the card; the search starts at these two (a larger
# microbatch only adds memory, so the answer lies above one that does not
# fit and at or below one that does) and goes on a power of two at a time
GRAD_ACCUM_FIRST = (8, 16)
# (b)'s train_4k steps on each side, sharded and unsharded, before the
# profiled one: a step is 16 microbatches of 16 x 4096, about 11 s of card
# time, and one a side leaves the smoke's time for (c)'s shares
TABLE_TRAIN_STEPS = 1
# The card's peak may exceed the dry run's by this share and no more. The
# dry run counts every tensor the step holds, at its exact size, on the
# plain route, which holds more than the kernels (chunked attention's
# score blocks, fp32 copies of the KV cache); what it cannot see is the
# caching allocator's rounding (512 B a block), the kernels' workspaces
# (the split-KV merge buffer and counters, a few MB) and cuBLAS's workspace
# (32 MiB a stream): under 0.1% of either cell's peak. 5% keeps the check
# to what a wrong count would move: a leaf or a cache counted once
# instead of twice is 5.4 GB (10%) of the decode cell. H100 runs read
# 0.908 (the decode cell; the plain route holds an fp32 copy of a layer's
# K) and 1.00007 (the train cell, whose peak is at the loss on both
# routes).
PEAK_MARGIN = 0.05
# the (1, 1) dry run in a process of its own: a fake world of one rank
PREDICT = """
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch.dryrun import count_cell
from repro_torch.launch.mesh import fake_world
arch, shape, k, out = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
with fake_world(1):
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    result = count_cell(arch, shape, mesh, mesh_name="1x1", grad_accum=k)
with open(out, "w") as f:
    json.dump(result, f)
"""

# The dry run's peak (StepCounter's) of one full-width step against
# MemTracker's, PyTorch's own count of the bytes held, on the card's
# PyTorch: they must agree to the byte, as tests/test_torch_analysis.py
# holds them on reduced cells on the CPU
PEAK_READING = """
import json, sys, torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.device_mesh import init_device_mesh
from torch.utils._pytree import tree_flatten
from repro_torch.configs import ShapeCell
from repro_torch.launch.analysis import StepCounter
from repro_torch.launch.build import build_cell
from repro_torch.launch.mesh import fake_world
with fake_world(1):
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    make = lambda: build_cell("smollm-135m",
                              ShapeCell("train_4k", "train", 2, 4096), mesh)
    cell = make()
    with StepCounter(track=cell.args) as counter:
        cell.step(*cell.args)
    cell = make()
    tracker = MemTracker()
    tracker.track_external(*(t for t in tree_flatten(cell.args)[0]
                             if isinstance(t, torch.Tensor)))
    with tracker:
        cell.step(*cell.args)
    [snap] = tracker.get_tracker_snapshot("peak").values()
with open(sys.argv[1], "w") as f:
    json.dump({"step_counter": counter.peak, "inputs": counter.inputs,
               "mem_tracker": snap["Total"],
               "mem_tracker_by_kind": {str(k): v for k, v in snap.items()}},
              f)
"""


def run_dryrun(job) -> tuple:
    """Runs a job's command (label, argv, JSON it writes) in a process of
    its own, its output into a log beside the JSON; raises on a nonzero
    exit or a process over ``DRYRUN_TIMEOUT_S`` (which is killed).
    Returns (JSON, seconds)."""
    import os
    label, argv, out = job
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    with open(f"{out}.log", "w") as f:
        rc = subprocess.run(argv, cwd=ROOT, env=env, stdout=f,
                            stderr=subprocess.STDOUT,
                            timeout=DRYRUN_TIMEOUT_S).returncode
    if rc != 0:
        raise AssertionError(f"dry run {label}: exit {rc}, see {out}.log")
    with open(out) as f:
        return json.load(f), time.perf_counter() - t0


def run_dryruns(jobs) -> dict:
    """``run_dryrun`` over ``jobs``, ``DRYRUN_WORKERS`` at a time. Returns
    {label: (JSON, seconds)}."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(DRYRUN_WORKERS) as pool:
        return dict(zip((job[0] for job in jobs), pool.map(run_dryrun,
                                                           jobs)))


def predict_job(arch, shape, k):
    out = ROOT / "build" / "dryrun-1x1" / f"{arch}__{shape}__ga{k}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    return ((arch, shape, k), [sys.executable, "-c", PREDICT, arch, shape,
                               str(k), str(out)], str(out))


def peak_reading_job():
    out = ROOT / "build" / "dryrun-1x1" / "peak_reading.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    return ("peak reading", [sys.executable, "-c", PEAK_READING, str(out)],
            str(out))


def production_jobs() -> list:
    """(a)'s jobs: ``python -m repro_torch.launch.dryrun`` for each of
    ``DRYRUN_CELLS``."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import OUT_DIR, _outfile
    (ROOT / OUT_DIR).mkdir(parents=True, exist_ok=True)
    jobs = []
    # the longest counts first, so that the pool's last jobs are short:
    # the train cells, the deepest first (kimi-k2-1t-a32b's takes about 90
    # s on the card's host)
    for arch, shape, multi, rank in sorted(DRYRUN_CELLS, key=lambda c: (
            SHAPES[c[1]].kind != "train", -get_config(c[0]).n_layers)):
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                arch, "--shape", shape, "--rank", str(rank)] + (
                    ["--multi-pod"] if multi else [])
        jobs.append(((arch, shape, multi, rank), argv,
                     str(ROOT / _outfile(arch, shape, multi, rank=rank))))
    return jobs


def production_dryruns(futures: dict, started: float) -> dict:
    """(a)'s results from their futures: a ``[dryrun]`` line per
    production cell; fails on a cell that neither ran nor was skipped by
    the table. Returns {cell: JSON}."""
    done = {cell: f.result() for cell, f in futures.items()}
    for (arch, shape, multi, rank), (r, s) in done.items():
        row = {"arch": arch, "shape": shape, "mesh": r["mesh"],
               "rank": rank, "status": r["status"], "seconds": s}
        if r["status"] == "ok":
            row.update({k: r[k] for k in (
                "bytes_per_device", "fits_h100", "compute_s", "memory_s",
                "collective_s", "dominant", "useful_fraction", "tp")})
        else:
            row["reason"] = r.get("reason") or r.get("error")
        log(f"[dryrun] {json.dumps(row)}")
        if r["status"] not in ("ok", "skipped"):
            raise AssertionError(f"dry run of {arch} x {shape}: {row}")
    log(f"[dryrun] {len(done)} production cells, all done "
        f"{time.perf_counter() - started:.1f} s after the dry runs began")
    return {cell: r for cell, (r, _) in done.items()}


def smallest_fitting_grad_accum(first: dict) -> tuple[int, dict]:
    """The smallest grad_accum (a power of two) whose (1, 1) dry run of
    smollm-135m x train_4k fits the card, from the first candidates'
    results, running more as needed. Returns it and its prediction."""
    from repro_torch.configs import SHAPES
    fits = {k: r for (_, _, k), r in first.items()}

    def run(k):
        job = predict_job("smollm-135m", "train_4k", k)
        fits[k] = run_dryruns([job])[job[0]][0]

    while not any(r["fits_h100"] for r in fits.values()):
        k = 2 * max(fits)
        if k > SHAPES["train_4k"].global_batch:
            raise AssertionError("no microbatch of smollm-135m x train_4k "
                                 "fits the card by the dry run")
        run(k)
    k = min(k for k, r in fits.items() if r["fits_h100"])
    while k > 1 and k // 2 not in fits:
        run(k // 2)
        if not fits[k // 2]["fits_h100"]:
            break
        k //= 2
    log(f"[launch] smollm-135m x train_4k on (1, 1): fits_h100 by "
        f"grad_accum " + json.dumps({k: (r["fits_h100"],
                                         r["bytes_per_device"])
                                     for k, r in sorted(fits.items())}))
    return k, fits[k]


def local_tree(tree):
    """A tree of DTensors on a (1, 1) mesh as their local tensors (a block
    of one rank is the whole leaf)."""
    from repro_torch.models.common import tree_map
    return tree_map(lambda t: t.to_local(), tree)


def busy_ms(prof, top: list | None = None) -> float:
    """Device busy ms of a profile (``trace_summary``'s ``busy``); ``top``
    as ``trace_summary``'s."""
    return trace_summary(prof, top)["busy"]


def trace_summary(prof, top: list | None = None, kernels: tuple = (),
                  range_name: str | None = None) -> dict:
    """One pass over a profile's raw trace. ``busy``: device busy ms, the
    summed durations of its events on the card (kernels, copies, sets; not
    the ranges of user annotations). ``device_kernels`` builds the
    profiler's event tree first: with it phase 23 (b) took 132.8 s and a
    train share of (c) 17.5 to 26.6 s, without it 48.6 s and 4.9 to 7.7 s
    (H100 runs). ``launches``: the executions on the card of each of
    ``kernels`` (names or parts of names, ``PROFILED_KERNEL``'s).
    ``range``: the device ms of the work launched inside the profiler
    range ``range_name`` (CPU side): ``busy``, the summed durations of the
    device events linked to the ops that ran in it (each device event
    names the op that launched it, ``linked_correlation_id``), and
    ``span``, from the first of them to the end of the last. ``top``: a
    list that gets the five event names with the most device ms, each
    [name, events, ms]."""
    cuda = torch.autograd.DeviceType.CUDA

    def flag(e, name):
        return getattr(e, name, lambda: False)()

    by_name: dict[str, list] = {}
    launches = [0] * len(kernels)
    host, linked = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            if range_name is not None:
                host.append((e.name(), e.correlation_id(), e.start_ns(),
                             e.duration_ns(), e.start_thread_id()))
            continue
        if flag(e, "is_user_annotation") or flag(e, "is_hidden_event"):
            continue
        name = e.name()
        row = by_name.setdefault(name[:60], [0, 0])
        row[0] += 1
        row[1] += e.duration_ns()
        for i, kernel in enumerate(kernels):
            launches[i] += kernel in name
        if range_name is not None:
            linked.append((e.linked_correlation_id(), e.start_ns(),
                           e.duration_ns()))
    if top is not None:
        top.extend([name, n, ns / 1e6] for name, (n, ns) in sorted(
            by_name.items(), key=lambda kv: -kv[1][1])[:5])
    out = {"busy": sum(ns for _, ns in by_name.values()) / 1e6,
           "launches": launches}
    if range_name is not None:
        spans = [(t0, t0 + ns, tid) for name, _, t0, ns, tid in host
                 if name == range_name]
        ops = {corr for _, corr, t0, _, tid in host
               if any(a <= t0 <= b and tid == t for a, b, t in spans)}
        ran = [(t0, ns) for corr, t0, ns in linked if corr in ops]
        out["range"] = {
            "busy": sum(ns for _, ns in ran) / 1e6,
            "span": (max(t0 + ns for t0, ns in ran)
                     - min(t0 for t0, _ in ran)) / 1e6 if ran else 0.0,
            "events": len(ran), "ranges": len(spans)}
    return out


def profile_of(fn):
    """One ``fn()`` under the profiler (no warm-up): the profile."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def profiled_step_ms(fn, top: list | None = None) -> float:
    """Device busy ms of one ``fn()`` under the profiler (no warm-up);
    ``top`` as ``busy_ms``'s."""
    return busy_ms(profile_of(fn), top)


# the profiler range each optimizer update of phase 23 (c)'s shares runs in
UPDATE_RANGE = "optimizer update"


@contextlib.contextmanager
def annotated_updates():
    """``launch.build``'s optimizers, while in this context, with each
    update run inside the profiler range ``UPDATE_RANGE``."""
    from repro_torch.launch import build
    plain = build.build_optimizer

    def annotated(cfg):
        opt = plain(cfg)

        def update(*args, **kwargs):
            with torch.profiler.record_function(UPDATE_RANGE):
                return opt.update(*args, **kwargs)
        return opt._replace(update=update)

    build.build_optimizer = annotated
    try:
        yield
    finally:
        build.build_optimizer = plain


def predicted_against_measured(pred: dict, measured: dict) -> dict:
    """The (1, 1) dry run's numbers beside the card's; fails where the
    card's peak exceeds the predicted one by more than ``PEAK_MARGIN``."""
    from repro_torch.launch.roofline import HBM_BW
    flops = pred["semantic"]["flops"]
    row = {"arch": pred["arch"], "shape": pred["shape"],
           "grad_accum": pred["grad_accum"],
           "predicted": {
               "bytes_per_device": pred["bytes_per_device"],
               "semantic_flops": flops,
               "compute_ms": pred["compute_s"] * 1e3,
               "memory_ms": pred["memory_s"] * 1e3,
               "memory_kernel_ms": pred["memory_kernel_s"] * 1e3,
               "floor_ms": pred["min_bytes"] / HBM_BW * 1e3,
               "fits_h100": pred["fits_h100"]},
           "measured": {
               **measured,
               "achieved_tflops_host": flops / measured["host_ms"] / 1e9,
               "achieved_tflops_device": flops / measured["device_busy_ms"]
               / 1e9},
           "peak_over_predicted": measured["peak_bytes"]
           / pred["bytes_per_device"], "peak_margin": PEAK_MARGIN}
    log(f"[launch] cell {json.dumps(row)}")
    if measured["peak_bytes"] > pred["bytes_per_device"] * (1 + PEAK_MARGIN):
        raise AssertionError(f"{pred['arch']} x {pred['shape']}: the card's "
                             f"peak exceeds the dry run's: {row}")
    return row


def long_decode_cell(mesh, pred) -> int:
    """(b) zamba2-2.7b x long_500k built by ``build_cell`` on the card: one
    token decoded at B 1 against a populated cache of 524288 positions
    (K/V and SSM states drawn from the seed, the index at S - 1), 9
    ``decode_attention`` launches a step, logits bit-identical to
    ``model.decode`` called on the same params and cache; its peak, host
    ms (3 steps) and device busy ms beside the dry run's. Returns the
    decode launches in it."""
    from repro_torch.launch.build import build_cell
    from repro_torch.models.transformer import build_model
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    cell = build_cell("zamba2-2.7b", "long_500k", mesh, device=DEV,
                      seed=SEED)
    params, inputs, cache = cell.args
    held = local_tree(cache)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    for leaf in (held["k"], held["v"], *held["state"]):
        for part in leaf:
            part.normal_(generator=gen)
    index = held["index"]
    index.fill_(LONG_S - 1)
    kept = [t.clone() for t in held["state"]] + [
        held[k][:, :, LONG_S - 1].clone() for k in ("k", "v")]

    def restore():
        for t, k in zip(held["state"], kept):
            t.copy_(k)
        for name, k in zip(("k", "v"), kept[2:]):
            held[name][:, :, LONG_S - 1] = k
        index.fill_(LONG_S - 1)

    groups = cell.cfg.n_layers // cell.cfg.attn_every
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    logits, _ = cell.step(*cell.args)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    step_launches = launch_counts()["decode_attention"]
    restore()
    model = build_model(cell.cfg, device=DEV)
    want, _ = model.decode(local_tree(params), inputs["tokens"].to_local(),
                           held)
    same = torch.equal(logits, want)
    finite = bool(torch.isfinite(logits).all())
    host = []
    for _ in range(3):
        restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cell.step(*cell.args)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    restore()
    busy = profiled_step_ms(lambda: cell.step(*cell.args))
    launches = launch_counts()["decode_attention"]
    log(f"[launch] long_500k {json.dumps({'logits': list(logits.shape), 'bit_identical': same, 'finite': finite, 'launches_a_step': step_launches, 'first_ms': first_ms})}")
    if step_launches != groups or not same or not finite:
        raise AssertionError(f"zamba2-2.7b x long_500k: launches "
                             f"{step_launches} (want {groups}), "
                             f"bit-identical {same}, finite {finite}")
    require_device_time("[launch] long_500k step", {"step": busy})
    predicted_against_measured(pred, {
        "peak_bytes": peak, "host_ms": float(np.mean(host)),
        "device_busy_ms": busy})
    del cell, params, inputs, cache, held, kept, model, logits, want
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def expandable_segments():
    """The caching allocator grows one segment a stream by mapping pages
    inside the block, instead of a segment per request: memory freed in
    the middle of a segment then serves a later request of any size.
    Without it, (b)'s unsharded step (69.7 GB held at its peak) asked for
    its 12 GiB of fp32 logits while 13 to 19 GiB lay free in segments that
    live blocks pinned, and ran out of memory (H100 runs); on an allocator
    no phase had used it still reserved 83.0 GB. Its cached pages are
    released on exit."""
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def train_cell(mesh, k, pred) -> tuple[int, int]:
    """(b) smollm-135m x train_4k (256 x 4096 tokens) built by
    ``build_cell`` on the card at ``grad_accum`` k: ``TABLE_TRAIN_STEPS``
    steps with finite losses, loss and grad norm bit-identical to the
    unsharded step's from the same seed and batch (and the params after),
    2 x 30 flash forward and 30 backward launches a microbatch; its peak,
    host ms and device busy ms (one more step under the profiler) beside
    the dry run's.
    Returns the flash launches (forward, backward) in it."""
    from repro_torch.launch.build import OPT_FOR_ARCH, build_cell
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import build_model
    from repro_torch.train.optimizer import OptimizerConfig, build_optimizer
    from repro_torch.train.train_step import build_train_step
    runs = {}
    total = np.zeros(2, dtype=int)
    gc.collect()
    torch.cuda.empty_cache()
    held = [torch.cuda.memory_allocated(), torch.cuda.memory_reserved()]
    for label in ("sharded", "unsharded"):
        # the unsharded step peaks within 10 GB of the card: no garbage of
        # the sharded run may hold a page
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with expandable_segments():
            cell = build_cell("smollm-135m", "train_4k", mesh, grad_accum=k,
                              device=DEV, seed=SEED)
            state, batch = cell.args
            step, n_layers = cell.step, cell.cfg.n_layers
            if label == "unsharded":
                state = local_tree(state)
                step = build_train_step(
                    build_model(cell.cfg, device=DEV),
                    build_optimizer(OPT_FOR_ARCH.get(cell.arch,
                                                     OptimizerConfig())),
                    grad_accum=k)
            flash_launches(reset=True)
            metrics, host = [], []
            for _ in range(TABLE_TRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                metrics.append((m["loss"].item(), m["grad_norm"].item()))
                host.append((time.perf_counter() - t0) * 1e3)
            launches = flash_launches()
            peak = torch.cuda.max_memory_allocated() - base
            params = [t.to_local() if hasattr(t, "to_local") else t
                      for t in tree_leaves(state["params"])]
            # compared on the host: copies on the card would pin segments
            # that the next run's step needs whole
            runs[label] = {"metrics": metrics, "host_ms": host,
                           "params": [p.detach().cpu() for p in params],
                           "peak": peak, "launches": launches,
                           "reserved": torch.cuda.max_memory_reserved()}
            del m
            if label == "sharded":
                runs[label]["busy"] = profiled_step_ms(
                    lambda: step(state, batch))
        total += flash_launches()
        del cell, state, batch, step, params
    torch.cuda.empty_cache()
    got, want = runs["sharded"], runs["unsharded"]
    same = got["metrics"] == want["metrics"] and all(
        torch.equal(a, b) for a, b in zip(got["params"], want["params"]))
    finite = all(np.isfinite(v) for m in got["metrics"] for v in m)
    per = (2 * n_layers * k * TABLE_TRAIN_STEPS,
           n_layers * k * TABLE_TRAIN_STEPS)
    log(f"[launch] train_4k {json.dumps({'grad_accum': k, 'loss_grad_norm': got['metrics'], 'unsharded': want['metrics'], 'bit_identical': same, 'host_ms': got['host_ms'], 'unsharded_host_ms': want['host_ms'], 'unsharded_peak_bytes': want['peak'], 'held_before_bytes': held, 'peak_reserved_bytes': [got['reserved'], want['reserved']], 'flash_launches': got['launches']})}")
    if (not same or not finite
            or tuple(got["launches"]) != per
            or tuple(want["launches"]) != per):
        raise AssertionError(f"smollm-135m x train_4k: bit-identical {same},"
                             f" finite {finite}, flash launches "
                             f"{got['launches']} and {want['launches']} "
                             f"(want {per})")
    require_device_time("[launch] train_4k step", {"step": got["busy"]})
    predicted_against_measured(pred, {
        "peak_bytes": got["peak"], "host_ms": float(np.mean(got["host_ms"])),
        "device_busy_ms": got["busy"]})
    return tuple(int(n) for n in total)


def tp_share_kernels() -> None:
    """(c) The kernels against their plain versions at the shapes the
    shares give them, with phases 3, 7, 10 and 21's tolerances:
    ``decode_attention`` at 8 slots of 32768 (the decode shares' split
    plan) with phi3-mini's 2 of 32 heads, llama-3.1-8b's 2 query heads on
    one KV head, zamba2's 2 of 32 heads at hd 80 (these two timed too) and
    qwen2-moe's 1 of 16, lengths 0, S and ragged ones; flash, forward and
    backward, fp32
    and bf16, at ``TP_FLASH_SHAPES``, the q_seq shares' timings
    (minitron-4b's, whisper-tiny's and llava-next-34b's last ranks)
    beside the same call at offset 0, zamba2's share's beside SDPA and
    kimi-k2's (hd 112) beside its bound and SDPA; the scan,
    forward and backward (fp32, the route's only dtype), at
    ``TP_SSD_SHAPES``, each timed from CUDA-graph replays, with its
    passes' device ms from the profiler. Run while (a)'s dry runs count on
    the host, before (b), whose steps run on expandable segments."""
    from repro_torch.configs import get_config
    lengths = [0, 1, TP_DECODE_S, TP_DECODE_S - TP_DECODE_STEPS,
               TP_DECODE_S + 5, 20001, 4097, 129]
    # llama's and zamba2's shares also timed over 2 layers of cache (134
    # and 84 MB each, past the 50 MB L2)
    for arch, (hq, hkv), timed in (("phi3-mini-3.8b", (2, 2), 0),
                                   ("llama-3.1-8b", (2, 1), 2),
                                   ("zamba2-2.7b", (2, 2), 2),
                                   ("qwen2-moe-a2.7b", (1, 1), 0)):
        c = get_config(arch)
        check_and_time_decode_attention(
            f"{c.name} TP share", hq, hkv, c.hd, timed,
            np.random.default_rng(SEED), B=8, S=TP_DECODE_S,
            lengths=lengths)
    check_flash_attention(TP_FLASH_SHAPES)
    time_flash_offset(TP_FLASH_SHAPES[1])
    time_flash_offset(TP_FLASH_SHAPES[5])
    time_flash_offset(TP_FLASH_SHAPES[6])
    time_flash_attention(TP_FLASH_SHAPES[3])
    time_flash_route(torch.bfloat16, TP_FLASH_SHAPES[8])
    gc.collect()
    torch.cuda.empty_cache()
    check_ssd_scan(TP_SSD_SHAPES)
    check_ssd_scan_bwd(TP_SSD_SHAPES)
    for shape in TP_SSD_SHAPES:
        time_ssd_scan(shape)
        time_ssd_scan_bwd(shape)
    gc.collect()
    torch.cuda.empty_cache()


def tp_share(arch: str, shape: str, rank: int, pred: dict
             ) -> tuple[int, int, int, int, int]:
    """(c) Rank ``rank``'s share of a tensor-parallel cell, built by
    ``build_cell`` on the card in a fake world of ``TP_WORLD`` ranks on
    the (16, 16) production mesh: the train cell one step after a warm-up,
    the decode cell ``TP_DECODE_STEPS`` steps against a cache whose index
    is at its last positions. The fake group's collectives move no data,
    so the values are not the job's and none is checked; the plan's local
    widths are (``Route.check``), and a step's launches: a train step's
    flash forward and backward (2 x attention layers with remat, and
    attention layers: the layers, or the hybrid's groups) and scan forward
    and backward (2 x SSM layers, and SSM layers), a decode step's
    ``decode_attention`` (attention layers). Prints a ``[launch] tp``
    line: the plan, its local heads, SSM mode and SSM heads and the rank's
    query rows (its cache positions under "kv_seq"), the card's peak
    beside the dry run's ``bytes_per_device`` of the same cell and rank
    (failing above ``PEAK_MARGIN``), host ms and device busy ms (a step's
    five costliest device events too); a train step's flash launches as
    the profiler reads them (failing unless they equal the counters'), and
    its optimizer update's device ms (``trace_summary``'s ``range``).
    Returns the decode, flash (forward, backward) and scan (forward,
    backward) launches."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.build import build_cell
    from repro_torch.launch.mesh import fake_world
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    started = time.perf_counter()
    with fake_world(TP_WORLD, rank=rank):
        # the production (16, 16) mesh, on the card
        mesh = init_device_mesh(DEV, (16, 16),
                                mesh_dim_names=("data", "model"))
        t0 = time.perf_counter()
        with annotated_updates():
            cell = build_cell(arch, shape, mesh, device=DEV, seed=SEED)
        build_s = time.perf_counter() - t0
        args, cell.args = cell.args, ()
        step, cfg = cell.step, cell.cfg
        # the attention layers (a hybrid's shared block, once a group) and
        # the SSM layers
        attn = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
                else 0 if cfg.family == "ssm" else cfg.n_layers)
        ssm = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        flash_launches(reset=True)
        scan_launches(reset=True)
        top = []                # a step's costliest device events
        update, seen, readings = None, None, []
        with counting_routes() as plans:
            if cell.kind == "train":
                state, batch = args
                del args
                state, _ = step(state, batch)            # warm-up
                torch.cuda.synchronize()
                before = flash_launches() + scan_launches()
                t0 = time.perf_counter()
                state, _ = step(state, batch)
                torch.cuda.synchronize()
                host = [(time.perf_counter() - t0) * 1e3]
                per = tuple(a - b for a, b in zip(
                    flash_launches() + scan_launches(), before))
                want = (2 * attn, attn, 2 * ssm, ssm)
                # the flash launches a step counted by the profiler too, a
                # second profiled step where it read others (it has
                # dropped kernel records late in a run); every reading is
                # logged
                for _ in range(2):
                    top.clear()
                    read = trace_summary(
                        profile_of(lambda: step(state, batch)), top,
                        (PROFILED_KERNEL["flash_attention_fwd"],
                         PROFILED_KERNEL["flash_attention_bwd"]),
                        UPDATE_RANGE)
                    seen = read["launches"]
                    readings.append(seen)
                    if tuple(seen) == per[:2]:
                        break
                busy, update = read["busy"], read["range"]
                out = None
            else:
                params, inputs, cache = args
                del args
                if cache["k"].shape[2] != TP_DECODE_S:
                    raise AssertionError(f"the share's cache holds "
                                         f"{cache['k'].shape[2]} positions, "
                                         f"phase 3 checks {TP_DECODE_S}")
                cache["index"].to_local().fill_(
                    TP_DECODE_S - TP_DECODE_STEPS - 1)
                host = []
                for _ in range(TP_DECODE_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out, cache = step(params, inputs, cache)
                    torch.cuda.synchronize()
                    host.append((time.perf_counter() - t0) * 1e3)
                per = (launch_counts()["decode_attention"]
                       / TP_DECODE_STEPS,)
                want = (attn,)
                busy = profiled_step_ms(lambda: step(params, inputs, cache),
                                        top)
        peak = torch.cuda.max_memory_allocated() - base
        launches = (launch_counts()["decode_attention"], *flash_launches(),
                    *scan_launches())
        route_ok = bool(plans) and all(
            p.record(cell.tp["model_rank"]) == cell.tp for p in plans)
        row = {"arch": arch, "shape": shape, "mesh": "pod16x16",
               "fake_world": TP_WORLD, "rank": rank, "tp": cell.tp,
               "heads": cell.tp["heads"],
               "local_heads": cell.tp["local_heads"],
               "ssm": cell.tp.get("ssm"),
               "ssm_heads": cell.tp.get("ssm_heads"),
               "ssm_layout": cell.tp.get("ssm_layout"),
               "q_rows": cell.tp["q_rows"],
               "kv_rows": cell.tp.get("kv_rows"), "routes": len(plans),
               "values_checked": False,
               "launches_a_step": list(per),
               "logits": None if out is None else list(out.shape),
               "peak_bytes": peak,
               "predicted_bytes_per_device": pred["bytes_per_device"],
               "peak_over_predicted": peak / pred["bytes_per_device"],
               "peak_margin": PEAK_MARGIN,
               "host_ms": host, "device_busy_ms": busy,
               "top_device_ms": top, "profiled_flash_launches": seen,
               "profiled_flash_launches_first": (
                   readings[0] if len(readings) > 1 else None),
               "update_device_ms": update, "build_s": build_s, **dict(zip(
                   ("parent_peak_gb", "parent_host_ms",
                    "parent_device_busy_ms"),
                   PARENT_SHARES.get((arch, shape, rank), (None,) * 3))),
               "seconds": time.perf_counter() - started}
        log(f"[launch] tp {json.dumps(row)}")
        require_device_time(f"[launch] tp {arch} x {shape}", {"step": busy})
        if cell.kind == "train" and (update["ranges"] != 1
                                     or not update["busy"]):
            raise AssertionError(f"{arch} x {shape} share: the optimizer "
                                 f"update's device time {update}")
        if cell.tp.get("ssm") == "local" and \
                cell.tp["ssm_layout"] != "by_rank":
            raise AssertionError(f"{arch} x {shape} share: its mamba2 "
                                 f"blocks are not stored by rank: {cell.tp}")
        if (tuple(per) != want or not route_ok
                or (seen is not None and tuple(seen) != per[:2])
                or peak > pred["bytes_per_device"] * (1 + PEAK_MARGIN)):
            raise AssertionError(f"{arch} x {shape} share: launches a step "
                                 f"{per} (want {want}; the profiler read "
                                 f"{seen}), routes {plans}, peak {peak} "
                                 f"against {pred['bytes_per_device']}")
    return launches


def start_dryruns(pool):
    """Phase 23 (b)'s (1, 1) predictions, then (a)'s cells, submitted to
    ``pool`` (``DRYRUN_WORKERS`` threads, first come first run): the
    dry-run processes count on the host while the card runs phase 21's
    parity checks and the kernel checks of (c), whose times are graph
    replays and profiled device time (only their eager columns can feel
    the host's load), and (a)'s last cells while (b) runs. Fails at once
    without the fake process group. Returns ({label: future} of (b)'s
    predictions, {cell: future} of (a)'s, the time they began)."""
    from repro_torch.launch.mesh import _FAKE_PG, fake_pg_available
    present = fake_pg_available()
    log(f"[launch] {_FAKE_PG} in torch {torch.__version__}: {present}")
    if not present:
        raise AssertionError("the fake process group is missing")
    started = time.perf_counter()
    first = [predict_job("smollm-135m", "train_4k", k)
             for k in GRAD_ACCUM_FIRST] + [
        predict_job("zamba2-2.7b", "long_500k", 1),
        predict_job("smollm-135m", "decode_32k", 1), peak_reading_job()]
    return ({job[0]: pool.submit(run_dryrun, job) for job in first},
            {job[0]: pool.submit(run_dryrun, job)
             for job in production_jobs()}, started)


def launch_phase(dryruns) -> tuple[int, int, int, int, int]:
    """Phase 23: the dry runs (a) (``dryruns``, from ``start_dryruns``),
    the two table cells on the card (b), which start once their (1, 1)
    predictions are in (the rest of (a) counts on the host meanwhile: (b)'s
    host ms are taken beside it, its device ms are the card's), and one
    rank's share of each tensor-parallel cell of ``TP_CELLS`` (c). Returns
    the decode launches, the flash launches (forward, backward) and the
    scan launches (forward, backward) in it."""
    from torch.distributed.device_mesh import init_device_mesh
    t0 = time.perf_counter()
    tp_share_kernels()
    predictions, cells, started = dryruns
    first = {label: f.result()[0] for label, f in predictions.items()}
    log(f"[launch] (b)'s predictions done {time.perf_counter() - t0:.1f} s "
        f"into the phase")
    reading = first.pop("peak reading")
    log(f"[launch] peak of one smollm-135m train step (B 2, T 4096) on "
        f"(1, 1), torch {torch.__version__}: {json.dumps(reading)}")
    if reading["step_counter"] != reading["mem_tracker"]:
        raise AssertionError("the dry run's peak and MemTracker's differ")
    unrun = first.pop(("smollm-135m", "decode_32k", 1))
    log(f"[launch] smollm-135m x decode_32k on (1, 1) (B 128, S 32768): "
        f"fits_h100 {unrun['fits_h100']} at "
        f"{unrun['bytes_per_device'] / 1e9:.1f} GB a device; not run")
    long_pred = first.pop(("zamba2-2.7b", "long_500k", 1))
    k, train_pred = smallest_fitting_grad_accum(first)
    with nccl_group():
        mesh = init_device_mesh(DEV, (1, 1),
                                mesh_dim_names=("data", "model"))
        decode = long_decode_cell(mesh, long_pred)
        fwd, bwd = train_cell(mesh, k, train_pred)
    log(f"[launch] (b) done {time.perf_counter() - t0:.1f} s into the "
        f"phase")
    production = production_dryruns(cells, started)
    log(f"[launch] (a) done {time.perf_counter() - t0:.1f} s into the "
        f"phase")
    scan = np.zeros(2, dtype=int)
    for arch, shape, rank in TP_CELLS:
        n = tp_share(arch, shape, rank, production[(arch, shape, False,
                                                    rank)])
        decode, fwd, bwd = decode + n[0], fwd + n[1], bwd + n[2]
        scan += n[3:]
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[launch] phase {time.perf_counter() - t0:.1f} s, decode launches "
        f"{decode}, flash launches (fwd, bwd) ({fwd}, {bwd}), scan "
        f"launches (fwd, bwd) ({scan[0]}, {scan[1]})")
    return decode, fwd, bwd, int(scan[0]), int(scan[1])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    started = time.perf_counter()

    def mark(done: str) -> None:
        log(f"[time] {time.perf_counter() - started:.1f} s, after {done}")

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
    # zamba2's long_500k cell (phase 23): checked at B 3 with lengths 0, S
    # and a ragged one, timed at B 1 over one layer (5.4 GB of cache)
    check_and_time_decode_attention(
        f"{zamba.name} long_500k", zamba.n_heads, zamba.n_kv_heads, zamba.hd,
        1, rng, B=3, S=LONG_S, lengths=[0, LONG_S, 300001],
        timed_lengths=[LONG_S])
    torch.cuda.empty_cache()
    check_kv_seq_split()
    check_kv_seq_split(whisper.name, whisper.n_heads, whisper.n_kv_heads,
                       whisper.hd)
    mark("phases 1 to 3")

    model, params, reqs, records, counts = serve_full_width(smollm, rng)
    launches = counts["decode_attention"]
    where_the_time_goes(model, params, rng)
    parity_bf16(model, params, reqs, records)
    del model, params, records
    parity_fp32(smollm, rng)

    from repro_torch.launch import serve
    serve.main(["--arch", "smollm-135m", "--requests", "8", "--max-new",
                "16", "--slots", "8", "--max-len", "512"])
    mark("phases 4 to 6")

    flash_rows = check_flash_attention()
    check_and_time_decode_attention(
        "smollm-135m fabric serve", smollm.n_heads, smollm.n_kv_heads,
        smollm.hd, 0, rng, B=4, S=256, lengths=[0, 12, 19, 256 + 5])
    timing = time_flash_attention()
    time_flash_routes()
    mark("phase 7")
    train_stats, (fwd_launches, bwd_launches) = train_full_width(smollm)
    train_graphed_against_eager(smollm)
    adafactor_graphed_against_eager(smollm)
    train_parity(smollm)
    decode, fwd, bwd, ssd_launches, scan_bwd = distributed_phase(
        smollm, qwen, mamba, whisper)
    launches += decode
    fwd_launches += fwd
    bwd_launches += bwd
    mark("phases 8, 9 and 22")

    ssd_rows = check_ssd_scan()
    ssd_timing, _ = time_ssd_scan(SSD_SHAPES[0]), time_ssd_scan(
        SSD_SHAPES[1])                                    # mamba2, zamba2
    bwd_rows, bwd_timing = ssd_bwd_kernel_phase()
    mark("phases 10 and 21 (a, b)")
    # fp32 parity at reduced depth: 4 SSM layers; 12 hybrid layers, two
    # groups of attn_every 6
    for cfg, depth in ((mamba, 4), (zamba, 12)):
        model, params, reqs, records, counts = serve_full_width(cfg, rng)
        ssd_launches += counts["ssd_scan"]
        where_the_time_goes(model, params, rng, n_steps=LATE_PROFILE_STEPS)
        parity_bf16(model, params, reqs, records)
        del model, params, records
        torch.cuda.empty_cache()
        parity_fp32(cfg, rng, n_layers=depth)
        prefill_fp32_full_depth(cfg, rng)
    serve.main(["--arch", "mamba2-1.3b", "--requests", "8", "--max-new",
                "16", "--slots", "8", "--max-len", "512"])
    torch.cuda.empty_cache()
    mark("phases 11 to 14")
    fabric_phase()
    service_phase()
    t0 = time.perf_counter()
    scenario_phase()
    log(f"[scenario] phase {time.perf_counter() - t0:.1f} s")
    # the services' objects hold reference cycles; each executor holds a
    # full-width train state (1.6 GB), so free them before the MoE phase
    gc.collect()
    torch.cuda.empty_cache()
    mark("phases 15 to 17")
    for phase in (lambda: moe_phase(qwen, rng),
                  lambda: encdec_phase(whisper),
                  lambda: vlm_phase(llava, rng)):
        torch.cuda.empty_cache()
        phase_launches, (fwd, bwd) = phase()
        launches += phase_launches
        fwd_launches += fwd
        bwd_launches += bwd
    torch.cuda.empty_cache()
    mark("phases 18 to 20")
    from concurrent.futures import ThreadPoolExecutor
    scan_fwd, n, fwd, bwd = ssm_train_phase(mamba, zamba)
    ssd_launches += scan_fwd
    scan_bwd += n
    fwd_launches += fwd
    bwd_launches += bwd
    torch.cuda.empty_cache()
    with ThreadPoolExecutor(DRYRUN_WORKERS) as pool:
        # checks only from here until (b), and device times
        dryruns = start_dryruns(pool)
        for cfg, depth in ((mamba, 4), (zamba, 6)):
            ssm_train_parity(cfg, depth)
        mark("phase 21")
        decode, fwd, bwd, scan_fwd, n = launch_phase(dryruns)
    launches += decode
    fwd_launches += fwd
    bwd_launches += bwd
    ssd_launches += scan_fwd
    scan_bwd += n
    mark("phase 23")

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
    kernels.append({
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:24",
        "launches": scan_bwd,
        "max_abs_err": max(row["max_abs_err"] for row in bwd_rows
                           if row["shape"] == SSD_TRAIN_SHAPES[0][0]),
        "ms": bwd_timing["ms"], "plain_ms": bwd_timing["plain_ms"],
        "bound_ms": bwd_timing["bound_ms"],
        "bound_by": bwd_timing["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
