#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each fatal on failure (nothing is caught):
  1. the card's name and power limit (``nvidia-smi``); TF32 off for
     matrix products and cuDNN, so fp32 results compare in full fp32;
  2. builds every kernel of the served path from ``src/repro_torch/kernels/
     csrc`` with ``nvcc`` (one process per source, started together);
  3. holds each kernel against its plain PyTorch version on the card at the
     decode shapes of smollm-135m and llama-3.2-1b (B 8, S 2048; lengths 0,
     1, S and past S among them), fp32 at 1e-4 and bf16 at 2e-2, and times
     kernel, plain version and a library call at the served shape;
  4. serves 16 requests at the full width of smollm-135m in bf16 through
     ``ServingEngine`` (8 slots, max_len 2048, prompts of 8 to 1500 tokens,
     32 new tokens, one request submitted mid-flight) and checks that every
     decode step of every layer launched the kernel;
  5. parity: a served bf16 stream teacher-forced through the same model with
     the plain attention, and fp32 engine streams against a sequential
     single-request reference with the plain attention;
  6. ``repro_torch.launch.serve`` at full width.

It then prints the kernels line and, last, the device line as JSON. Exits
non-zero without a CUDA card or outside a checkout of the repository.
"""
from __future__ import annotations

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
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 served logits against the same model with the plain attention: the
# two paths round K/V, q and the residual stream to bf16 at other places
# (batch of 8 against a batch of 1, decode kernel against plain einsums),
# and 30 layers carry that rounding (~2^-8 relative) into logits of size ~1.
BF16_LOGIT_ATOL = 0.15
# fp32: a greedy stream may differ only after a step where the reference's
# top-2 margin is under this (sums in another order, ~1e-6 relative).
FP32_TIE_MARGIN = 1e-3


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


# --------------------------------------------------------------- phase 3 --
def check_and_time_decode_attention(name, Hq, Hkv, hd, L, rng):
    """Kernel against plain on the card in fp32 and bf16, then timings in
    bf16 over L layers of cache (more bytes than the 50 MB L2 holds, as a
    decode step finds them)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    dev = torch.device(DEV)
    lengths = np.concatenate([[0, 1, S, S + 5],
                              rng.integers(8, 1533, B - 4)]).astype(np.int32)
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
    valid = int(np.minimum(lengths, S).sum())
    elt = 2
    nbytes = 2 * valid * Hkv * hd * elt + 2 * B * Hq * hd * elt + 4 * B
    flops = 4 * valid * Hq * hd
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    row = {"shape": name, "B": B, "S": S, "Hq": Hq, "Hkv": Hkv, "hd": hd,
           "lengths": lengths.tolist(),
           "max_abs_err_fp32": errs[torch.float32],
           "max_abs_err_bf16": errs[torch.bfloat16],
           **times, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    log(f"[kernel] decode_attention {json.dumps(row)}")
    return row


# --------------------------------------------------------------- phase 4 --
def serve_full_width(cfg, rng):
    """Serves 16 requests at full width in bf16. Returns the model, its
    params, the requests, each decode step's logits with the slot map it
    ran under, and the kernel's launches in the run."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models.transformer import DenseLM
    from repro_torch.serve.engine import Request, ServingEngine
    model = DenseLM(cfg, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    lens = np.concatenate([[8, 1500, 1024, 300],
                           rng.integers(8, 1500, 12)])
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]

    warm = ServingEngine(model, params, n_slots=B, max_len=S, seed=SEED)
    warm.run([Request(prompts[0], max_new_tokens=4),
              Request(prompts[2], max_new_tokens=4)])

    eng = ServingEngine(model, params, n_slots=B, max_len=S, seed=SEED)
    records, finite = [], torch.ones((), dtype=torch.bool, device=DEV)
    plain_decode = model.decode

    def recording_decode(p, tokens, cache):
        nonlocal finite
        logits, cache = plain_decode(p, tokens, cache)
        finite = finite & torch.isfinite(logits).all()
        records.append(({s: r.req_id for s, r in eng.active.items()},
                        logits[:, -1].clone()))
        return logits, cache

    model.decode = recording_decode
    reqs = [Request(p, max_new_tokens=32, tenant=f"tenant-{i % 4}")
            for i, p in enumerate(prompts)]
    decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs[:-1]:
        eng.submit(r)
    done = eng.step()
    eng.submit(reqs[-1])                         # arrives mid-flight
    while eng.waiting or eng.active:
        done.extend(eng.step())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = decode_attention.launches
    model.decode = plain_decode

    if len(done) != len(reqs) or not all(r.done for r in reqs):
        raise AssertionError(f"{len(done)} of {len(reqs)} requests finished")
    if not bool(finite):
        raise AssertionError("non-finite logits in a served decode step")
    if launches != cfg.n_layers * eng.steps or eng.steps == 0:
        raise AssertionError(f"decode_attention launched {launches} times "
                             f"in {eng.steps} steps of {cfg.n_layers} layers")
    stats = {"requests": len(done), "prompt_tokens": int(lens.sum()),
             "tokens_generated": eng.tokens_generated,
             "engine_steps": eng.steps, "wall_s": wall,
             "tok_per_s": eng.tokens_generated / wall,
             "mean_occupancy": eng.tokens_generated / (eng.steps * B),
             "decode_attention_launches": launches}
    log(f"[serve] {json.dumps(stats)}")
    return model, params, reqs, records, launches


def where_the_time_goes(model, params, rng, n_steps=10):
    """Decode steps of a full engine by host clock, then the same number of
    steps under the profiler for device busy time by kernel; prefill time
    of one request at a few prompt lengths."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request, ServingEngine
    eng = ServingEngine(model, params, n_slots=B, max_len=S, seed=SEED)
    for n in (8, 1500, 1024, 300, 500, 700, 900, 100):
        eng.submit(Request(rng.integers(0, model.cfg.vocab_size, n)
                           .astype(np.int32), max_new_tokens=4 * n_steps))
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    kernels = [(e.key, e.count / n_steps,
                e.self_device_time_total / n_steps / 1e3)
               for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy_ms = sum(ms for _, _, ms in kernels)
    prefill_ms = {}
    for n in (1500, 1024, 300):
        tokens = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, n),
                                 device=DEV)[None]
        cache = model.init_cache(1, S)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
        prefill_ms[n] = (time.perf_counter() - t0) * 1e3
    top = sorted(kernels, key=lambda k: -k[2])[:6]
    stats = {"decode_step_ms": step_ms, "device_busy_ms_per_step": busy_ms,
             "device_idle_share": 1 - busy_ms / step_ms,
             "top_kernels_per_step": [[name[:60], calls, ms]
                                      for name, calls, ms in top],
             "prefill_ms": prefill_ms}
    log(f"[profile] {json.dumps(stats)}")


# --------------------------------------------------------------- phase 5 --
def teacher_forced_logits(model, params, prompt, generated):
    """(n - 1, V) logits of the decode steps of one stream of n tokens, fed
    its own tokens, on a one-slot cache."""
    cache = model.init_cache(1, S)
    tokens = torch.as_tensor(np.asarray(prompt, np.int64), device=DEV)
    _, cache = model.prefill(params, {"tokens": tokens[None]}, cache)
    out = []
    for tok in generated[:-1]:
        logits, cache = model.decode(
            params, torch.tensor([[tok]], device=DEV), cache)
        out.append(logits[0, -1])
    return torch.stack(out)


def parity_bf16(cfg, params, reqs, records):
    from repro_torch.kernels import ref
    from repro_torch.models.transformer import DenseLM
    plain = DenseLM(cfg, device=DEV,
                    decode_attention=ref.decode_attention_ref)
    worst, checked = 0.0, 0
    for req in (reqs[1], reqs[3], reqs[-1]):     # 1500, 300 and mid-flight
        served = torch.stack([lg[req.slot] for slots, lg in records
                              if slots.get(req.slot) == req.req_id])
        forced = teacher_forced_logits(plain, params, req.prompt,
                                       req.generated)
        if served.shape != forced.shape:
            raise AssertionError(f"{served.shape} served steps, "
                                 f"{forced.shape} teacher-forced")
        err = (served.float() - forced.float()).abs().amax(dim=-1)
        top2 = forced.float().topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        agree = served.argmax(-1) == forced.argmax(-1)
        log(f"[parity bf16] req {req.req_id} prompt {len(req.prompt)}: "
            f"max |dlogit| {err.max().item():.4f}, argmax agrees "
            f"{int(agree.sum())}/{len(agree)}, min margin "
            f"{margin.min().item():.4f}")
        if err.max().item() > BF16_LOGIT_ATOL:
            raise AssertionError(f"bf16 logits off by {err.max().item()}")
        if not bool(agree[margin > BF16_LOGIT_ATOL].all()):
            raise AssertionError("argmax differs where the margin exceeds "
                                 "the tolerance")
        worst, checked = max(worst, err.max().item()), checked + len(err)
    return worst, checked


def parity_fp32(cfg, rng):
    from repro_torch.kernels import ref
    from repro_torch.models.transformer import DenseLM
    from repro_torch.serve.engine import Request, ServingEngine
    cfg32 = replace(cfg, param_dtype=torch.float32,
                    compute_dtype=torch.float32)
    model = DenseLM(cfg32, device=DEV)
    params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    plain = DenseLM(cfg32, device=DEV,
                    decode_attention=ref.decode_attention_ref)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (8, 1100, 400, 57, 700)]
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
    log(f"[parity fp32] {equal}/{len(reqs)} greedy streams equal the "
        "sequential plain-attention reference")


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
    logs = build.build(["decode_attention"])
    log(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(logs)}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    smollm, llama = get_config("smollm-135m"), get_config("llama-3.2-1b")
    rows = [check_and_time_decode_attention(
        c.name, c.n_heads, c.n_kv_heads, c.hd, c.n_layers, rng)
        for c in (smollm, llama)]

    model, params, reqs, records, launches = serve_full_width(smollm, rng)
    where_the_time_goes(model, params, rng)
    worst, checked = parity_bf16(smollm, params, reqs, records)
    log(f"[parity bf16] {checked} teacher-forced steps, max |dlogit| "
        f"{worst:.4f} (tol {BF16_LOGIT_ATOL})")
    del model, params, records
    parity_fp32(smollm, rng)

    from repro_torch.launch import serve
    serve.main(["--arch", "smollm-135m", "--requests", "8", "--max-new",
                "16", "--slots", "8", "--max-len", "512"])

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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
