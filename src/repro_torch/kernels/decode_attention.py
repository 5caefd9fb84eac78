"""Decode attention on the card: the wrapper of the hand-written CUDA kernel
``csrc/decode_attention.cu`` (it replaces the Pallas ``_decode_kernel`` of
``repro/kernels/decode_attention.py``).

One new token per sequence against a slot-contiguous KV cache, GQA,
per-sequence valid lengths. The kernel reads the layer's (B, S, Hkv, hd)
slice of the (L, B, S, Hkv, hd) cache through its strides: unlike the Pallas
wrapper there is no transposed copy per call. It splits each sequence over
``split_plan``'s blocks and merges their partials in the same launch, in a
workspace and counters this module owns (one set per device and size, zeros
at rest, never freed, so a captured CUDA graph keeps valid pointers; calls
share them, so they run on one stream at a time). With ``return_lse`` it
also returns each query's log-sum-exp and the output in fp32: a partial
over one block of the cache's positions, which
``ref.merge_attention_partials`` merges with the other blocks' (the
tensor-parallel "kv_seq" ranks). The plain version is
``repro_torch.kernels.ref.decode_attention_ref``
(``decode_attention_split_ref`` computes the kernel's partials and merge);
``ops.decode_attention`` picks between the two by the device of the tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

KERNEL = "decode_attention"
HEAD_DIMS = (32, 64, 80, 96, 112, 128)
MAX_GROUP = 8                      # kMaxGroup in the source
TILE = 64                          # keys per pipeline stage (kTile)
MAX_SPLITS = 256                   # kMaxSplits
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_N_SM: dict[int, int] = {}
_WORKSPACE: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def _function():
    lib = build.load(KERNEL)
    fn = lib.repro_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 8 + [_L] * 8 + [ctypes.c_float, _P]
        fn.restype = _I
    return fn


def split_plan(B: int, Hkv: int, S: int, n_sm: int) -> tuple[int, int]:
    """(splits, tiles_per_split) for a call: split s of a sequence takes the
    64-key tiles [s * tps, (s + 1) * tps). The host does not know the
    lengths, so the plan comes from S, B * Hkv and the SM count alone: at
    least two blocks per SM (``B * Hkv * splits >= 2 * n_sm``) where S has
    that many tiles, one split once ``B * Hkv`` fills the card, and at most
    ``MAX_SPLITS``. Every split starts before S. Tiles per split are a power
    of two, which measured fastest at the served shapes
    (``scripts/decode_split_sweep.py``)."""
    n_tiles = -(-S // TILE)
    want = min(n_tiles, max(1, -(-2 * n_sm // (B * Hkv))))
    per = n_tiles // want
    tps = max(1 << (per.bit_length() - 1), -(-n_tiles // MAX_SPLITS))
    return -(-n_tiles // tps), tps


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _N_SM:
        _N_SM[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _N_SM[idx]


def _workspace(device: torch.device, n_float: int, n_count: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The partials' fp32 workspace and the int32 counters, made with
    ``torch.zeros`` once per (device, size) and kept: the kernel leaves the
    counters at zero, so no call allocates or clears anything, and a CUDA
    graph's replays find them at zero too. They must exist before a
    capture (a ``torch.zeros`` inside one would land in the graph's pool
    and never be cleared again): ``graphs.CompiledStep`` runs its first
    call eagerly, which makes them."""
    key = (device, n_float, n_count)
    if key not in _WORKSPACE:
        _WORKSPACE[key] = (
            torch.zeros(n_float, dtype=torch.float32, device=device),
            torch.zeros(n_count, dtype=torch.int32, device=device))
    return _WORKSPACE[key]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention kernel needs CUDA tensors, got "
                         f"{q.device}; the plain version is ops' CPU path")
    for name, t in (("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype} k {k.dtype} v {v.dtype}: "
                         "the kernel takes fp32 or bf16, all the same")
    if lengths.dtype != torch.int32 or lengths.dim() != 1 or \
            not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous (B,) int32 tensor")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}: want (B,Hq,hd), (B,S,Hkv,hd)")
    B, Hq, hd = q.shape
    Bk, S, Hkv, hdk = k.shape
    if Bk != B or hdk != hd or lengths.shape[0] != B:
        raise ValueError("batch or head_dim mismatch between q, k/v, lengths")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"Hq {Hq} / Hkv {Hkv}: group must be whole and "
                         f"at most {MAX_GROUP}")
    if not 0 < B <= 65535 or S <= 0:
        raise ValueError(f"batch {B} or sequence {S} out of range")
    if q.stride(2) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the last dimension of q, k and v must be contiguous")
    vec = 16 // k.element_size()          # 16-byte loads along hd
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned, with batch, "
                             f"sequence and head strides multiples of {vec}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, return_lse: bool = False
                     ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """q: (B, Hq, hd); k/v: (B, S, Hkv, hd) with any batch, sequence and
    head strides; lengths: (B,) int32, ``length > S`` read as S and
    ``length == 0`` giving zeros. Returns (B, Hq, hd) in q's dtype; with
    ``return_lse``, (that output in fp32, (B, Hq) fp32 log-sum-exp of the
    scaled scores over the valid keys, -inf at length 0).

    Launches on the current stream without synchronising; raises on any
    input the kernel does not take and when the launch is refused."""
    _check(q, k, v, lengths)
    B, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    splits, tps = split_plan(B, Hkv, S, _sm_count(q.device))
    ws, counters = _workspace(q.device, B * Hq * splits * (hd + 2), B * Hkv)
    out = torch.empty((B, Hq, hd), device=q.device,
                      dtype=torch.float32 if return_lse else q.dtype)
    lse = (torch.empty((B, Hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = _function()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), ws.data_ptr(),
                 counters.data_ptr(), B, Hq, Hkv, S, hd, _DTYPES[q.dtype],
                 splits, tps, q.stride(0), q.stride(1), k.stride(0),
                 k.stride(1), k.stride(2), v.stride(0), v.stride(1),
                 v.stride(2), 1.0 / hd ** 0.5, stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out if lse is None else (out, lse)


decode_attention.launches = 0
