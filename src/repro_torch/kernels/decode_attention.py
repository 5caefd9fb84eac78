"""Decode attention on the card: the wrapper of the hand-written CUDA kernel
``csrc/decode_attention.cu`` (it replaces the Pallas ``_decode_kernel`` of
``repro/kernels/decode_attention.py``).

One new token per sequence against a slot-contiguous KV cache, GQA,
per-sequence valid lengths. The kernel reads the layer's (B, S, Hkv, hd)
slice of the (L, B, S, Hkv, hd) cache through its strides: unlike the Pallas
wrapper there is no transposed copy per call. The plain version is
``repro_torch.kernels.ref.decode_attention_ref``; ``ops.decode_attention``
picks between the two by the device of the tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

KERNEL = "decode_attention"
HEAD_DIMS = (32, 64, 80, 96, 112, 128)
MAX_GROUP = 8                      # kMaxGroup in the source
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _function():
    lib = build.load(KERNEL)
    fn = lib.repro_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _L, _L, _L, _L, _L, _L, _L, _L, ctypes.c_float, _P]
        fn.restype = _I
    return fn


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
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, hd); k/v: (B, S, Hkv, hd) with any batch, sequence and
    head strides; lengths: (B,) int32, ``length > S`` read as S and
    ``length == 0`` giving zeros. Returns (B, Hq, hd) in q's dtype.

    Launches on the current stream without synchronising; raises on any
    input the kernel does not take and when the launch is refused."""
    _check(q, k, v, lengths)
    B, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    out = torch.empty((B, Hq, hd), dtype=q.dtype, device=q.device)
    fn = _function()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, hd,
                 _DTYPES[q.dtype], q.stride(0), q.stride(1), k.stride(0),
                 k.stride(1), k.stride(2), v.stride(0), v.stride(1),
                 v.stride(2), 1.0 / hd ** 0.5, stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
