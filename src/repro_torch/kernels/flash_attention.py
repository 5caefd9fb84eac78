"""Flash attention on the card: the wrapper of the hand-written CUDA kernels
``csrc/flash_attention.cu`` (they replace the Pallas ``_flash_kernel`` of
``repro/kernels/flash_attention.py``, and add the backward it lacks).

q: (B, T, Hq, hd); k/v: (B, S, Hkv, hd); causal or full; GQA with kv head
``h // (Hq // Hkv)``. Causal takes ``q_offset``: query row i is position
``q_offset + i`` and sees keys up to it (``qpos >= kpos`` aligned at 0 when
it is 0), so a rank that owns rows ``[a, a + T)`` of a causal attention
passes the keys ``[0, S)`` it needs (S >= a + T) and ``q_offset=a``.
bf16 runs on the tensor cores, the forward and the backward on ``wgmma``
at every head dim (``fwd_route``, ``bwd_route``); fp32 runs on the CUDA
cores. The kernels
read and write every tensor through its strides, so q, k, v and dO need no
transposed copy. ``FlashAttention`` is the ``torch.autograd.Function``
that the model differentiates: its forward saves q, k, v, O and the
per-row log-sum-exp, its backward launches the delta pre-pass, the dK/dV
and the dQ kernels. The plain version is
``repro_torch.kernels.ref.flash_attention_ref``; ``ops.flash_attention``
picks between the two by the device of the tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import check_q_offset

KERNEL = "flash_attention"
HEAD_DIMS = (32, 64, 80, 96, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("cuda cores", "wgmma")   # repro_flash_{fwd,bwd}_route
_P = ctypes.c_void_p
_I = ctypes.c_int


def fwd_route(dtype: torch.dtype, hd: int) -> str:
    """The forward kernel a call takes, the fixed table of ``launch`` in
    the source (``repro_flash_fwd_route``): fp32 on the CUDA cores, bf16 on
    ``wgmma`` at every head dim of ``HEAD_DIMS``."""
    return "wgmma" if dtype == torch.bfloat16 else "cuda cores"


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """The backward kernels a call takes (``repro_flash_bwd_route``): the
    same table as the forward's; the delta pre-pass runs on every route."""
    return fwd_route(dtype, hd)


def _library_route(name: str, dtype: torch.dtype, hd: int) -> str:
    fn = getattr(build.load(KERNEL), name)
    fn.argtypes, fn.restype = [_I, _I], _I
    return ROUTES[fn(hd, _DTYPES[dtype])]


def library_fwd_route(dtype: torch.dtype, hd: int) -> str:
    """The forward route the built library reports for (dtype, hd)."""
    return _library_route("repro_flash_fwd_route", dtype, hd)


def library_bwd_route(dtype: torch.dtype, hd: int) -> str:
    """The backward route the built library reports for (dtype, hd)."""
    return _library_route("repro_flash_bwd_route", dtype, hd)


def _functions():
    lib = build.load(KERNEL)
    fwd, bwd = lib.repro_flash_fwd, lib.repro_flash_bwd
    if fwd.argtypes is None:
        fwd.argtypes = [_P] * 5 + [_I] * 9 + [_P, ctypes.c_float, _P]
        fwd.restype = _I
        bwd.argtypes = [_P] * 10 + [_I] * 9 + [_P, ctypes.c_float, _P]
        bwd.restype = _I
    return fwd, bwd


def _strides(*tensors: torch.Tensor):
    """(batch, sequence, head) strides of each tensor, as a C array."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _check_layout(name: str, t: torch.Tensor) -> None:
    vec = 16 // t.element_size()          # 16-byte loads along hd
    if t.stride(3) != 1 or t.data_ptr() % 16 or \
            any(s % vec for s in t.stride()[:3]):
        raise ValueError(f"{name} must have a contiguous last dimension and "
                         f"be 16-byte aligned, with batch, sequence and head "
                         f"strides multiples of {vec}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           q_offset: int) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"{q.device}; the plain version is ops' CPU path")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype} k {k.dtype} v {v.dtype}: "
                         "the kernel takes fp32 or bf16, all the same")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}: want (B,T,Hq,hd), (B,S,Hkv,hd)")
    B, T, Hq, hd = q.shape
    Bk, S, Hkv, hdk = k.shape
    if Bk != B or hdk != hd:
        raise ValueError("batch or head_dim mismatch between q and k/v")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq {Hq} is not a whole multiple of Hkv {Hkv}")
    if not (0 < B <= 65535 and 0 < Hq <= 65535 and T > 0 and S > 0):
        raise ValueError(f"batch {B}, heads {Hq}, T {T} or S {S} out of range")
    check_q_offset(T, S, causal, q_offset)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, T, Hq, hd) in q's dtype, lse (B, Hq, T) fp32: a
    row for each query row, also under ``q_offset``).

    Launches on the current stream without synchronising; raises on any
    input the kernel does not take and when the launch is refused."""
    _check(q, k, v, causal, q_offset)
    B, T, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    fwd, _ = _functions()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), B, T, S, Hq, Hkv, hd, _DTYPES[q.dtype],
                  int(causal), q_offset, _strides(q, k, v, out),
                  1.0 / hd ** 0.5, stream)
    _raise_on(err, "flash_attention forward")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtype from the forward's out and lse.
    dout may have any strides; one whose last dimension is not contiguous
    or whose strides do not allow 16-byte loads is copied first. Launches
    the three backward kernels in order, counted as one launch."""
    _check(q, k, v, causal, q_offset)
    for name, t in (("out", out), ("lse", lse), ("dout", dout)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if dout.shape != q.shape or out.shape != q.shape or \
            dout.dtype != q.dtype or out.dtype != q.dtype:
        raise ValueError("out and dout must have q's shape and dtype")
    if lse.shape != (q.shape[0], q.shape[2], q.shape[1]) or \
            lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous (B, Hq, T) fp32 tensor")
    try:
        _check_layout("dout", dout)
    except ValueError:
        dout = dout.contiguous()
    _check_layout("out", out)
    B, T, Hq, hd = q.shape
    _, S, Hkv, _ = k.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    delta = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    _, bwd = _functions()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, S, Hq,
                  Hkv, hd, _DTYPES[q.dtype], int(causal), q_offset,
                  _strides(q, k, v, out, dout, dq, dk, dv), 1.0 / hd ** 0.5,
                  stream)
    _raise_on(err, "flash_attention backward")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention on the card (no double backward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int):
        out, lse = flash_attention_fwd(q, k, v, causal, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal,
                                         ctx.q_offset)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """(B, T, Hq, hd) in q's dtype; differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, causal, q_offset)
