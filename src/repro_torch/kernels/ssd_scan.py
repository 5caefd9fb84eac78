"""The SSD chunked scan on the card: the wrapper of the hand-written CUDA
kernel ``csrc/ssd_scan.cu`` (it replaces the Pallas ``_ssd_kernel`` of
``repro/kernels/ssd_scan.py`` and adds the initial state that the
reference's ``ssd_chunked`` takes).

u: (B, T, H, P); loga: (B, T, H); Bm/Cm: (B, T, N) shared by the heads;
h0: (B, H, N, P) or None; all fp32 and contiguous, ``T % chunk == 0``,
``chunk <= 256``, ``N <= 128``, P a multiple of 16. Returns y (B, T, H, P)
and the final state (B, H, N, P), both fp32. A call launches the four
passes of ``ssd_plan`` (C B^T once per chunk, chunk summaries, state
passing, chunk output) on the current stream, counted as one launch, over a
workspace this module owns (one per device and size, never freed, so a
captured CUDA graph keeps valid pointers; calls share it, so they run on one
stream at a time). The kernel has no backward: ``SSDScan`` raises in it
rather than let autograd drop the scan's gradient. The plain version is
``repro_torch.kernels.ref.ssd_scan_ref``; ``ops.ssd_scan`` picks between
the two by the device of the tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

KERNEL = "ssd_scan"
MAX_CHUNK = 256                    # kMaxChunk in the source
MAX_STATE = 128                    # the largest N the source instantiates
_P = ctypes.c_void_p
_I = ctypes.c_int
_WORKSPACE: dict[tuple, torch.Tensor] = {}


def ssd_plan(B: int, T: int, H: int, P: int, N: int, Q: int) -> dict:
    """The passes of one call, as ``launch`` in the source runs them: each
    pass's grid (x, y, z) and the workspace's parts with their shapes
    (fp32, laid out one after another in this order).

    - ``cb``: one block per 64 x 64 tile of a chunk's (256, 256) C B^T
      panel and per (chunk, b) at (x, y) = (tile, b * chunks + chunk);
    - ``summaries`` and ``output``: one block per (P slice, head, chunk and
      b) at (x, y, z) = (P slice, head, b * chunks + chunk), the P slice 64
      columns where P allows, else 32 or 16;
    - ``states``: one thread per (n, p) of each (head, b), 256 a block.
    The workspace holds C B^T transposed (``cbt``), C^T (``ct``, N rounded
    up to 32, 64 or 128 rows), the chunk summaries that pass 3 turns into
    the state entering each chunk (``states``) and the chunk decays."""
    nc = T // Q
    n_pad = 32 if N <= 32 else 64 if N <= 64 else MAX_STATE
    ps = 64 if P % 64 == 0 else 32 if P % 32 == 0 else 16
    tiles = (MAX_CHUNK // 64) ** 2
    return {"chunks": nc, "p_slice": ps, "state_rows": n_pad,
            "grids": {"cb": (tiles, B * nc, 1),
                      "summaries": (P // ps, H, B * nc),
                      "states": (-(-N * P // 256), H, B),
                      "output": (P // ps, H, B * nc)},
            "workspace": {"cbt": (B, nc, MAX_CHUNK, MAX_CHUNK),
                          "ct": (B, nc, n_pad, MAX_CHUNK),
                          "states": (B, nc, H, N, P),
                          "decay": (B, nc, H)}}


def _workspace(device: torch.device, plan: dict) -> torch.Tensor:
    n = sum(math.prod(shape) for shape in plan["workspace"].values())
    key = (device, n)
    if key not in _WORKSPACE:
        _WORKSPACE[key] = torch.empty(n, dtype=torch.float32, device=device)
    return _WORKSPACE[key]


def _function():
    fn = build.load(KERNEL).repro_ssd_scan
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 6 + [_P]
        fn.restype = _I
    return fn


def _check(u, loga, Bm, Cm, h0, chunk: int) -> None:
    if u.device.type != "cuda":
        raise ValueError(f"ssd_scan kernel needs CUDA tensors, got "
                         f"{u.device}; the plain version is ops' CPU path")
    named = {"u": u, "loga": loga, "Bm": Bm, "Cm": Cm}
    if h0 is not None:
        named["h0"] = h0
    for name, t in named.items():
        if t.device != u.device:
            raise ValueError(f"{name} on {t.device}, u on {u.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}: the kernel takes fp32 "
                             "(the model's parity needs fp32 products)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if u.dim() != 4:
        raise ValueError(f"u {tuple(u.shape)}: want (B, T, H, P)")
    B, T, H, P = u.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    if loga.shape != (B, T, H) or Bm.shape != (B, T, N) or \
            Cm.shape != Bm.shape:
        raise ValueError(f"shapes loga {tuple(loga.shape)} Bm "
                         f"{tuple(Bm.shape)} Cm {tuple(Cm.shape)}: want "
                         f"({B}, {T}, {H}) and ({B}, {T}, N)")
    if h0 is not None and h0.shape != (B, H, N, P):
        raise ValueError(f"h0 {tuple(h0.shape)}: want {(B, H, N, P)}")
    if not 0 < chunk <= MAX_CHUNK or T % chunk:
        raise ValueError(f"chunk {chunk}: want 0 < chunk <= {MAX_CHUNK} "
                         f"dividing T={T}")
    if not 0 < N <= MAX_STATE or P <= 0 or P % 16:
        raise ValueError(f"N {N} or P {P}: want N <= {MAX_STATE} and P a "
                         "multiple of 16")
    if not (0 < B and 0 < H <= 65535 and B * (T // chunk) <= 65535):
        raise ValueError(f"batch {B}, heads {H} or chunks {T // chunk} out "
                         "of range")


def ssd_scan_fwd(u: torch.Tensor, loga: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, *, chunk: int,
                 h0: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, final state). Launches on the current stream without
    synchronising; raises on any input the kernel does not take and when
    the launch is refused."""
    _check(u, loga, Bm, Cm, h0, chunk)
    B, T, H, P = u.shape
    N = Bm.shape[-1]
    y = torch.empty_like(u)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=u.device)
    ws = _workspace(u.device, ssd_plan(B, T, H, P, N, chunk))
    fn = _function()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(u.data_ptr(), loga.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 state.data_ptr(), ws.data_ptr(), B, T, H, P, N, chunk,
                 stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    ssd_scan_fwd.launches += 1
    return y, state


ssd_scan_fwd.launches = 0


class SSDScan(torch.autograd.Function):
    """The kernel under autograd: its backward raises, so that a loss
    through the scan on the card fails instead of silently losing the
    scan's gradient."""

    @staticmethod
    def forward(ctx, u, loga, Bm, Cm, h0, chunk: int):
        return ssd_scan_fwd(u, loga, Bm, Cm, chunk=chunk, h0=h0)

    @staticmethod
    def backward(ctx, dy, dstate):
        raise NotImplementedError(
            "ssd_scan has no backward kernel on the card yet: training the "
            "SSM and hybrid families comes with the later SSM training slice "
            "of the port (the plain version ref.ssd_scan_ref differentiates "
            "on the CPU)")


def ssd_scan(u: torch.Tensor, loga: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int, h0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, T, H, P), final state (B, H, N, P)), both fp32."""
    return SSDScan.apply(u, loga, Bm, Cm, h0, chunk)
