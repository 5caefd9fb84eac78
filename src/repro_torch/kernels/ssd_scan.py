"""The SSD chunked scan on the card: the wrappers of the hand-written CUDA
kernels in ``csrc/ssd_scan.cu``, forward (it replaces the Pallas
``_ssd_kernel`` of ``repro/kernels/ssd_scan.py`` and adds the initial
state that the reference's ``ssd_chunked`` takes) and backward (the
reference has none: XLA differentiates its jnp ``ssd_chunked``).

u: (B, T, H, P); loga: (B, T, H); Bm/Cm: (B, T, N) shared by the heads;
h0: (B, H, N, P) or None; all fp32 and contiguous, ``T % chunk == 0``,
``chunk <= 256``, ``N <= 128``, P a multiple of 16. The forward returns y
(B, T, H, P) and the final state (B, H, N, P), both fp32, from the four
passes of ``ssd_plan`` (C B^T once per chunk, chunk summaries, state
passing, chunk output), counted as one launch. The backward takes dy and
the final state's gradient (or None) and gives (du, dloga, dBm, dCm, dh0)
from the six passes of ``ssd_bwd_plan``, counted as one launch of its own.
It reads the states entering each chunk from a tensor of the call's own,
which ``SSDScan`` has the forward write (B, nc, H, N, P fp32: 134 MB a
layer at mamba2-1.3b's training shape); ``ssd_scan`` takes that route only
when autograd will want a gradient, so under ``torch.no_grad`` the forward
keeps them in its workspace, as a served prefill always did. Each
direction launches on the current stream over a workspace this module
owns (one per device and size, never freed, so a captured CUDA graph keeps
valid pointers; no call reads what another left in it, and calls share
it, so they run on one stream at a time). The plain versions are
``repro_torch.kernels.ref.ssd_scan_ref`` and ``ssd_scan_bwd_ref``;
``ops.ssd_scan`` picks between kernel and plain version by the device of
the tensors.
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


def ssd_bwd_plan(B: int, T: int, H: int, P: int, N: int, Q: int) -> dict:
    """The backward's passes, as ``launch_bwd`` in the source runs them:
    each pass's grid (x, y, z) and threads a block, and the workspace's
    parts with their shapes (fp32, one after another in this order).

    - ``cb``: pass 1 of the forward again (C B^T and C^T);
    - ``summaries``: pass 2's kernel in its gradient mode, one block per
      (P slice, head, b * chunks + chunk): each chunk's sum_i exp(cum_i)
      C_i (x) dy_i, and each (chunk, head)'s prefix sums of loga;
    - ``states``: one thread per (n, p) of each (head, b), 256 a block,
      from dstate back over the chunks: the state gradients and dh0;
    - ``panel``: 64 threads per 64 x 64 tile (it, jt) of a chunk's (Q, Q)
      panel and per (chunk, b), x = it * tiles + jt; those with it >= jt
      loop over the heads: W = sum_h L_h * (dy_h u_h^T), written as W^T,
      and the row and column sums of each head's R; those above the
      diagonal write W^T's zeros;
    - ``du``: one block per (head, chunk and b): du, then dloga;
    - ``dbc``: 2 x (N rounded up) threads per (128-row tile, dC or dB,
      chunk and b) over all of N: W's products with B and C, then the
      heads' states.
    The workspace holds C B^T (``cbt``) and C^T (``ct``) as the forward's,
    the state gradients (``g``), the panel W^T, the row and column sums of
    R per head and tile (``rows``, ``cols``), the prefix sums of loga
    (``cum``) and the chunk decays last."""
    nc = T // Q
    n_pad = 32 if N <= 32 else 64 if N <= 64 else MAX_STATE
    ps = 64 if P % 64 == 0 else 32 if P % 32 == 0 else 16
    tiles = MAX_CHUNK // 64
    tq = -(-Q // 64)
    return {"chunks": nc, "p_slice": ps,
            "grids": {"cb": (tiles * tiles, B * nc, 1),
                      "summaries": (P // ps, H, B * nc),
                      "states": (-(-N * P // 256), H, B),
                      "panel": (tq * tq, B * nc, 1),
                      "du": (H, B * nc, 1),
                      "dbc": (-(-Q // 128), 2, B * nc)},
            "threads": {"cb": 256, "summaries": 256, "states": 256,
                        "panel": 64, "du": 256, "dbc": 2 * n_pad},
            "workspace": {"cbt": (B, nc, MAX_CHUNK, MAX_CHUNK),
                          "ct": (B, nc, n_pad, MAX_CHUNK),
                          "g": (B, nc, H, N, P),
                          "panel": (B, nc, MAX_CHUNK, MAX_CHUNK),
                          "rows": (B, nc, H, tiles, MAX_CHUNK),
                          "cols": (B, nc, H, tiles, MAX_CHUNK),
                          "cum": (B, nc, H, MAX_CHUNK),
                          "decay": (B, nc, H)}}


def _workspace(device: torch.device, plan: dict) -> torch.Tensor:
    """The plan's fp32 workspace, made once per (device, size) and kept.
    It must exist before a CUDA graph is captured, or it would be made in
    the graph's pool: ``graphs.CompiledStep`` runs its first call eagerly,
    which makes it."""
    n = sum(math.prod(shape) for shape in plan["workspace"].values())
    key = (device, n)
    if key not in _WORKSPACE:
        _WORKSPACE[key] = torch.empty(n, dtype=torch.float32, device=device)
    return _WORKSPACE[key]


def _function(name: str = "repro_ssd_scan"):
    """The forward's entry, or the backward's (``repro_ssd_scan_bwd``)."""
    fn = getattr(build.load(KERNEL), name)
    if fn.argtypes is None:
        n_ptr = 9 if name == "repro_ssd_scan" else 13
        fn.argtypes = [_P] * n_ptr + [_I] * 6 + [_P]
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


def _launch(fn, pointers, shape, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*pointers, *shape, stream)
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def ssd_scan_fwd(u: torch.Tensor, loga: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, *, chunk: int,
                 h0: torch.Tensor | None = None,
                 chunk_states: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, final state). ``chunk_states``: a (B, T // chunk, H, N, P) fp32
    tensor that receives the state entering each chunk, or None to keep
    them in the workspace. Launches on the current stream without
    synchronising; raises on any input the kernel does not take and when
    the launch is refused."""
    _check(u, loga, Bm, Cm, h0, chunk)
    B, T, H, P = u.shape
    N = Bm.shape[-1]
    if chunk_states is not None:
        _check_like("chunk_states", chunk_states, u,
                    (B, T // chunk, H, N, P))
    y = torch.empty_like(u)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=u.device)
    ws = _workspace(u.device, ssd_plan(B, T, H, P, N, chunk))
    _launch(_function(), [u.data_ptr(), loga.data_ptr(), Bm.data_ptr(),
                          Cm.data_ptr(), _ptr(h0), y.data_ptr(),
                          state.data_ptr(), _ptr(chunk_states),
                          ws.data_ptr()],
            (B, T, H, P, N, chunk), u.device)
    ssd_scan_fwd.launches += 1
    return y, state


ssd_scan_fwd.launches = 0


def _check_like(name: str, t: torch.Tensor, u: torch.Tensor,
                shape: tuple) -> None:
    if t.device != u.device or t.dtype != torch.float32 or \
            not t.is_contiguous() or t.shape != shape:
        raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} on {t.device}: "
                         f"want contiguous fp32 {shape} on {u.device}")


def ssd_scan_bwd(u: torch.Tensor, loga: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, chunk_states: torch.Tensor,
                 dy: torch.Tensor, dstate: torch.Tensor | None, *,
                 chunk: int) -> tuple[torch.Tensor, ...]:
    """(du, dloga, dBm, dCm, dh0), fp32, the gradient of ``ssd_scan_fwd``
    at the same inputs: ``chunk_states`` is what that forward wrote, dy
    the gradient of y (made contiguous here), dstate that of the final
    state or None for zeros; dh0 is the gradient of the state entering
    chunk 0. Launches on the current stream without synchronising; raises
    on any input the kernel does not take and when the launch is
    refused."""
    _check(u, loga, Bm, Cm, None, chunk)
    B, T, H, P = u.shape
    N = Bm.shape[-1]
    dy = dy.contiguous()
    _check_like("chunk_states", chunk_states, u, (B, T // chunk, H, N, P))
    _check_like("dy", dy, u, tuple(u.shape))
    if dstate is not None:
        dstate = dstate.contiguous()
        _check_like("dstate", dstate, u, (B, H, N, P))
    du, dloga = torch.empty_like(u), torch.empty_like(loga)
    dBm, dCm = torch.empty_like(Bm), torch.empty_like(Cm)
    dh0 = torch.empty((B, H, N, P), dtype=torch.float32, device=u.device)
    ws = _workspace(u.device, ssd_bwd_plan(B, T, H, P, N, chunk))
    _launch(_function("repro_ssd_scan_bwd"),
            [u.data_ptr(), loga.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             chunk_states.data_ptr(), dy.data_ptr(), _ptr(dstate),
             du.data_ptr(), dloga.data_ptr(), dBm.data_ptr(), dCm.data_ptr(),
             dh0.data_ptr(), ws.data_ptr()],
            (B, T, H, P, N, chunk), u.device)
    ssd_scan_bwd.launches += 1
    return du, dloga, dBm, dCm, dh0


ssd_scan_bwd.launches = 0


class SSDScan(torch.autograd.Function):
    """The kernel under autograd, forward and backward both on the card.
    The forward writes the states entering each chunk into a tensor saved
    for the backward; the gradients of u, loga, Bm, Cm and h0 all come
    from ``ssd_scan_bwd``."""

    @staticmethod
    def forward(ctx, u, loga, Bm, Cm, h0, chunk: int):
        ctx.set_materialize_grads(False)
        B, T, H, P = u.shape
        states = torch.empty((B, T // chunk, H, Bm.shape[-1], P),
                             dtype=torch.float32, device=u.device)
        y, state = ssd_scan_fwd(u, loga, Bm, Cm, chunk=chunk, h0=h0,
                                chunk_states=states)
        ctx.save_for_backward(u, loga, Bm, Cm, states)
        ctx.chunk, ctx.has_h0 = chunk, h0 is not None
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        u, loga, Bm, Cm, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(u)
        du, dloga, dBm, dCm, dh0 = ssd_scan_bwd(
            u, loga, Bm, Cm, states, dy, dstate, chunk=ctx.chunk)
        return du, dloga, dBm, dCm, dh0 if ctx.has_h0 else None, None


def ssd_scan(u: torch.Tensor, loga: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, *, chunk: int, h0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, T, H, P), final state (B, H, N, P)), both fp32: through
    ``SSDScan`` where autograd will want a gradient, else the forward
    alone, which keeps the chunk states in its workspace."""
    inputs = (u, loga, Bm, Cm, h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in inputs):
        return SSDScan.apply(u, loga, Bm, Cm, h0, chunk)
    return ssd_scan_fwd(u, loga, Bm, Cm, chunk=chunk, h0=h0)
