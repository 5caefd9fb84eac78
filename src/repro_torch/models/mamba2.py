"""Mamba2 / SSD (state-space duality) blocks, chunked-scan formulation
(counterpart of ``repro/models/mamba2.py``).

The chunked algorithm splits T into chunks of Q tokens: quadratic,
attention-like work inside a chunk and a sequential recurrence of the
(H, N, P) state across chunks. ``ssd_chunked`` forms the scan's inputs and
calls it through the kernel seam (``kernels/ops.py:ssd_scan``): on the card
the hand-written CUDA scan, on the CPU its plain version, which is the
reference's jnp ``ssd_chunked`` written on (u, loga).

Decode keeps O(1) state: the conv tail and the SSM state, stepped by
``ssd_decode_step`` in plain torch ops.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

from .common import ArchConfig, dense_init, rmsnorm

G = 1   # number of B/C groups (mamba2-1.3b uses 1)


class Mamba2Params(NamedTuple):
    in_proj: torch.Tensor    # (d, 2*d_inner + 2*G*N + H)
    conv_w: torch.Tensor     # (K, conv_ch)   depthwise
    conv_b: torch.Tensor     # (conv_ch,)
    dt_bias: torch.Tensor    # (H,) fp32
    A_log: torch.Tensor      # (H,) fp32
    D: torch.Tensor          # (H,) fp32
    norm_w: torch.Tensor     # (d_inner,)
    out_proj: torch.Tensor   # (d_inner, d)


def conv_channels(cfg: ArchConfig) -> int:
    return cfg.d_inner + 2 * G * cfg.ssm_state


def init_mamba2(generator: torch.Generator, cfg: ArchConfig, device=None,
                lead: tuple[int, ...] = ()) -> Mamba2Params:
    """The reference's draws on a torch generator (fp32 on the generator's
    device): ``dt_bias`` the inverse softplus of a log-uniform dt in
    [1e-3, 1e-1], ``A_log = log(1..H)``, ``D = 1``. ``lead``: leading
    axes the leaves are stacked on (the layers)."""
    d, din, H, N = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
    ch, pd = conv_channels(cfg), cfg.param_dtype
    gdev = generator.device
    f32 = dict(dtype=torch.float32, device=device)
    log_dt = torch.rand((*lead, H), generator=generator, device=gdev) * \
        (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3)
    conv_w = torch.randn((*lead, cfg.conv_kernel, ch), generator=generator,
                         device=gdev) * 0.1
    return Mamba2Params(
        in_proj=dense_init(generator, (*lead, d, 2 * din + 2 * G * N + H),
                           dtype=pd, device=device, n_lead=len(lead)),
        conv_w=conv_w.to(device=device, dtype=pd),
        conv_b=torch.zeros((*lead, ch), dtype=pd, device=device),
        dt_bias=torch.log(torch.expm1(torch.exp(log_dt))).to(**f32),
        A_log=torch.log(torch.arange(1, H + 1, **f32)).expand(*lead, H)
        .clone(),
        D=torch.ones((*lead, H), **f32),
        norm_w=torch.ones((*lead, din), dtype=pd, device=device),
        out_proj=dense_init(generator, (*lead, din, d), dtype=pd,
                            device=device, n_lead=len(lead)),
    )


# ---------------------------------------------------------------------------
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
                initial_state: torch.Tensor | None = None,
                return_state: bool = False,
                ssd_scan: Callable = kops.ssd_scan):
    """SSD scan. x: (B,T,H,P) fp32, dt: (B,T,H), A: (H,) negative,
    Bm/Cm: (B,T,N). Returns y (B,T,H,P) [, final_state (B,H,N,P)].
    ``u = x * dt`` and ``loga = dt * A`` go to ``ssd_scan``, the seam."""
    T = x.shape[1]
    if T % chunk:
        # the reference asserts here (repro/models/mamba2.py:84)
        raise ValueError(f"T={T} not divisible by chunk={chunk}")
    u = (x * dt[..., None]).contiguous()
    loga = (dt * A[None, None, :]).contiguous()
    y, final = ssd_scan(u, loga, Bm.contiguous(), Cm.contiguous(),
                        chunk=chunk, h0=initial_state)
    return (y, final) if return_state else y


def ssd_decode_step(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor):
    """One-token recurrence. h: (B,H,N,P), x: (B,H,P), dt: (B,H),
    Bm/Cm: (B,N). Returns (y (B,H,P), h')."""
    a = torch.exp(dt * A[None, :])                        # (B,H)
    u = x * dt[..., None]                                 # (B,H,P)
    h = h * a[..., None, None] + torch.einsum("bn,bhp->bhnp", Bm, u)
    y = torch.einsum("bn,bhnp->bhp", Cm, h)
    return y, h


def _depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    tail: torch.Tensor | None = None):
    """Causal depthwise conv along T. x: (B,T,ch), w: (K,ch).
    ``tail``: (B,K-1,ch) carried state for decode/chunked prefill."""
    K = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], K - 1, x.shape[-1]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)
    T = x.shape[1]
    out = sum(xp[:, i:i + T, :] * w[i][None, None, :] for i in range(K))
    new_tail = xp[:, -(K - 1):, :]
    return out + b[None, None, :], new_tail


class MambaState(NamedTuple):
    conv_tail: torch.Tensor    # (B, K-1, conv_ch) in the compute dtype
    ssm: torch.Tensor          # (B, H, N, P) fp32


def init_mamba_state(cfg: ArchConfig, batch: int, dtype, device=None,
                     lead: tuple[int, ...] = ()) -> MambaState:
    """Zero states; ``lead``: the layer axes in front of the batch."""
    return MambaState(
        torch.zeros((*lead, batch, cfg.conv_kernel - 1, conv_channels(cfg)),
                    dtype=dtype, device=device),
        torch.zeros((*lead, batch, cfg.ssm_heads, cfg.ssm_state,
                     cfg.ssm_head_dim), dtype=torch.float32, device=device))


def mamba2_block(p: Mamba2Params, x: torch.Tensor, cfg: ArchConfig, *,
                 state: MambaState | None = None, return_state: bool = False,
                 ssd_scan: Callable = kops.ssd_scan):
    """Full block (no residual/outer norm). x: (B,T,d). A one-token call
    with a state steps the recurrence; any other runs the chunked scan
    from the state (zeros without one)."""
    Bsz, T, d = x.shape
    din, H, N, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    cd = cfg.compute_dtype
    proj = x @ p.in_proj.to(cd)                           # (B,T,dp)
    z, xbc, dt_raw = torch.split(
        proj, [din, conv_channels(cfg), H], dim=-1)
    xbc, new_tail = _depthwise_conv(
        xbc, p.conv_w.to(cd), p.conv_b.to(cd),
        tail=None if state is None else state.conv_tail.to(cd))
    xbc = F.silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [din, G * N, G * N], dim=-1)
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    A = -torch.exp(p.A_log)

    xs4 = xs.reshape(Bsz, T, H, P).float()
    Bm32, Cm32 = Bm.float(), Cm.float()
    if T == 1 and state is not None:
        y, ssm = ssd_decode_step(state.ssm, xs4[:, 0], dt[:, 0], A,
                                 Bm32[:, 0], Cm32[:, 0])
        y = y[:, None]
    else:
        init = state.ssm if state is not None else None
        out = ssd_chunked(xs4, dt, A, Bm32, Cm32,
                          chunk=min(cfg.ssm_chunk, T), initial_state=init,
                          return_state=return_state, ssd_scan=ssd_scan)
        y, ssm = out if return_state else (out, None)
    y = y + p.D[None, None, :, None] * xs4                # skip connection
    y = y.reshape(Bsz, T, din).to(cd)
    y = rmsnorm(y * F.silu(z), p.norm_w, cfg.norm_eps)
    out = y @ p.out_proj.to(cd)
    if return_state or (T == 1 and state is not None):
        return out, MambaState(new_tail.to(x.dtype), ssm)
    return out, None
