"""Expert parallelism over all-to-all (counterpart of
``repro/models/moe_ep.py``).

Layout: experts are padded to a multiple of the EP group (every mesh axis
flattened) and each rank owns E_pad/ep whole (d x ff) experts. Tokens are
split over the same group. Per layer:

    route locally -> build per-destination capacity buffers ->
    all_to_all (tokens travel TO the experts) -> local expert matmuls ->
    all_to_all back -> weighted combine locally.

Semantics are ``ffn.moe_block``'s with one dispatch group per rank (the
same routing, the capacity drop per source shard) at the reference's EP
capacity. Every rank passes the whole ``x`` and the whole expert stacks
and gets the whole output, as the reference's ``shard_map`` gives.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .common import ArchConfig
from .ffn import MoEParams, combine, dispatch, dispatch_plan, route, swiglu


def ep_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)      # all axes, flattened


def ep_size(mesh) -> int:
    return mesh.size()


def pad_experts(cfg: ArchConfig, mesh) -> int:
    ep = ep_size(mesh)
    return -(-cfg.n_experts // ep) * ep


def _capacity(n_loc: int, cfg: ArchConfig, e_pad: int) -> int:
    """Rounded up to 4, at least 4: the reference's EP capacity, not
    ``ffn._capacity``'s 8."""
    cap = int(cfg.capacity_factor * n_loc * cfg.top_k / cfg.n_experts)
    return max(4, -(-cap // 4) * 4)


def _ep_rank(mesh) -> int:
    """This rank's place in the flattened mesh, which must be the whole
    world in rank order (as ``init_device_mesh`` lays it out), so that the
    default group is the EP group."""
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError(f"EP runs over a mesh of every rank in order, "
                         f"not {ranks}")
    return dist.get_rank()


def local_plan(p: MoEParams, x_loc: torch.Tensor, cfg: ArchConfig,
               e_pad: int, capacity: int):
    """One rank's routing of its (n_loc, d) tokens: (probs (1, n_loc, E),
    gates (1, n_loc, k), ids (1, n_loc, k), each (token, choice)'s send
    row ``expert * C + rank``, or ``e_pad * C`` where dropped, (1, n_loc
    k))."""
    probs, gates, ids = route(p, x_loc[None], cfg)
    return probs, gates, ids, dispatch_plan(ids, e_pad, capacity)


def moe_block_ep(p: MoEParams, x: torch.Tensor, cfg: ArchConfig, mesh,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d), the same on every rank of ``mesh``. Expert weights in
    ``p`` are stacked to E_pad on axis 0 (``init_moe`` pads them when
    cfg.moe_pad_experts is set). Returns (out, aux_loss), the same on
    every rank."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    ep = ep_size(mesh)
    r = _ep_rank(mesh)
    E_pad = p.w_gate.shape[0]
    e_loc = E_pad // ep
    n = B * T
    n_pad = -(-n // ep) * ep          # decode: pad tokens up to ep
    n_loc = n_pad // ep
    C = _capacity(n_loc, cfg, E_pad)
    cd = cfg.compute_dtype

    xt = F.pad(x.reshape(n, d), (0, 0, 0, n_pad - n))
    x_loc = xt[r * n_loc:(r + 1) * n_loc]
    probs, gates, ids, dest = local_plan(p, x_loc, cfg, E_pad, C)

    # global-mean load-balancing loss, as the single-device block's
    stats = torch.stack([probs.mean(dim=(0, 1)),
                         F.one_hot(ids[..., 0], E).float().mean(dim=(0, 1))])
    dist.all_reduce(stats)
    me, ce = stats / ep
    aux = E * torch.sum(me * ce)

    # ---- send buffers: slot = expert * C + rank; rank j's experts are
    # rows [j e_loc C, (j + 1) e_loc C) ----
    send = dispatch(x_loc[None], dest, k, E_pad, C).reshape(ep, e_loc * C, d)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)           # tokens to their experts
    buf = recv.reshape(ep, e_loc, C, d).transpose(0, 1) \
              .reshape(e_loc, ep * C, d).to(cd)  # my experts' rows

    mine = lambda w: w[r * e_loc:(r + 1) * e_loc].to(cd)
    g = torch.einsum("ecd,edf->ecf", buf, mine(p.w_gate))
    u = torch.einsum("ecd,edf->ecf", buf, mine(p.w_up))
    y = torch.einsum("ecf,efd->ecd", F.silu(g) * u, mine(p.w_down))

    back = y.reshape(e_loc, ep, C, d).transpose(0, 1) \
            .reshape(ep, e_loc * C, d).contiguous()
    got = torch.empty_like(back)
    dist.all_to_all_single(got, back)            # results come back
    out_loc = combine(got.reshape(1, E_pad, C, d), dest, gates)[0]

    out = out_loc.new_empty((n_pad, d))
    dist.all_gather_into_tensor(out, out_loc.contiguous())
    out = out[:n].reshape(B, T, d)
    if p.shared is not None:
        out = out + swiglu(p.shared, x.to(cd), cd)
    return out, aux
