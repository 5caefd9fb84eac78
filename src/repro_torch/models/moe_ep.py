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
capacity. The collectives are autograd functions over the functional
collectives (``tensor_parallel.all_to_all`` and ``stat_sum``), so the
block trains: the all-to-all's backward is the reverse all-to-all, and the
aux's global statistics take each distinct loss's gradient once.

Two entry points: ``moe_block_ep``, where every rank passes the whole
``x`` and the whole expert stacks and gets the whole output, as the
reference's ``shard_map`` gives (``ffn.moe_block`` under an installed
policy); and ``moe_block_tp``, the MoE sublayer of a tensor-parallel route
(``tensor_parallel.Route.moe``), on the rank's own rows and its own
experts.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp_lib

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
    return tp_lib.ep_capacity(n_loc, cfg)


def ep_group(mesh):
    """The expert-parallel group: the whole world, which the flattened
    mesh must be in rank order (as ``init_device_mesh`` lays it out)."""
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError(f"EP runs over a mesh of every rank in order, "
                         f"not {ranks}")
    return dist.group.WORLD


def local_plan(p: MoEParams, x_loc: torch.Tensor, cfg: ArchConfig,
               e_pad: int, capacity: int):
    """One rank's routing of its (n_loc, d) tokens: (probs (1, n_loc, E),
    gates (1, n_loc, k), ids (1, n_loc, k), each (token, choice)'s send
    row ``expert * C + rank``, or ``e_pad * C`` where dropped, (1, n_loc
    k))."""
    probs, gates, ids = route(p, x_loc[None], cfg)
    return probs, gates, ids, dispatch_plan(ids, e_pad, capacity)


def expert_parallel(p: MoEParams, x_loc: torch.Tensor, cfg: ArchConfig,
                    e_pad: int, group, counts: bool
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed experts on this rank's (n_loc, d) tokens ``x_loc``; ``p``
    holds the router whole and this rank's ``e_pad / ep`` experts (its
    shared experts are not used). Returns (out (n_loc, d), the aux over
    every rank's tokens, the same on every rank); ``counts``: whether this
    rank's loss is one the aux's gradient takes (``stat_sum``)."""
    n_loc, d = x_loc.shape
    E, k = cfg.n_experts, cfg.top_k
    ep = group.size()
    e_loc = e_pad // ep
    C = _capacity(n_loc, cfg, e_pad)
    cd = cfg.compute_dtype
    probs, gates, ids, dest = local_plan(p, x_loc, cfg, e_pad, C)

    # global-mean load-balancing loss, as the single-device block's
    stats = torch.stack([probs.mean(dim=(0, 1)),
                         F.one_hot(ids[..., 0], E).float().mean(dim=(0, 1))])
    me, ce = tp_lib.stat_sum(stats, group, counts) / ep
    aux = E * torch.sum(me * ce)

    # ---- send buffer: slot = expert * C + rank; rank j's experts are
    # rows [j e_loc C, (j + 1) e_loc C) ----
    send = dispatch(x_loc[None], dest, k, e_pad, C).reshape(e_pad * C, d)
    recv = tp_lib.all_to_all(send, group)          # tokens to their experts
    buf = recv.reshape(ep, e_loc, C, d).transpose(0, 1) \
              .reshape(e_loc, ep * C, d).to(cd)    # my experts' rows

    g = torch.einsum("ecd,edf->ecf", buf, p.w_gate.to(cd))
    u = torch.einsum("ecd,edf->ecf", buf, p.w_up.to(cd))
    y = torch.einsum("ecf,efd->ecd", F.silu(g) * u, p.w_down.to(cd))

    back = y.reshape(e_loc, ep, C, d).transpose(0, 1) \
            .reshape(e_pad * C, d)
    got = tp_lib.all_to_all(back, group)           # results come back
    return combine(got.reshape(1, e_pad, C, d), dest, gates)[0], aux


def moe_block_ep(p: MoEParams, x: torch.Tensor, cfg: ArchConfig, mesh,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d), the same on every rank of ``mesh``. Expert weights in
    ``p`` are stacked to E_pad on axis 0 (``init_moe`` pads them when
    cfg.moe_pad_experts is set). Rank r takes block r of the flattened
    tokens, padded with zero rows to a multiple of the group. Returns
    (out, aux_loss), the same on every rank. In the backward every rank is
    taken to repeat one loss: ``x``'s gradient and the shared experts' are
    whole on every rank, the router's and the expert stacks' are this
    rank's share (their sum over the ranks is the whole)."""
    B, T, d = x.shape
    group = ep_group(mesh)
    ep, r = group.size(), group.rank()
    E_pad = p.w_gate.shape[0]
    e_loc = E_pad // ep
    n = B * T
    n_pad = -(-n // ep) * ep          # decode: pad tokens up to ep
    n_loc = n_pad // ep
    cd = cfg.compute_dtype

    xt = F.pad(tp_lib.copy_in(x.reshape(n, d), group),
               (0, 0, 0, n_pad - n))
    mine = p._replace(**{w: getattr(p, w)[r * e_loc:(r + 1) * e_loc]
                         for w in ("w_gate", "w_up", "w_down")})
    out_loc, aux = expert_parallel(mine, xt[r * n_loc:(r + 1) * n_loc], cfg,
                                   E_pad, group, counts=r == 0)
    out = tp_lib.gather_blocks(out_loc, group, reduce_grad=False)
    out = out[:n].reshape(B, T, d)
    if p.shared is not None:
        out = out + swiglu(p.shared, x.to(cd), cd)
    return out, aux


def moe_block_tp(p: MoEParams, x: torch.Tensor, cfg: ArchConfig, tp
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE sublayer under the tensor-parallel route ``tp`` on the
    normed residual ``x`` in the residual's layout: the routed experts by
    expert parallelism over ``tp.mesh``'s every rank on this rank's block
    of its rows' tokens (``Route.moe``), ``p``'s expert stacks this rank's
    experts; the shared experts as the route's MLP. Returns (out, aux)."""
    group = ep_group(tp.mesh)
    e_pad = p.w_gate.shape[0] * group.size()
    cd = cfg.compute_dtype

    def routed(tokens, padded, counts):
        n_loc = tokens.shape[0]
        if padded and n_loc > _capacity(n_loc, cfg, e_pad):
            raise ValueError(
                f"{n_loc} tokens a rank, padded: pairs may drop, and the "
                f"dropped pairs would not be the reference's (its blocks "
                f"cross the data ranks)")
        return expert_parallel(p, tokens, cfg, e_pad, group, counts)

    shared = (None if p.shared is None else
              lambda h: swiglu(p.shared, h.to(cd), cd))
    return tp.moe(routed, shared, x)
