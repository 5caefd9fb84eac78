"""Feed-forward layers: dense SwiGLU and Mixture-of-Experts
(``repro/models/ffn.py``).

MoE uses the reference's sort-based capacity dispatch: each group's
(token, choice) pairs are sorted by expert (stably), the first ``C`` of
each expert land in a (E, C, d) buffer, the experts run as one batched
product over E, and each token gathers its k weighted results back. No
(T, E, C) one-hot dispatch tensor is built. The port has no mesh, so the
expert-parallel configs (``moe_impl="ep"``) take this path, as the
reference does when no mesh is set.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import ArchConfig, dense_init


class MLPParams(NamedTuple):
    w_gate: torch.Tensor   # (d, ff)
    w_up: torch.Tensor     # (d, ff)
    w_down: torch.Tensor   # (ff, d)


def init_mlp(generator: torch.Generator, d: int, ff: int, dtype,
             device=None, lead: tuple[int, ...] = ()) -> MLPParams:
    """``lead``: leading axes the matrices are stacked on (the layers),
    drawn one leading index at a time."""
    return MLPParams(*(dense_init(generator, (*lead, *s), dtype=dtype,
                                  device=device, n_lead=len(lead))
                       for s in ((d, ff), (d, ff), (ff, d))))


def swiglu(p: MLPParams, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    g = x @ p.w_gate.to(compute_dtype)
    u = x @ p.w_up.to(compute_dtype)
    return (F.silu(g) * u) @ p.w_down.to(compute_dtype)


class MoEParams(NamedTuple):
    router: torch.Tensor     # (d, E), fp32
    w_gate: torch.Tensor     # (Ep, d, ff)
    w_up: torch.Tensor       # (Ep, d, ff)
    w_down: torch.Tensor     # (Ep, ff, d)
    shared: MLPParams | None   # shared experts, fused into one wide MLP


def init_moe(generator: torch.Generator, cfg: ArchConfig, device=None,
             lead: tuple[int, ...] = ()) -> MoEParams:
    """The router in fp32 whatever the param dtype; ``Ep = max(E,
    moe_pad_experts)`` experts, of which ``[:E]`` are used."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    Ep = max(E, cfg.moe_pad_experts)
    router = dense_init(generator, (*lead, d, E), dtype=torch.float32,
                        device=device, n_lead=len(lead))
    experts = [dense_init(generator, (*lead, Ep, *s), in_axis=1,
                          dtype=cfg.param_dtype, device=device,
                          n_lead=len(lead))
               for s in ((d, ff), (d, ff), (ff, d))]
    shared = None
    if cfg.n_shared_experts:
        shared = init_mlp(generator, d, ff * cfg.n_shared_experts,
                          cfg.param_dtype, device, lead=lead)
    return MoEParams(router, *experts, shared)


def _capacity(n_tokens: int, cfg: ArchConfig) -> int:
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)      # round up to 8, as the reference


def route(p: MoEParams, xt: torch.Tensor, cfg: ArchConfig
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs (G, ng, E), gates (G, ng, k) renormalised to sum 1, expert
    ids (G, ng, k)): an fp32 softmax over the router, then its top k."""
    probs = torch.softmax(xt.float() @ p.router, dim=-1)
    gates, expert_ids = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, expert_ids


def dispatch_plan(expert_ids: torch.Tensor, n_experts: int, capacity: int
                  ) -> torch.Tensor:
    """Each (token, choice)'s buffer row, in the flat order of
    ``expert_ids.reshape(G, ng * k)``: ``expert * C + rank``, where rank
    counts the earlier pairs (token-major) routed to the same expert, or the
    sentinel ``E * C`` when the rank reaches C (dropped); (G, ng * k). A
    stable sort and ``searchsorted(side=left)``, as the reference's; no
    host sync, so C comes from shapes."""
    G = expert_ids.shape[0]
    flat = expert_ids.reshape(G, -1)
    E, C, n = n_experts, capacity, flat.shape[1]
    sorted_expert, order = torch.sort(flat, dim=-1, stable=True)
    experts = torch.arange(E, device=flat.device).repeat(G, 1)
    first = torch.searchsorted(sorted_expert, experts, right=False)
    ranks = torch.arange(n, device=flat.device)[None, :] - torch.gather(
        first, 1, sorted_expert)
    dest = torch.where(ranks < C, sorted_expert * C + ranks, E * C)
    # back to the flat order: order is a permutation, so no index repeats
    return torch.empty_like(dest).scatter_(1, order, dest)


def dispatch(xt: torch.Tensor, dest: torch.Tensor, k: int, n_experts: int,
             capacity: int) -> torch.Tensor:
    """The (G, E, C, d) expert buffer: each kept (token, choice) pair's
    token at its row, zeros elsewhere. An index assignment in the flat
    order; only the sentinel row, sliced off, is written twice."""
    G, ng, d = xt.shape
    x_rep = xt[:, :, None].expand(G, ng, k, d).reshape(G, ng * k, d)
    buf = xt.new_zeros((G, n_experts * capacity + 1, d))
    buf[torch.arange(G, device=xt.device)[:, None], dest] = x_rep
    return buf[:, :-1].reshape(G, n_experts, capacity, d)


def expert_products(p: MoEParams, buf: torch.Tensor, cfg: ArchConfig
                    ) -> torch.Tensor:
    """Every expert's SwiGLU over its C rows, batched over E, in the
    compute dtype; the padded experts ``[E:]`` are not used."""
    E, cd = cfg.n_experts, cfg.compute_dtype
    buf = buf.to(cd)
    g = torch.einsum("gecd,edf->gecf", buf, p.w_gate[:E].to(cd))
    u = torch.einsum("gecd,edf->gecf", buf, p.w_up[:E].to(cd))
    return torch.einsum("gecf,efd->gecd", F.silu(g) * u, p.w_down[:E].to(cd))


def combine(y: torch.Tensor, dest: torch.Tensor, gates: torch.Tensor
            ) -> torch.Tensor:
    """(G, ng, d): each token gathers its k rows of ``y`` (the sentinel
    row is zeros, so a dropped choice adds nothing), weights them by its
    gates in ``y``'s dtype and sums them in choice order. A scatter-add
    would sum in another order on every run on the card (atomics)."""
    G, E, C, d = y.shape
    ng, k = gates.shape[1:]
    y = torch.cat([y.reshape(G, E * C, d), y.new_zeros((G, 1, d))], dim=1)
    rows = y[torch.arange(G, device=y.device)[:, None], dest]
    contrib = rows * gates.reshape(G, ng * k, 1).to(y.dtype)
    return contrib.reshape(G, ng, k, d).sum(dim=2)


def moe_block(p: MoEParams, x: torch.Tensor, cfg: ArchConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (out, aux_loss). Top-k routing with capacity drop
    over ``cfg.moe_groups`` groups of tokens (one group when they do not
    divide the tokens), the Switch auxiliary loss, shared experts.

    Every part works in the flat (token, choice) order, so no row is summed
    into twice and the output is the same bits on every run: the fabric
    publishes outputs by content hash."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    n = B * T
    G = max(1, cfg.moe_groups)
    if n % G:
        G = 1
    ng = n // G
    xt = x.reshape(G, ng, d)
    C = _capacity(ng, cfg)

    probs, gates, expert_ids = route(p, xt, cfg)
    me = probs.mean(dim=(0, 1))                                   # (E,)
    ce = F.one_hot(expert_ids[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)

    dest = dispatch_plan(expert_ids, E, C)                        # (G, ng k)
    y = expert_products(p, dispatch(xt, dest, k, E, C), cfg)
    out = combine(y, dest, gates)
    if p.shared is not None:
        cd = cfg.compute_dtype
        out = out + swiglu(p.shared, xt.to(cd), cd)
    return out.reshape(B, T, d), aux
