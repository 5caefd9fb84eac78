"""Sharding rules and the sharded train step (counterpart of
``repro/distributed/sharding.py`` and of ``jax.jit(build_train_step(...),
in_shardings=...)``).

Specs (``logical.P``) for every param, cache, batch and optimizer tree,
per architecture family and mesh, entry for entry the reference's:
  * TP over "model": attention heads / d_ff / experts / vocab;
  * FSDP over "data": the non-TP matrix dimension of every large weight;
  * batch over ("pod", "data");
  * "pod" additionally shards MoE expert weights;
  * KV caches shard heads over "model" when H_kv >= axis size, else
    head_dim;
  * SSM states shard heads over "model", batch over data.
Spec trees have the exact structure of the trees they describe
(NamedTuples preserved). A mesh is a ``DeviceMesh`` with
``mesh_dim_names``; the spec functions read only its names and shape.

``to_named`` gives each spec its DTensor placements, ``place`` lays a
tree out by them, and ``shard_train_step`` trains on the placed state.
Each leaf is gathered along the data axes (FSDP), but the expert-parallel
MoE stacks, a layer at a time, as the reference's scan over the stacked
layers leaves XLA to place each layer's collectives in the loop body: the
step hands the model its leaves as ``Placed`` (the rank's block and its
layouts), each layer gathers its own slices at its start
(``gather_layer``) and drops them at its end, and its gradient is reduced
to the leaf's shard as the backward leaves that layer; the leaves outside
the stacks are gathered where they are used. Along ``"model"`` the
dense, vlm, ssm, hybrid, enc-dec and expert-parallel MoE families compute
tensor-parallel (``tensor_parallel.plan``: attention in one of its five
modes, the enc-dec encoder's by its own plan and the cross-attention by
the decoder's, ``d_ff`` (the MoE's shared experts), the SSM heads and
vocab local to a rank where m divides them, the routed experts by expert
parallelism over every axis, ``tp_layouts`` the leaves' layouts for it); a
grouped-dispatch MoE gathers each leaf whole along ``"model"`` too, so its
ranks along it compute the same rows.

A serve cell's KV cache under the "kv_replicated" plan (m divides the
query heads, the KV heads divide m) is the port's own layout, ``tp_cache``:
(L, B, S, m, hd), each KV head repeated m / Hkv times in rank order and
sharded on the head dim along ``"model"``, so a rank holds its own KV head
whole, (B/data, S, 1, hd) a layer, and decode runs ``decode_attention`` on
it with no gather along ``"model"``. The reference's spec shards
``head_dim`` there instead (``_kv_spec``: Hkv < m), which cannot feed a
kernel that takes whole heads without an all-to-all each step. So a rank
holds 1/Hkv of the cache's heads where the reference holds 1/m of its
``head_dim``: m / Hkv times the reference's bytes a rank (twice for
llama-3.1-8b and llama-3.2-1b, 8 KV heads, at m = 16).

A serve cell's KV cache where the decode plan is "kv_seq" (the dense and
vlm families, m dividing neither the query heads nor, with the KV heads
dividing m, leaving them whole, and m dividing the cache's positions S:
minitron-4b, llava-next-34b and the smollms at m = 16) is split over its
positions, ``tp_cache``: the spec ``P(None, batch, "model", None, None)``,
so rank r holds positions ``[r S/m, (r+1) S/m)`` of every KV head, whole
in ``head_dim``, (B/data, S/m, Hkv, hd) a layer, and decode runs
``decode_attention`` on them and merges the ranks' partials by their
log-sum-exp. The reference's spec shards ``head_dim`` there (``_kv_spec``:
Hkv < m): the same bytes a rank, 1/m of the cache, split by position, not
by ``head_dim``, so the kernel keeps whole heads and RoPE's pairs (i, i +
hd/2) stay on one rank, and the ranks exchange a (B, Hq, hd + 1) fp32
partial a layer where a ``head_dim`` split would all-reduce the (B, Hq,
S) scores. The cache's layout follows the decode plan for the same S
whatever step writes it, a prefill too.

An enc-dec serve cell's cross K/V (each decoder layer's K and V of the
encoder's output, (L, B, enc_len, Hkv, hd)) follow the decoder's heads:
where they split over m ("local"), the rank's heads, as the reference's
spec; under "kv_replicated" the repeated layout of the self K/V above;
otherwise (the decoder's decode plan "kv_seq" or "gathered") the port's
own layout, ``tp_cache``: ``Replicate()`` along ``"model"``, so every rank
holds them whole and no step gathers them, and every rank computes the
cross-attention whole. The reference's spec shards ``head_dim`` there
(``_kv_spec``: Hkv < m), 1/m of them a rank: whisper-tiny at m = 16 holds
36.9 MB a data rank of 8 rows (4 layers x 8 x 1500 x 6 x 64 x 2 B, K and
V) where the reference holds 2.3 MB. A split over the encoder's positions
with a log-sum-exp merge is not done: 16 does not divide 1500, and the
cross-attention is no kernel. Its self K/V are laid out as the dense
family's (split over their positions under "kv_seq").

A serve cell's mamba2 conv tail where the SSM heads are local (m divides
them) is the port's own layout too, ``tp_cache``: (..., B, K-1, m (din/m +
2N)), rank-major, rank r's block its heads' x channels then B and C whole
(one group: every head reads them), sharded on the last axis along
``"model"``, so a rank holds (B/data, K-1, din/m + 2N) a layer, the conv
channels ``mamba2_block`` reads on its heads. The reference's spec
(``_mamba_state_spec``: ``P(b, None, "model")``) cuts the din + 2N
channels evenly, not by component, which would leave B and C on the last
rank alone. B and C are repeated m times: they are state, written alike
by every rank, so the copies stay equal; a rank holds din/m + 2N channels
where the reference's holds (din + 2N)/m (mamba2-1.3b at m = 16: 512
against 272). The SSM state keeps the reference's layout, heads along
``"model"``.

A mamba2 block's ``in_proj``, ``conv_w`` and ``conv_b`` are stored under
the reference's specs (``P("data", "model")``, ``P(None, "model")``,
``P("model")``), and where the plan's layout is "by_rank" (the SSM heads
local, m dividing N: ``tensor_parallel.ssm_by_rank``) their columns are
stored in the by-rank order (``ssm_rank_columns``), so the even cut along
``"model"`` is each rank's own block, ``[z_r, x_r, B_r, C_r, dt_r]`` and
``[x_r, B_r, C_r]``: a layer's gather runs along the data axes alone, and
the rank all-gathers only B and C along ``"model"``
(``Route.ssm_slice``). The order is a permutation applied where a state
is placed (``place_state``; ``whole_state`` undoes it), not in the
leaves' definition: one device, the engine, the weight bridge and a
checkpoint of whole leaves keep the reference's order. Where m does not
divide N ("whole") the leaves keep the reference's order and each layer
gathers them whole along ``"model"``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.distributed import logical, tensor_parallel

from repro_torch.models import transformer as tfm
from repro_torch.models.attention import AttnParams
from repro_torch.models.common import (ArchConfig, Deferred, tree_leaves,
                                      tree_map)
from repro_torch.models.ffn import MLPParams, MoEParams
from repro_torch.models.mamba2 import Mamba2Params, MambaState
from repro_torch.train.train_step import build_train_step

from .logical import P, placements


def _axis(mesh, name: str) -> int:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))[name]


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"


def map_specs(fn, spec_tree, *rest):
    """``fn(spec, *matching subtrees of rest)`` at every ``P`` of
    ``spec_tree``, keeping its dicts, lists, tuples and NamedTuples (the
    trees in ``rest`` are matched by key and position, so they may be of
    other NamedTuple types); None stays None."""
    if isinstance(spec_tree, P):
        return fn(spec_tree, *rest)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, s, *(r[k] for r in rest))
                for k, s in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        out = [map_specs(fn, s, *(r[i] for r in rest))
               for i, s in enumerate(spec_tree)]
        return (type(spec_tree)(*out) if hasattr(spec_tree, "_fields")
                else type(spec_tree)(out))
    return None


# ---------------------------------------------------------------------------
# per-structure specs (leading L axis on stacked layer params is unsharded)
# ---------------------------------------------------------------------------
def attn_specs(l=None) -> AttnParams:
    lead = (None,) if l is not None else ()
    return AttnParams(
        wq=P(*lead, "data", "model"),
        wk=P(*lead, "data", "model"),
        wv=P(*lead, "data", "model"),
        wo=P(*lead, "model", "data"),
    )


def mlp_specs(l=None) -> MLPParams:
    lead = (None,) if l is not None else ()
    return MLPParams(
        w_gate=P(*lead, "data", "model"),
        w_up=P(*lead, "data", "model"),
        w_down=P(*lead, "model", "data"),
    )


def moe_specs(cfg: ArchConfig, mesh, l=None) -> MoEParams:
    lead = (None,) if l is not None else ()
    # experts over model (EP) + Megatron col/row split of each expert's MLP
    # over data; "pod" additionally shards the expert dim when present and
    # divisible
    if cfg.moe_impl == "ep" and cfg.moe_pad_experts:
        # EP: whole experts sharded over EVERY mesh axis (tokens a2a to them)
        e_axis = tuple(mesh.mesh_dim_names)
        return MoEParams(
            router=P(*lead, None, None),
            w_gate=P(*lead, e_axis, None, None),
            w_up=P(*lead, e_axis, None, None),
            w_down=P(*lead, e_axis, None, None),
            shared=mlp_specs(l) if cfg.n_shared_experts else None,
        )
    e_axis: object = "model"
    if "pod" in mesh.mesh_dim_names and cfg.n_experts % (
            _axis(mesh, "model") * _axis(mesh, "pod")) == 0:
        e_axis = ("pod", "model")
    # grouped dispatch: experts over model; when the per-model-shard slab
    # is small (qwen-class), keep d/ff unsharded so the expert einsum is
    # fully local
    per_shard_gb = (cfg.n_experts / _axis(mesh, "model") * cfg.d_model
                    * cfg.d_ff * 3 * 2 * (cfg.n_layers)) / 1e9
    if per_shard_gb <= 4.0:
        return MoEParams(
            router=P(*lead, None, None),
            w_gate=P(*lead, e_axis, None, None),
            w_up=P(*lead, e_axis, None, None),
            w_down=P(*lead, e_axis, None, None),
            shared=mlp_specs(l) if cfg.n_shared_experts else None,
        )
    return MoEParams(
        router=P(*lead, None, None),
        w_gate=P(*lead, e_axis, "data", None),
        w_up=P(*lead, e_axis, "data", None),
        w_down=P(*lead, e_axis, "data", None),
        shared=mlp_specs(l) if cfg.n_shared_experts else None,
    )


def mamba_specs(cfg: ArchConfig, l=None) -> Mamba2Params:
    lead = (None,) if l is not None else ()
    return Mamba2Params(
        in_proj=P(*lead, "data", "model"),
        conv_w=P(*lead, None, "model"),
        conv_b=P(*lead, "model"),
        dt_bias=P(*lead, None),
        A_log=P(*lead, None),
        D=P(*lead, None),
        norm_w=P(*lead, "model"),
        out_proj=P(*lead, "model", "data"),
    )


def _norm(l=None):
    return P(None, None) if l is not None else P(None)


# ---------------------------------------------------------------------------
def param_specs(cfg: ArchConfig, mesh):
    """Spec tree matching ``model.init``'s structure."""
    fam = cfg.family
    if fam in ("dense", "vlm"):
        specs = {
            "embed": P("model", "data"),
            "layers": tfm.DenseLayer(attn=attn_specs(l=0),
                                     mlp=mlp_specs(l=0), norm1=_norm(0),
                                     norm2=_norm(0)),
            "final_norm": _norm(),
            "lm_head": P("data", "model"),
        }
        if fam == "vlm":
            specs["patch_proj"] = P("data", "model")
        return specs
    if fam == "moe":
        return {
            "embed": P("model", "data"),
            "layers": tfm.MoELayer(attn=attn_specs(l=0),
                                   moe=moe_specs(cfg, mesh, l=0),
                                   norm1=_norm(0), norm2=_norm(0)),
            "final_norm": _norm(),
            "lm_head": P("data", "model"),
        }
    if fam == "ssm":
        return {
            "embed": P("model", "data"),
            "layers": tfm.SSMLayer(mamba=mamba_specs(cfg, l=0),
                                   norm=_norm(0)),
            "final_norm": _norm(),
            "lm_head": P("data", "model"),
        }
    if fam == "hybrid":
        # layers have an extra (group, per_group) leading pair
        g = map_specs(lambda s: P(None, *s), mamba_specs(cfg, l=0))
        return {
            "embed": P("model", "data"),
            "layers": tfm.SSMLayer(mamba=g, norm=P(None, None, None)),
            "shared_attn": attn_specs(),
            "shared_mlp": mlp_specs(),
            "shared_norm1": _norm(), "shared_norm2": _norm(),
            "final_norm": _norm(),
            "lm_head": P("data", "model"),
        }
    if fam == "encdec":
        return {
            "embed": P("model", "data"),
            "enc_layers": tfm.EncLayer(attn=attn_specs(l=0),
                                       mlp=mlp_specs(l=0), norm1=_norm(0),
                                       norm2=_norm(0)),
            "dec_layers": tfm.DecLayer(self_attn=attn_specs(l=0),
                                       cross_attn=attn_specs(l=0),
                                       mlp=mlp_specs(l=0), norm1=_norm(0),
                                       norm2=_norm(0), norm3=_norm(0)),
            "enc_norm": _norm(),
            "final_norm": _norm(),
            "lm_head": P("data", "model"),
        }
    raise ValueError(fam)


# ---------------------------------------------------------------------------
def _kv_spec(cfg: ArchConfig, mesh, *, lead: int) -> P:
    """(lead..., B, S, H_kv, hd): shard heads over model if divisible-ish,
    else shard head_dim."""
    m = _axis(mesh, "model")
    pre = (None,) * lead
    b = batch_axes(mesh)
    if cfg.n_kv_heads >= m:
        return P(*pre, b, None, "model", None)
    return P(*pre, b, None, None, "model")


def cache_specs(cfg: ArchConfig, mesh):
    """Spec tree matching ``model.init_cache``'s structure."""
    fam = cfg.family
    b = batch_axes(mesh)
    if fam in ("dense", "vlm", "moe"):
        return {"k": _kv_spec(cfg, mesh, lead=1),
                "v": _kv_spec(cfg, mesh, lead=1),
                "index": P(b)}
    if fam == "ssm":
        return {"state": _mamba_state_spec(cfg, mesh, lead=1),
                "index": P(b)}
    if fam == "hybrid":
        return {"state": _mamba_state_spec(cfg, mesh, lead=2),
                "k": _kv_spec(cfg, mesh, lead=1),
                "v": _kv_spec(cfg, mesh, lead=1),
                "index": P(b)}
    if fam == "encdec":
        return {"k": _kv_spec(cfg, mesh, lead=1),
                "v": _kv_spec(cfg, mesh, lead=1),
                "cross_k": _kv_spec(cfg, mesh, lead=1),
                "cross_v": _kv_spec(cfg, mesh, lead=1),
                "index": P(b)}
    raise ValueError(fam)


def tp_cache(cfg: ArchConfig, mesh, cache: dict) -> tuple[dict, dict]:
    """A serve cell's cache tree (``model.init_cache``'s) and its fitted
    spec tree on ``mesh``: ``cache_specs``'s, except where the
    tensor-parallel decode plan is "kv_replicated", whose K and V become
    (L, B, S, m, hd), each KV head repeated for the m / Hkv ranks that
    attend with it, the head dim sharded along ``"model"``, where it is
    "kv_seq", whose K and V are sharded on their positions along
    ``"model"`` (every head whole), an enc-dec model's cross K/V the rank's
    heads where they split (repeated as the self K/V under
    "kv_replicated"), else whole along ``"model"``, and where the SSM
    heads are local, whose conv tail becomes (..., B, K-1, m (din/m +
    2N)), each rank's x channels then B and C (``ssm_tail_layout``), the
    last axis sharded along ``"model"`` (the module's docstring says
    why)."""
    specs = fit_tree(mesh, cache_specs(cfg, mesh), cache)
    plan = tensor_parallel.mesh_plan(
        cfg, mesh, kind="decode", seq_len=1,
        cache_len=cache["k"].shape[2] if "k" in cache else None)
    if plan is None:
        return cache, specs
    if plan.heads == "kv_seq":
        spec = fit_spec(mesh, P(None, batch_axes(mesh), "model", None, None),
                        cache["k"].shape)
        specs = {**specs, "k": spec, "v": spec}
    if plan.heads == "kv_replicated":
        kv = {k: cache[k].repeat_interleave(plan.kv_share, dim=3)
              for k in ("k", "v", "cross_k", "cross_v") if k in cache}
        cache = {**cache, **kv}
        specs = {**specs, **{k: fit_spec(
            mesh, P(None, batch_axes(mesh), None, "model", None), t.shape)
            for k, t in kv.items()}}
    elif "cross_k" in cache and not plan.heads_local:
        spec = fit_spec(mesh, P(None, batch_axes(mesh), None, None, None),
                        cache["cross_k"].shape)
        specs = {**specs, "cross_k": spec, "cross_v": spec}
    if plan.ssm == "local":
        st = cache["state"]
        tail = ssm_tail_layout(st.conv_tail, plan.model, cfg.d_inner)
        lead = (None,) * (tail.ndim - 3)
        spec = fit_spec(mesh, P(*lead, batch_axes(mesh), None, "model"),
                        tail.shape)
        cache = {**cache, "state": st._replace(conv_tail=tail)}
        specs = {**specs, "state": specs["state"]._replace(conv_tail=spec)}
    return cache, specs


def ssm_tail_layout(tail: torch.Tensor, m: int, d_inner: int
                    ) -> torch.Tensor:
    """A whole conv tail (..., K-1, din + 2N), channels [x, B, C], as m
    ranks' blocks side by side: rank r's x channels ``[r din/m, (r+1)
    din/m)``, then B and C."""
    bc = tail[..., d_inner:]
    return torch.cat([torch.cat([x, bc], dim=-1)
                      for x in tail[..., :d_inner].chunk(m, dim=-1)], dim=-1)


def ssm_rank_columns(cfg: ArchConfig, m: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The by-rank column order of a mamba2 block along a ``"model"`` axis
    of m ranks (``tensor_parallel.ssm_by_rank``), as index tensors into
    the reference's columns: ``in_proj``'s ``[z, x, B, C, dt]`` as m
    blocks ``[z_r, x_r, B_r, C_r, dt_r]`` (rank r's heads' d_inner/m
    columns of z and of x, its N/m of B's and of C's, its H/m of dt) and
    the conv channels ``[x, B, C]`` (``conv_w``'s and ``conv_b``'s) as m
    blocks ``[x_r, B_r, C_r]``. A permutation: the leaves keep their shape
    and entries, and their even cut along ``"model"`` gives each rank its
    block (at m = 1 the reference's order)."""
    din, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads

    def blocks(parts):
        # parts: (start, width a rank) of each component, in block order
        return torch.cat([torch.arange(a + r * w, a + (r + 1) * w)
                          for r in range(m) for a, w in parts])

    conv = [(0, din // m), (din, n // m), (din + n, n // m)]
    proj = [(0, din // m), (din, din // m), (2 * din, n // m),
            (2 * din + n, n // m), (2 * din + 2 * n, h // m)]
    return blocks(proj), blocks(conv)


def _reorder(state: dict, fn) -> dict:
    """``state`` with ``fn(leaf, component)`` in place of each leaf whose
    last axis is a mamba2 block's columns ("proj": ``in_proj``'s; "conv":
    ``conv_w``'s and ``conv_b``'s). ``state`` is a params tree or a train
    state ``{"params", "opt"}``: the params and the params-like slots
    (AdamW's ``m`` and ``v``, Adafactor's momentum) follow their leaf; of Adafactor's
    factored slots (a list in ``tree_leaves`` order) the column
    statistic, which keeps the leaf's last axis, follows it, and the row
    statistic, which drops it, stays; an unfactored slot follows it."""
    def params(p):
        layers = p["layers"]
        mb = layers.mamba
        mb = mb._replace(in_proj=fn(mb.in_proj, "proj"),
                         conv_w=fn(mb.conv_w, "conv"),
                         conv_b=fn(mb.conv_b, "conv"))
        return {**p, "layers": layers._replace(mamba=mb)}

    if "params" not in state:
        return params(state)
    opt = dict(state["opt"])
    for k in ("m", "v"):
        if isinstance(opt.get(k), dict):
            opt[k] = params(opt[k])
    if isinstance(opt.get("v"), list):
        kinds = tree_leaves(_reorder(
            tree_map(lambda t: "", state["params"]), lambda t, c: c))
        opt["v"] = [v if not kind else
                    {**v, "col": fn(v["col"], kind)} if "col" in v else
                    {"v": fn(v["v"], kind)}
                    for v, kind in zip(opt["v"], kinds)]
    return {**state, "params": params(state["params"]), "opt": opt}


def rank_order(cfg: ArchConfig, mesh, state: dict,
               inverse: bool = False) -> dict:
    """``state`` (whole leaves: a params tree or a train state, ``_reorder``'s)
    with its mamba2 blocks' columns in the by-rank order on ``mesh``
    (``ssm_rank_columns``), or, with ``inverse``, back in the reference's;
    ``state`` itself where the blocks are not stored by rank there. A
    leaf drawn a matrix at a time (``common.Deferred``) takes the order
    for its draws."""
    m = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    if m == 1 or not tensor_parallel.ssm_by_rank(cfg, m):
        return state
    orders = dict(zip(("proj", "conv"), ssm_rank_columns(cfg, m)))
    if inverse:
        orders = {k: torch.argsort(o) for k, o in orders.items()}

    def take(t, kind):
        if isinstance(t, Deferred):
            return t.columns(orders[kind])
        return t.index_select(-1, orders[kind].to(t.device))
    return _reorder(state, take)


def place_state(cfg: ArchConfig, mesh, state: dict, shardings,
                put=None) -> dict:
    """``state`` (a params tree or a train state of whole leaves) laid out
    on ``mesh`` by ``shardings`` (``to_named``'s of its spec tree), its
    mamba2 blocks' ``in_proj``, ``conv_w`` and ``conv_b`` and their
    optimizer slots in the by-rank column order where the plan stores them
    so (``rank_order``): the even cut of their spec along ``"model"`` is
    then each rank's own block. ``put(tree, shardings)`` lays the
    reordered tree out (``place`` by default, rank 0's values scattered;
    ``launch.build`` draws each rank's block instead). Every path that
    places an ssm or hybrid state goes through here; ``whole_state``
    undoes it."""
    return (put or place)(rank_order(cfg, mesh, state), shardings)


def whole_state(cfg: ArchConfig, mesh, state: dict) -> dict:
    """A state placed by ``place_state`` as whole tensors (every DTensor's
    ``full_tensor``) in the reference's column order: what the unsharded
    model, the weight bridge and a checkpoint read."""
    whole = tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                     else t, state)
    return rank_order(cfg, mesh, whole, inverse=True)


def _mamba_state_spec(cfg: ArchConfig, mesh, *, lead: int):
    pre = (None,) * lead
    b = batch_axes(mesh)
    return MambaState(
        conv_tail=P(*pre, b, None, "model"),
        ssm=P(*pre, b, "model", None, None),
    )


# ---------------------------------------------------------------------------
def batch_specs(cfg: ArchConfig, mesh, batch: dict) -> dict:
    """Input batch: shard the leading (global batch) dim."""
    b = batch_axes(mesh)
    out = {}
    for k, v in batch.items():
        if k in ("frames", "patch_embeds"):
            out[k] = P(b, None, None)
        else:
            out[k] = P(b, None)
    return out


def opt_state_specs(opt_name: str, pspecs, params_shape):
    """Optimizer-slot specs derived from param specs, in the reference's
    structure. adamw: m/v mirror params. adafactor: row drops the last
    param axis, col drops the second-to-last."""
    if opt_name == "adamw":
        return {"m": pspecs, "v": pspecs, "step": P()}

    def slot_spec(spec: P, x):
        if len(x.shape) >= 2:
            return {"row": P(*spec[:-1]), "col": P(*spec[:-2], spec[-1])}
        return {"v": spec}

    return {"v": map_specs(slot_spec, pspecs, params_shape), "step": P()}


def _axes_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return math.prod(_axis(mesh, a) for a in entry)
    return _axis(mesh, entry)


def fit_spec(mesh, spec: P, shape) -> P:
    """Drop mesh axes that do not divide the corresponding dim (every
    shard even; e.g. whisper's vocab 51865 is indivisible by any axis ->
    replicate that dim)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    fitted = []
    for dim, entry in zip(shape, entries[:len(shape)]):
        if entry is not None and dim % _axes_size(mesh, entry) != 0:
            # try single-axis fallback for multi-axis entries
            if isinstance(entry, (tuple, list)):
                kept = [a for a in entry
                        if dim % _axis(mesh, a) == 0]
                entry = tuple(kept[:1]) if kept else None
                if entry and dim % _axes_size(mesh, entry) != 0:
                    entry = None
            else:
                entry = None
        fitted.append(entry)
    return P(*fitted)


def fit_tree(mesh, spec_tree, shape_tree):
    """fit_spec over matching trees (NamedTuple structures preserved)."""
    return map_specs(lambda s, x: fit_spec(mesh, s, x.shape), spec_tree,
                     shape_tree)


# ---------------------------------------------------------------------------
# placement on a DeviceMesh
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout: its mesh and DTensor placements (one a mesh dim)."""
    mesh: object
    placements: tuple


def to_named(mesh, spec_tree):
    return map_specs(lambda s: NamedSharding(mesh, tuple(placements(mesh, s))),
                     spec_tree)


def place(tree, shardings):
    """Each leaf as a DTensor laid out by its ``NamedSharding`` (the
    counterpart of ``jax.device_put(tree, shardings)``): rank 0's values
    are scattered, and each rank keeps exactly the slice its spec names
    (``fit_spec`` has made every shard even)."""
    return tree_map(lambda t, s: distribute_tensor(t, s.mesh,
                                                   list(s.placements)),
                    tree, shardings)


def local_shard(mesh, t: torch.Tensor, placement) -> torch.Tensor:
    """The slice of the whole tensor ``t`` that this rank holds under
    ``placement`` (even shards; a dim sharded over several mesh dims is cut
    major to minor, as DTensor cuts it)."""
    for j, p in enumerate(placement):
        if isinstance(p, Shard):
            t = t.chunk(mesh.size(j), dim=p.dim)[mesh.get_local_rank(j)]
    return t


def train_state_specs(state: dict, opt_name: str, pspecs) -> dict:
    """The spec tree of the port's train state ``{"params", "opt"}``:
    ``opt_state_specs`` laid out as the port's optimizer keeps its state
    (Adafactor's slots as a list in ``tree_leaves`` order, its bf16
    momentum, where kept, as the params)."""
    params = state["params"]
    ospecs = opt_state_specs(opt_name, pspecs, params)
    if opt_name == "adafactor":
        slots = []
        tree_map(lambda p, s: slots.append(s), params, ospecs["v"])
        ospecs = {"v": slots, "step": ospecs["step"]}
        if "m" in state["opt"]:
            ospecs["m"] = pspecs
    return {"params": pspecs, "opt": ospecs}


def tp_layouts(cfg: ArchConfig, mesh, plan) -> dict:
    """Each param leaf of a dense, vlm, ssm, hybrid, MoE or enc-dec model
    under a tensor-parallel ``plan``, as (the placements it is computed in, its
    gradient's): whole along the data axes, where the gradient is a
    partial sum (each rank saw its own rows); along ``"model"`` sharded
    where the plan makes its product local (the gradient is then the
    shard's own), else whole, its gradient a partial sum where
    sequence-parallel ranks each saw a slice of the positions or each
    took its own columns (``wk``/``wv`` under "kv_replicated"; a mamba2
    block's ``in_proj``, ``conv_w`` and ``conv_b`` where its heads are
    local and the layout is "whole", ``Route.ssm_slice``; under "by_rank"
    they are sharded on their columns, each rank's block its own) (and
    ``patch_proj`` where the vocab is local: it counts on rank 0 alone,
    ``Route.embed``; ``lm_head`` where
    the vocab is whole, ``Plan.loss_rows``: each rank's logits are its own
    positions'), else equal on every rank. Under "q_seq" the attention's
    leaves are whole, their gradients partial sums (its training is
    sequence-parallel: each rank saw its own query rows). An MoE layer's
    expert stacks stay in ``moe_specs``' expert-parallel placement, each
    rank's experts whole and never gathered, their gradients the experts'
    own; its router is whole, its gradient a partial sum over every axis
    (each rank routed its own block of tokens); its shared experts are
    laid out as the MLP. An enc-dec model's encoder leaves (and ``enc_norm``) follow the
    encoder's plan (in a decode step, which runs no encoder, the
    decoder's), its decoder's and its cross-attention's the decoder's (the
    cross ``wk``/``wv`` as the self-attention's: the rank's heads, its KV
    head's columns, or whole). Stacked leaves keep their lead axes (the
    layers; the hybrid's groups and layers), the shared block's have
    none."""
    names = mesh.mesh_dim_names
    baxes = ("pod", "data") if "pod" in names else ("data",)
    sp = plan.seq_parallel

    def lay(dim: int, local: bool, partial: bool = sp) -> tuple:
        along = (Shard(dim) if local else Partial() if partial
                 else Replicate())
        return ([Shard(dim) if n == "model" and local else Replicate()
                 for n in names],
                [Partial() if n in baxes else along if n == "model"
                 else Replicate() for n in names])

    def attn(lead: int, pl=plan) -> AttnParams:
        h, psp = pl.heads_local, pl.seq_parallel
        kv = lay(lead + 1, pl.heads == "local",
                 partial=psp or pl.heads == "kv_replicated")
        return AttnParams(lay(lead + 1, h, psp), kv, kv, lay(lead, h, psp))

    def mlp(lead: int, pl=plan) -> MLPParams:
        f, psp = pl.mlp_local, pl.seq_parallel
        return MLPParams(lay(lead + 1, f, psp), lay(lead + 1, f, psp),
                         lay(lead, f, psp))

    def moe(lead: int) -> MoEParams:
        stack = [Shard(lead)] * len(names)
        return MoEParams(router=lay(0, False, partial=True),
                         w_gate=(stack, stack), w_up=(stack, stack),
                         w_down=(stack, stack),
                         shared=mlp(lead) if cfg.n_shared_experts else None)

    def mamba(lead: int) -> Mamba2Params:
        s = plan.ssm == "local"
        heads = lay(lead, s)
        if plan.ssm_layout == "by_rank":     # each rank's block, its own
            mat, vec = lay(lead + 1, True), lay(lead, True)
            return Mamba2Params(in_proj=mat, conv_w=mat, conv_b=vec,
                                dt_bias=heads, A_log=heads, D=heads,
                                norm_w=heads, out_proj=heads)
        cols = lay(0, False, partial=sp or s)
        return Mamba2Params(in_proj=cols, conv_w=cols, conv_b=cols,
                            dt_bias=heads, A_log=heads, D=heads,
                            norm_w=heads, out_proj=heads)

    out = {"embed": lay(0, plan.vocab_local),
           "final_norm": lay(0, False),
           "lm_head": lay(1, plan.vocab_local, partial=plan.loss_rows)}
    if cfg.family in ("dense", "vlm"):
        out["layers"] = tfm.DenseLayer(attn=attn(1), mlp=mlp(1),
                                       norm1=lay(0, False),
                                       norm2=lay(0, False))
    elif cfg.family == "moe":
        out["layers"] = tfm.MoELayer(attn=attn(1), moe=moe(1),
                                     norm1=lay(0, False),
                                     norm2=lay(0, False))
    elif cfg.family == "ssm":
        out["layers"] = tfm.SSMLayer(mamba=mamba(1), norm=lay(0, False))
    elif cfg.family == "hybrid":
        out.update(layers=tfm.SSMLayer(mamba=mamba(2),
                                       norm=lay(0, False)),
                   shared_attn=attn(0), shared_mlp=mlp(0),
                   shared_norm1=lay(0, False), shared_norm2=lay(0, False))
    elif cfg.family == "encdec":
        enc = plan.encoder or plan
        esp = enc.seq_parallel
        out.update(enc_layers=tfm.EncLayer(attn=attn(1, enc),
                                           mlp=mlp(1, enc),
                                           norm1=lay(0, False, esp),
                                           norm2=lay(0, False, esp)),
                   dec_layers=tfm.DecLayer(self_attn=attn(1),
                                           cross_attn=attn(1), mlp=mlp(1),
                                           norm1=lay(0, False),
                                           norm2=lay(0, False),
                                           norm3=lay(0, False)),
                   enc_norm=lay(0, False, esp))
    else:
        raise ValueError(f"no tensor-parallel layout for {cfg.family}")
    if cfg.family == "vlm":
        out["patch_proj"] = lay(0, False, partial=sp or plan.vocab_local)
    return out


def same_layout(mesh, have, want) -> bool:
    """Placements that differ only on mesh dims of one rank lay a tensor
    out alike (a one-rank block is the whole)."""
    return all(a == b or mesh.size(j) == 1
               for j, (a, b) in enumerate(zip(have, want)))


def _drop_lead(placements):
    """Placements of a stack's slice along its axis 0: its sharded dims
    one lower (no stack is sharded on its lead axis)."""
    if placements is None:
        return None
    if any(isinstance(p, Shard) and p.dim == 0 for p in placements):
        raise ValueError(f"a stack sharded on its lead axis: {placements}")
    return tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                 for p in placements)


@dataclass(frozen=True)
class Placed:
    """A param leaf as a step hands it to the model: ``local``, the rank's
    block of it, laid out on ``mesh`` by ``placements`` (its stored
    ones), with the placements the step computes it in (``compute``: a
    ``tp_layouts`` entry's first, or whole) and its gradient's (``grad``:
    the entry's second, or a partial sum over the batch axes; None where
    no gradient is taken, a serve step). ``unbind(0)`` gives a stacked
    leaf's layers (views of the rank's block, nothing gathered), each with
    the layouts less the lead axis, as ``transformer.unstack`` takes a
    plain stack apart; ``shape`` is the local shape ``gather`` gives, lead
    axes kept (the widths ``Route.check`` reads).

    The stack is taken apart on the rank's block, not as a DTensor: the
    layers' gradients stack as plain tensors into the block's, which
    ``to_local``'s backward lays out in the leaf's placements on the
    leaf's own mesh. (Under PyTorch 2.11 the gradient of a DTensor
    ``unbind`` came back on the mesh of an earlier fake world, whose
    process groups the next world lacks.)"""

    local: torch.Tensor
    mesh: object
    placements: tuple
    compute: tuple
    grad: tuple | None = None

    @classmethod
    def of(cls, t: DTensor, compute, grad=None) -> Placed:
        """``t``'s block (its gradient comes back in ``t``'s placements)
        with the layouts ``compute`` and ``grad``."""
        return cls(t.to_local(), t.device_mesh, tuple(t.placements),
                   tuple(compute), None if grad is None else tuple(grad))

    def unbind(self, dim: int = 0) -> list:
        if dim != 0:
            raise ValueError("a stack is taken apart along its axis 0")
        lead = dict(placements=_drop_lead(self.placements),
                    compute=_drop_lead(self.compute),
                    grad=_drop_lead(self.grad))
        return [replace(self, local=s, **lead)
                for s in self.local.unbind(0)]

    @property
    def shape(self) -> torch.Size:
        shape = list(self.local.shape)
        for j, (have, want) in enumerate(zip(self.placements,
                                             self.compute)):
            if isinstance(have, Shard):
                shape[have.dim] *= self.mesh.size(j)
            if isinstance(want, Shard):
                shape[want.dim] //= self.mesh.size(j)
        return torch.Size(shape)

    def gather(self) -> torch.Tensor:
        """The local tensor in ``compute``: a differentiable redistribute
        whose gradient comes back in ``grad`` and is reduced into the
        stored placements (a reduce-scatter along the data axes); with no
        gradient, the block itself where it already is that."""
        if self.grad is None and same_layout(self.mesh, self.placements,
                                             self.compute):
            return self.local
        t = DTensor.from_local(self.local, self.mesh, self.placements,
                               run_check=False)
        return t.redistribute(self.mesh, self.compute).to_local(
            grad_placements=self.grad)


def gather_layer(tree):
    """One layer's leaves as this rank computes with them: each ``Placed``
    leaf (a layer's slice of a stacked leaf, or a leaf outside the stacks)
    gathered (``Placed.gather``), every other leaf as it is (the identity
    on plain tensors: one device, the engine, ``TorchExecutor``). The
    models call it at the start of each layer, so a layer's gathered copy
    lives while the layer runs: under ``remat="block"`` it is dropped at
    the end of the layer's forward and gathered again in its recompute,
    never saved for the backward; under ``remat="none"`` autograd saves
    it for the backward, as it saves any operand of a product."""
    return tree_map(lambda x: x.gather() if isinstance(x, Placed) else x,
                    tree)


class _LocalLoss:
    """``model.loss_fn`` on this rank's rows of a global batch. Each
    DTensor leaf goes to the model as a ``Placed`` leaf, which the model
    gathers a layer at a time (``gather_layer``): for the tensor-parallel
    families into its ``tp_layouts`` placements under the tensor-parallel
    plan of the batch, with the logical policy (and so the ``"model"``
    group) installed around the model's loss; for the others whole. Its
    gradient comes back in the placements given to ``to_local`` (a
    partial sum over the batch axes, as every rank along them saw other
    rows), so autograd reduces each layer's into the leaf's placements as
    the backward leaves the layer. The local loss is scaled by this rank's
    share of the global token count, so the sum over ranks is the global
    mean whatever each rank's mask holds."""

    def __init__(self, model, mesh) -> None:
        self.model, self.mesh = model, mesh
        names = mesh.mesh_dim_names
        baxes = ("pod", "data") if "pod" in names else ("data",)
        self.full = [Replicate()] * mesh.ndim
        self.partial = [Partial() if n in baxes else Replicate()
                        for n in names]
        self.n_rows = math.prod(_axis(mesh, a) for a in baxes)

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the batch axes (ranks along the others
        hold the same value)."""
        return DTensor.from_local(x, self.mesh, self.partial).full_tensor()

    def rows(self, batch: dict) -> dict:
        specs = batch_specs(self.model.cfg, self.mesh, batch)
        for k, v in batch.items():
            if v.shape[0] % self.n_rows:
                raise ValueError(f"batch {k}: {v.shape[0]} rows do not "
                                 f"divide over {self.n_rows} batch ranks")
        return {k: local_shard(self.mesh, v, placements(self.mesh, specs[k]))
                for k, v in batch.items()}

    def loss_fn(self, params: dict, batch: dict) -> torch.Tensor:
        mb = self.rows(batch)
        mask = mb.get("loss_mask")
        count = (mask.float().sum() if mask is not None else
                 torch.tensor(float(mb["labels"].numel()),
                              device=mb["labels"].device))
        share = count / torch.clamp_min(self.batch_sum(count), 1.0)
        cfg = self.model.cfg
        plan = tensor_parallel.mesh_plan(
            cfg, self.mesh, kind="train",
            seq_len=tensor_parallel.residual_len(cfg, mb),
            rows=mb["tokens"].shape[0])
        if plan is None:
            placed = tree_map(
                lambda t: Placed.of(t, self.full, self.partial), params)
            return self.model.loss_fn(placed, mb) * share
        placed = tree_map(lambda t, lay: Placed.of(t, *lay), params,
                          tp_layouts(cfg, self.mesh, plan))
        with logical.policy(self.mesh):
            return self.model.loss_fn(placed, mb) * share


def shard_train_step(model, opt, mesh, *, compress=None, grad_accum=1):
    """The train step on a state placed by ``place`` (params and
    optimizer state as DTensors in their specs' placements): the
    counterpart of ``jax.jit(build_train_step(model, opt, ...),
    in_shardings=...)``. It takes the global batch (the same on every
    rank), as ``build_train_step`` does; each rank runs the model's
    ``loss_fn`` on its ``batch_specs`` rows (microbatches along axis 0 of
    the global batch first when ``grad_accum`` > 1). The gradients come
    back as DTensors in the params' placements, the optimizer and
    ``compress`` run on them (DTensor reduces the global norm, Adafactor's
    means and the int8 scale over whole leaves), and the metrics are the
    global loss and the norm over whole gradients. The model gathers each
    layer's leaves along the data axes when the layer runs and drops them
    when it ends; each layer's gradient is reduce-scattered to its shard
    as the backward leaves that layer (``gather_layer``). The dense, vlm,
    ssm, hybrid, enc-dec and expert-parallel MoE families compute
    tensor-parallel along ``"model"`` (``_LocalLoss``). An MoE loss adds
    the aux over every rank's tokens, the same on every rank, to each
    rank's NLL; weighed by the rank's token share, the sum over the batch
    ranks is the reference's loss, and the aux's statistics take each
    batch rank's gradient once (``tensor_parallel.stat_sum``).

    A grouped-dispatch MoE (``moe_impl="gspmd"``) computes whole, its aux
    over a rank's own rows, so it trains here only with the batch on one
    rank."""
    loss = _LocalLoss(model, mesh)
    cfg = model.cfg
    if (cfg.family == "moe" and not tensor_parallel.computes_tp(cfg)
            and loss.n_rows > 1):
        raise NotImplementedError(
            "a grouped-dispatch MoE's auxiliary loss over a batch split "
            "across ranks")
    step = build_train_step(loss, opt, grad_accum=grad_accum,
                            compress=compress)

    def sharded(state: dict, batch: dict):
        state, m = step(state, batch)
        return state, {"loss": loss.batch_sum(m["loss"]),
                       "grad_norm": m["grad_norm"].full_tensor()}

    return sharded
