"""Shared model substrate: config, norms, RoPE, initializers, the loss.

Counterpart of ``repro/models/common.py``. Parameters are plain tensors in
dicts and NamedTuples; per-layer leaves are stacked on axis 0 as the
reference stacks them for ``lax.scan`` (the trunk is a Python loop over
views of them), so that the optimizer sees the same shapes.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import itertools
import math
from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                 # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 => d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 1        # dispatch groups == number of batch shards
    moe_impl: str = "gspmd"    # "gspmd" (grouped dispatch) | "ep" (a2a)
    moe_pad_experts: int = 0   # EP: experts padded to a multiple of ep_size
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # --- hybrid (zamba2) ---
    attn_every: int = 0          # shared attention block every k ssm layers
    # --- enc-dec (whisper backbone) ---
    n_enc_layers: int = 0
    enc_len: int = 1500          # audio frame positions (stub frontend)
    # --- vlm (llava backbone) ---
    n_patches: int = 0           # image patch positions (stub frontend)
    # --- common ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    # remat policy: "none" | "block" (checkpoint each layer in the scan)
    remat: str = "block"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:           # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        base = dict(
            n_layers=min(self.n_layers, 2 if self.attn_every == 0 else
                         2 * self.attn_every),
            d_model=128, d_ff=256 if self.d_ff else 0,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            vocab_size=512, head_dim=32 if self.n_heads else 0,
            n_experts=min(self.n_experts, 4), top_k=min(self.top_k, 2),
            moe_groups=1, moe_impl="gspmd", moe_pad_experts=0,
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16), ssm_head_dim=32,
            ssm_chunk=16,
            n_enc_layers=min(self.n_enc_layers, 2), enc_len=24,
            n_patches=min(self.n_patches, 16),
            param_dtype=torch.float32, compute_dtype=torch.float32,
            remat="none",
        )
        if self.attn_every:
            base["attn_every"] = 2
            base["n_layers"] = 4
        base.update(overrides)
        return replace(self, **base)


def require_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on. A CUDA device without a card
    raises: the port never falls back to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return device


# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of shape (..., head_dim/2) for given integer positions."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    inv = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., T, H, hd); sin/cos: (..., T, hd/2) broadcast over heads.
    Rotates split halves (not interleaved pairs), in fp32."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a param tree in the reference's flattening order:
    dict keys sorted, tuple and NamedTuple fields in order, None empty."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), in ``tree_leaves`` order, keeping dicts,
    lists, tuples and NamedTuples; None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return None if tree is None else fn(tree, *rest)


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's NLL in fp32 from its whole-vocab logits."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None]).squeeze(-1)
    return logz - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None, tp=None) -> torch.Tensor:
    """Mean token NLL in fp32. labels: integer, mask: optional {0,1}.
    ``tp``: a ``tensor_parallel.Route`` whose vocab is local, under which
    ``logits`` are this rank's vocab columns (the vocab-parallel loss)."""
    nll = token_nll(logits, labels) if tp is None else tp.nll(logits, labels)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def count_params(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))


# ``deferred_draws``' state while it is active: [seed, leaves deferred]
_DEFERRED: list = []


@contextlib.contextmanager
def deferred_draws(seed: int):
    """While active, ``dense_init`` and ``embed_init`` draw nothing: each
    returns a ``Deferred`` leaf, whose blocks are drawn on demand. So a
    rank that runs ``model.init`` this way draws only its block of each
    leaf (``launch.build``), never a stack whole, and ranks that share a
    block draw the same values for it. The other leaves (the norms'
    ones, mamba2's ``conv_w`` and ``dt_bias``) are built as ever, from
    the generator."""
    _DEFERRED.append([seed, 0])
    try:
        yield
    finally:
        _DEFERRED.pop()


class Deferred:
    """A leaf of ``shape`` that ``dense_init`` or ``embed_init`` has not
    drawn (``deferred_draws``). Its matrices lie on the last two dims; each
    is drawn by ``draw(generator, shape)`` in fp32, alone, from a generator
    seeded by (the context's seed, the leaf's place among the deferred
    ones, the matrix's index), and stored as ``dtype``."""

    def __init__(self, shape, draw, dtype, device) -> None:
        self.seed, self.leaf = _DEFERRED[-1]
        _DEFERRED[-1][1] += 1
        self.shape, self.draw = tuple(shape), draw
        self.dtype, self.device = dtype, device
        self.order = None

    def columns(self, order: torch.Tensor) -> Deferred:
        """The same leaf with its last axis in ``order`` (an index tensor
        into its drawn columns, a permutation): each matrix is drawn as
        before, then its columns taken in that order."""
        out = copy.copy(self)
        out.order = order
        return out

    def block(self, span) -> torch.Tensor:
        """The leaf's block [start, stop) per dim (``span``), drawing only
        its matrices. A span past the leaf's end on a leading dim (the
        experts padded for expert parallelism) holds zeros there."""
        shape, lead = self.shape, max(len(self.shape) - 2, 0)
        if any(b > n for (_, b), n in zip(span[lead:], shape[lead:])):
            raise ValueError(f"block {span} past the matrices of {shape}")
        out = torch.zeros([b - a for a, b in span], dtype=self.dtype,
                          device=self.device)
        inner = tuple(slice(a, b) for a, b in span[lead:])
        generator = torch.Generator(device=self.device)
        for index in itertools.product(*(range(a, min(b, n)) for (a, b), n
                                         in zip(span[:lead], shape[:lead]))):
            # (seed, leaf, matrix) -> a 63-bit seed: fewer than 2^24
            # matrices a leaf (kimi-k2-1t-a32b's experts: 61 x 384)
            unit = sum(i * math.prod(shape[k + 1:lead])
                       for k, i in enumerate(index))
            generator.manual_seed((((self.seed * 4099 + self.leaf) << 24)
                                   + unit) & (2 ** 63 - 1))
            w = self.draw(generator, shape[lead:])
            if self.order is not None:
                w = w[..., self.order.to(w.device)]
            out[tuple(i - a for i, (a, _) in zip(index, span))].copy_(
                w[inner])
        return out


def _dense(generator: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in) in fp32, on the generator's device."""
    w = torch.randn(shape, generator=generator, device=generator.device)
    return w / fan_in ** 0.5


def _embed(generator: torch.Generator, shape) -> torch.Tensor:
    """N(0, 1) * 0.02 in fp32, on the generator's device."""
    w = torch.randn(shape, generator=generator, device=generator.device)
    return w * 0.02


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, device=None,
               n_lead: int = 0) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in), drawn in fp32 on the generator's device.

    The first ``n_lead`` axes stack independent leaves (the layers), and
    ``in_axis`` counts from after them. Each leading index is drawn alone
    and copied into a preallocated leaf of ``dtype``, so no more than one
    layer's worth of fp32 is in flight: llava-next-34b's stacked (60, 7168,
    20480) MLP leaf drawn whole would be 35.2 GB of fp32. Under
    ``deferred_draws``, a ``Deferred`` leaf (its fan-in on one of its
    last two dims)."""
    fan_in = shape[n_lead + in_axis]
    if _DEFERRED:
        if n_lead + in_axis < len(shape) - 2:
            raise ValueError(f"fan-in axis {n_lead + in_axis} of {shape} "
                             "is not a matrix's")
        return Deferred(shape, functools.partial(_dense, fan_in=fan_in),
                        dtype, generator.device if device is None else
                        device)
    if n_lead:
        out = torch.empty(shape, dtype=dtype, device=device)
        for view in out.reshape(-1, *shape[n_lead:]):
            view.copy_(dense_init(generator, shape[n_lead:], in_axis,
                                  dtype, device))
        return out
    return _dense(generator, shape, fan_in).to(device=device, dtype=dtype)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """N(0, 1) * 0.02, drawn in fp32 on the generator's device; under
    ``deferred_draws``, a ``Deferred`` leaf."""
    if _DEFERRED:
        return Deferred(shape, _embed, dtype,
                        generator.device if device is None else device)
    return _embed(generator, shape).to(device=device, dtype=dtype)