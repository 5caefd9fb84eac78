"""Shared model substrate: config, norms, RoPE, initializers, the loss.

Counterpart of ``repro/models/common.py``. Parameters are plain tensors in
dicts and NamedTuples; per-layer leaves are stacked on axis 0 as the
reference stacks them for ``lax.scan`` (the trunk is a Python loop over
views of them), so that the optimizer sees the same shapes.
"""
from __future__ import annotations

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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token NLL in fp32. labels: integer, mask: optional {0,1}."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None]).squeeze(-1)
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def count_params(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))


def dense_init(generator: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32, device=None,
               n_lead: int = 0) -> torch.Tensor:
    """N(0, 1) / sqrt(fan_in), drawn in fp32 on the generator's device.

    The first ``n_lead`` axes stack independent leaves (the layers), and
    ``in_axis`` counts from after them. Each leading index is drawn alone
    and copied into a preallocated leaf of ``dtype``, so no more than one
    layer's worth of fp32 is in flight: llava-next-34b's stacked (60, 7168,
    20480) MLP leaf drawn whole would be 35.2 GB of fp32."""
    if n_lead:
        out = torch.empty(shape, dtype=dtype, device=device)
        for view in out.reshape(-1, *shape[n_lead:]):
            view.copy_(dense_init(generator, shape[n_lead:], in_axis,
                                  dtype, device))
        return out
    fan_in = shape[in_axis]
    w = torch.randn(shape, generator=generator, device=generator.device)
    return (w / fan_in ** 0.5).to(device=device, dtype=dtype)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """N(0, 1) * 0.02, drawn in fp32 on the generator's device."""
    w = torch.randn(shape, generator=generator, device=generator.device)
    return (w * 0.02).to(device=device, dtype=dtype)
