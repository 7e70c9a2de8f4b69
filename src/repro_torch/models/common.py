"""Shared model building blocks: inits, norms, activations, rope. Port of
``repro/models/common.py``.

Every block exposes ``init_*(gen, cfg, dtype) -> params`` and a pure
``apply``-style function over a nested dict of tensors, as the reference
does over pytrees. Weights are drawn from a ``torch.Generator`` on the
generator's device: same distributions as the reference's ``jax.random``
draws, other bits, so parity tests carry the reference's params across
(``repro_torch.interop``). The reference's logical sharding annotations
and scan-unroll switch have no meaning on one card and are left out;
its remat switch comes with the dry run that turns it on (ROADMAP A17).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------
def _trunc_normal(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """Standard normal truncated to [−2, 2], f32, on ``gen``'s device."""
    w = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return w


def dense_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.float32,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Truncated normal on [−2σ, 2σ] with σ = 1/sqrt(fan_in) (fan_in =
    shape[0] by default), drawn on ``gen``'s device. The draw is scaled
    in place: one f32 copy at a time (DeepSeek-V3's expert stacks are
    15 GB each in f32), the same bits as an out-of-place product."""
    fan = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(1, fan))
    return _trunc_normal(gen, shape).mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _trunc_normal(gen, shape).mul_(0.02).to(dtype)


def zeros_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=gen.device)


def ones_init(gen: torch.Generator, shape: Sequence[int],
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=gen.device)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * scale + bias


def init_norm(gen: torch.Generator, cfg, dtype: torch.dtype,
              d: Optional[int] = None) -> dict:
    d = d or cfg.d_model
    if cfg.norm_variant == "layernorm":
        return {"scale": ones_init(gen, (d,), dtype),
                "bias": zeros_init(gen, (d,), dtype)}
    return {"scale": ones_init(gen, (d,), dtype)}


def apply_norm(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if "bias" in params:
        return layernorm(x, params["scale"], params["bias"])
    return rmsnorm(x, params["scale"])


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


# ---------------------------------------------------------------------------
# Rotary embeddings (half-split form: x1, x2 = the two halves of hd)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)   # (hd/2,)
    angles = positions[..., None].float() * freqs        # (..., S, hd/2)
    angles = angles[..., None, :]                        # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------
def tree_size(tree) -> int:
    """Number of elements over the leaves of a nested dict of tensors."""
    if isinstance(tree, dict):
        return sum(tree_size(v) for v in tree.values())
    return int(tree.numel())
