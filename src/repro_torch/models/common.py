"""Shared model building blocks. Port of ``dense_init`` from
``repro/models/common.py``; norms, RoPE and the other blocks of the LM zoo
come with ROADMAP A15."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def dense_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.float32,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Truncated normal on [−2σ, 2σ] with σ = 1/sqrt(fan_in) (fan_in =
    shape[0] by default), drawn on the CPU from ``gen``. The reference
    draws from ``jax.random``: the two agree in distribution, not in
    bits, so parity tests carry the reference's params across
    (``repro_torch.interop``)."""
    fan = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(1, fan))
    w = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return (w * std).to(dtype)
