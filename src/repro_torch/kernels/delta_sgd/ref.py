"""Plain PyTorch versions of the Δ-SGD kernel pair.

Port of ``repro/kernels/delta_sgd/ref.py``: the packed (C, N) pair and
the single-tensor pair (``norms_ref``, ``apply_ref``). The wrappers in ``delta_sgd.py`` use these for CPU tensors; the tests
and ``chip_smoke.py`` hold the CUDA kernels against them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def norms_ref(g: torch.Tensor, g_prev: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(Σ(g−g_prev)², Σg²)`` over one tensor of any shape, in f32 ->
    two 0-d f32 tensors."""
    g32 = g.to(torch.float32)
    d = g32 - g_prev.to(torch.float32)
    return (d * d).sum(), (g32 * g32).sum()


def apply_ref(p: torch.Tensor, g: torch.Tensor, eta) -> torch.Tensor:
    """``p − η·g`` in f32, rounded to p's dtype (round to nearest even).
    ``eta`` is a Python float or a 0-d f32 tensor; the multiply and the
    subtract round separately."""
    return (p.to(torch.float32) - eta * g.to(torch.float32)).to(p.dtype)


def batched_norms_ref(g: torch.Tensor, g_prev: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-client ``(Σ(g−g_prev)², Σg²)`` over packed (C, N) -> two (C,)."""
    g32 = g.to(torch.float32)
    d = g32 - g_prev.to(torch.float32)
    return (d * d).sum(dim=1), (g32 * g32).sum(dim=1)


def batched_apply_ref(p: torch.Tensor, g: torch.Tensor, eta: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``P − η_c·G`` on (C, N) with per-client η (C,); where the (N,)
    mask is > 0 the result is rounded f32 -> bf16 -> f32 (round to
    nearest even). The multiply and the subtract round separately."""
    r = p.to(torch.float32) - eta[:, None] * g.to(torch.float32)
    if mask is None:
        return r.to(p.dtype)
    rounded = r.to(torch.bfloat16).to(torch.float32)
    return torch.where(mask[None, :] > 0.0, rounded, r).to(p.dtype)
