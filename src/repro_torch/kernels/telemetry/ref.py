"""Plain PyTorch versions of the telemetry kernels.

Port of ``repro/kernels/telemetry/ref.py``. Both reduce a per-client
(C,) vector (round-end Δ-SGD step sizes, per-client mean losses) to a
fixed-shape summary:

  lane_histogram_ref  (C,) f32 + (B+1,) edges -> (B,) f32 counts. Bin b
                      counts ``edges[b] <= x < edges[b+1]``; NaN fails
                      both comparisons and counts nowhere. Counts are
                      exact small integers in f32.
  lane_quantiles_ref  (C,) f32 -> (Q,) f32 order statistics at the
                      sorted positions ``quantile_indices(C, Q)``.

The sort orders as ``jnp.sort`` does: NaN after +inf, and ties (−0.0
against +0.0, NaN against NaN) in lane order. It sorts canonical keys
(every zero +0.0, every NaN the same NaN) stably and gathers the
original values, so −0.0 and +0.0 come out in lane order on the CPU and
on the card alike. The wrappers in ``telemetry.py`` use these for CPU
tensors; the tests and ``chip_smoke.py`` hold the CUDA kernels against
them.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def quantile_indices(C: int, Q: int = 11) -> Tuple[int, ...]:
    """Sorted-order indices of the Q evenly spaced quantile fractions of
    a C-element vector: nearest rank, rounded half to even (np.round)."""
    if C < 1 or Q < 2:
        raise ValueError(f"need C >= 1 and Q >= 2, got C={C}, Q={Q}")
    return tuple(int(np.round(q * (C - 1) / (Q - 1))) for q in range(Q))


def lane_histogram_ref(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(C,) values x (B+1,) edges -> (B,) f32 counts."""
    e = edges.to(torch.float32)
    xf = x.to(torch.float32)[None, :]                     # (1, C)
    lo, hi = e[:-1, None], e[1:, None]                    # (B, 1)
    return ((xf >= lo) & (xf < hi)).sum(dim=1).to(torch.float32)


def sort_like_jnp(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sort`` of a 1-D f32 tensor, bit for bit."""
    key = torch.where(x == 0.0, 0.0, x)
    key = torch.where(torch.isnan(x), float("nan"), key)
    return x[torch.sort(key, stable=True).indices]


def lane_quantiles_ref(x: torch.Tensor, Q: int = 11) -> torch.Tensor:
    """(C,) values -> (Q,) f32 order statistics (min, deciles, max at
    Q = 11)."""
    xs = sort_like_jnp(x.to(torch.float32))
    # one slice per quantile: no index tensor to copy to the device
    return torch.stack([xs[i] for i in quantile_indices(x.shape[0], Q)])
