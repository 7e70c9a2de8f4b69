"""Plain PyTorch version of the robust-aggregation kernel.

Port of ``repro/kernels/robust_agg/ref.py``. The wrapper in
``robust_agg.py`` uses it for CPU tensors; the tests and
``chip_smoke.py`` hold the CUDA kernel against it.
"""
from __future__ import annotations

import torch


def batched_trimmed_mean_ref(x: torch.Tensor, t: int) -> torch.Tensor:
    """Coordinate-wise trimmed mean of (C, N) -> (N,): sort the client
    axis, cut ``t`` per end, average the window [t, C−t).

    The window is summed one row after the other in ascending order from
    zero, and divided by a tensor (a true division; PyTorch turns a CUDA
    tensor divided by a Python float into a multiply by its reciprocal).
    That is the CUDA kernel's arithmetic, so the two agree bitwise on the
    card; a plain ``mean`` sums in another order, which at deltas of
    mixed scale moves the result by far more than its rounding."""
    C = x.shape[0]
    if not 0 <= 2 * t < C:
        raise ValueError(f"trim count {t} leaves no window for C={C}")
    s = torch.sort(x.to(torch.float32), dim=0).values
    acc = torch.zeros_like(s[0])
    for row in s[t:C - t]:
        acc = acc + row
    return acc / acc.new_full((), C - 2 * t)
