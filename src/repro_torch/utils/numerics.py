"""Means and divisions by a constant, taken as XLA takes the reference's.

XLA rewrites a division by a compile-time constant into a product with
the constant's f32 reciprocal: the reference's ``jnp.mean`` over n
values is their sum times f32(1/n), and its ``x / n`` with a Python n is
x times f32(1/n). That is one ulp off a true division at some values:
at n = 10 a sum of 18 gives 1.80000007 where 18/10 rounds to
1.79999995. The port takes these values the same way, so a count the
reference reports as a mean or a fraction has the reference's bits.

JAX also gives a Python float the dtype of the array it meets (a weak
type): ``0.9 * m`` on a bf16 ``m`` multiplies by bf16(0.9), where torch
would multiply by the f32 value. ``weak`` makes the port's scalar the
same.

``sqrt`` is a correctly rounded square root. XLA's f32 sqrt is correctly
rounded; torch's CPU kernel is not on every host (its vectorised path on
an AVX-512 CPU is one ulp off on about a fifth of f32 inputs, and so is
its f64 path now and then). Taken in f64 and rounded once to f32 the root
is correctly rounded (53 ≥ 2·24 + 2), on the CPU and on the card alike.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def reciprocal(n) -> float:
    """f32(1/n), as XLA folds the divisor of ``x / n``. The float it
    returns is exactly that f32, so ``tensor * reciprocal(n)`` is one f32
    multiply."""
    return float(np.float32(1.0) / np.float32(n))


def xla_mean(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """``jnp.mean(x, axis=dim)`` as XLA computes it: the sum times the
    f32 reciprocal of the count."""
    if dim is None:
        return x.sum() * reciprocal(x.numel())
    return x.sum(dim=dim) * reciprocal(x.shape[dim])


def round_frac(round_idx: int, num_rounds: int) -> np.float32:
    """t / T of the (↓) schedules as the reference's jitted round takes
    it: f32(t) times f32(1/T). At (T, t) = (82, 41) that is 0.49999997,
    below the 50 % threshold, where 41/82 is 0.5."""
    return np.float32(round_idx) * np.float32(reciprocal(num_rounds))


def weak(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as JAX types it against ``like``: a 0-d tensor in
    like's dtype. It stays on the host whatever like's device: torch
    takes a 0-d CPU tensor as a scalar operand of a CUDA op, so it costs
    no copy to the device and no host sync."""
    return torch.tensor(x, dtype=like.dtype)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of an f32 tensor, as XLA takes
    ``jnp.sqrt``: the root in f64, rounded once to x's dtype. For the
    scalars and (C,) vectors of the Δ-SGD rule and the clip norms, where
    the f64 costs nothing measurable."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)
