"""Plain PyTorch versions of the delta-compression kernels.

Port of ``repro/kernels/compress/ref.py``. All three functions are
chunk-local on the packed (C, N) flat buffer: a chunk is LANES = 128
consecutive elements, so the buffer is viewed as (C, M, LANES) with
M = N // LANES.

  quantize_int8_ref    (C, N) f32 -> ((C, N) int8, (C, M) f32 scales)
  dequantize_int8_ref  ((C, N) int8, (C, M) f32) -> (C, N) f32
  topk_mask_ref        (C, N) f32 -> (C, N) f32 with exactly k slots kept
                       per chunk (magnitude threshold + first-index
                       tie-break)

The wrappers in ``compress.py`` use these for CPU tensors; the tests and
``chip_smoke.py`` hold the CUDA kernels against them, bitwise.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.flat import LANES


def _chunked(x: torch.Tensor) -> torch.Tensor:
    C, n = x.shape
    if n % LANES:
        raise ValueError(f"flat length {n} is not lane-aligned")
    return x.reshape(C, n // LANES, LANES)


def quantize_int8_ref(x: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk symmetric int8: scale = absmax/127, q = round(x·127/absmax).

    Zero chunks get scale 0 and dequantize to 0. ``torch.round`` rounds
    half to even, like ``jnp.round``. Both divisions are true divisions
    by a tensor: PyTorch turns ``127.0 / t`` into ``t.reciprocal() * 127``
    (and a CUDA ``t / 127.0`` into a multiply by 1/127), which round
    differently from the reference and the kernel. A NaN product
    (a NaN or infinite element in the chunk) quantizes to 0, as XLA's
    float-to-int conversion does."""
    x3 = _chunked(x.to(torch.float32))
    absmax = x3.abs().amax(dim=-1)                          # (C, M)
    c127 = absmax.new_full((), 127.0)
    scale = absmax / c127
    inv = torch.where(absmax > 0.0, c127 / absmax, 0.0)
    r = torch.round(x3 * inv[..., None])
    q = torch.clamp(torch.nan_to_num(r, nan=0.0), -127.0, 127.0)
    return q.to(torch.int8).reshape(x.shape), scale


def dequantize_int8_ref(q: torch.Tensor, scales: torch.Tensor
                        ) -> torch.Tensor:
    q3 = _chunked(q)
    return (q3.to(torch.float32) * scales[..., None]).reshape(q.shape)


def topk_mask_ref(x: torch.Tensor, k: int) -> torch.Tensor:
    """Keep exactly ``k`` slots per LANES-chunk by magnitude, zero the
    rest. The k-th largest |x| of the chunk is the threshold; ties at the
    threshold are kept by first index, so a constant chunk keeps exactly
    its first k slots. Dropped slots are +0.0."""
    if not 1 <= k <= LANES:
        raise ValueError(f"topk k must be in [1, {LANES}], got {k}")
    x3 = _chunked(x.to(torch.float32))
    a = x3.abs()
    thr = torch.sort(a, dim=-1).values[..., LANES - k]      # (C, M)
    greater = a > thr[..., None]
    n_greater = greater.sum(dim=-1, keepdim=True)
    eq = a == thr[..., None]
    eq_rank = torch.cumsum(eq.to(torch.int32), dim=-1)
    keep = greater | (eq & (eq_rank <= (k - n_greater)))
    return torch.where(keep, x3, 0.0).reshape(x.shape)
