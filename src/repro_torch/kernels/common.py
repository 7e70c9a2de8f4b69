"""Checks and launch accounting shared by the kernel wrappers.

Every wrapper checks its tensors before it hands raw pointers to a CUDA
kernel (dtype, shape, device, contiguity, 16-byte alignment), raises when
the C entry point returns a CUDA error, and counts its calls in its
namespace's ``LAUNCHES`` counter keyed on ``(function, device type)``: the
``"cuda"`` entries count exactly the kernel launches, the ``"cpu"`` entries
the runs of the plain version. ``sm_count`` is the one place a wrapper
reads the card's SM count from.
"""
from __future__ import annotations

import functools
from collections import Counter
from typing import Optional, Sequence

import torch

from repro_torch.core.flat import LANES


def count(launches: Counter, device_type: Optional[str] = None) -> int:
    """Total calls in ``launches``, or only those on ``device_type``."""
    return sum(v for (_, dev), v in launches.items()
               if device_type is None or dev == device_type)


@functools.cache
def sm_count(index: int) -> int:
    """SMs of CUDA device ``index`` (cudaGetDeviceProperties, read once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_type(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def check_tensor(name: str, x: torch.Tensor, shape: Sequence[int],
                 dtype: torch.dtype, like: torch.Tensor, *,
                 aligned: bool = False) -> None:
    """``x`` is a contiguous ``dtype`` tensor of ``shape`` on ``like``'s
    device (16-byte aligned there when ``aligned``)."""
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if x.device != like.device:
        raise ValueError(f"{name} is on {x.device}, expected {like.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and x.is_cuda and x.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def check_slab(name: str, x: torch.Tensor, like: torch.Tensor, *,
               dtype: torch.dtype = torch.float32) -> None:
    """``x`` is a packed (C, N) slab shaped like ``like``: contiguous,
    16-byte aligned on the card, N a positive multiple of LANES."""
    if x.dim() != 2:
        raise ValueError(f"{name} must be (C, N), got {tuple(x.shape)}")
    check_tensor(name, x, like.shape, dtype, like, aligned=True)
    if x.shape[1] % LANES or x.shape[1] == 0:
        raise ValueError(f"{name}: flat length {x.shape[1]} is not a "
                         f"positive multiple of {LANES} (pack it with "
                         f"repro_torch.core.flat)")
