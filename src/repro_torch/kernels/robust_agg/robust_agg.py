"""Robust server aggregation kernel: wrapper around the CUDA kernel.

Port of ``repro/kernels/robust_agg/robust_agg.py``:

  batched_trimmed_mean — coordinate-wise trimmed mean over the packed
                         (C, N) client-delta slab: sort the C values of
                         each coordinate, drop ``t`` at each end, average
                         the rest; ``t = (C−1)//2`` gives the median.
                         Replaces the kernel of ``_make_trimmed_kernel``.

It is bound by memory on the card; what its CUDA design does about it is
written at the top of ``csrc/robust_agg.cu``: up to 64 clients the
values sort in registers, and the grid is sized from N and the SM count
(``common.sm_count``). Given CUDA tensors the wrapper launches the
kernel (built from that source at first use) or raises; given CPU
tensors it runs the plain version in ``ref.py``. There is no other
switch. ``LAUNCHES`` counts calls per ``(function, device
type)``, one book per kernel namespace, so the Δ-SGD launch invariant
counts only its own module's launches.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.robust_agg import ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "robust_agg.cu",)

# the kernel's largest client count (kMaxClients in csrc/robust_agg.cu):
# every cohort the scenario presets imply is far below it
MAX_CLIENTS = 256

LAUNCHES: Counter = Counter()


def reset_launch_count() -> None:
    LAUNCHES.clear()


def launch_count(device_type: Optional[str] = None) -> int:
    """Total calls, or only those on ``device_type`` ("cuda"/"cpu")."""
    return common.count(LAUNCHES, device_type)


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library (compiled from SOURCES at first use)."""
    lib = build.load_library("robust_agg", SOURCES)
    i64 = ctypes.c_int64
    lib.ra_max_clients.argtypes = []
    lib.ra_max_clients.restype = ctypes.c_int
    lib.ra_trimmed_mean.argtypes = [ctypes.c_void_p, ctypes.c_void_p, i64,
                                    i64, i64, ctypes.c_int, ctypes.c_void_p]
    lib.ra_trimmed_mean.restype = ctypes.c_int
    if lib.ra_max_clients() != MAX_CLIENTS:
        raise RuntimeError("csrc/robust_agg.cu and robust_agg.py disagree "
                           "on the largest client count")
    return lib


def batched_trimmed_mean(x: torch.Tensor, t: int) -> torch.Tensor:
    """Coordinate-wise trimmed mean of a packed (C, N) f32 slab -> (N,).

    One launch for all coordinates. Invalid clients must already be
    zeroed by the caller (the zero delta is the 'no contribution'
    element, see ``repro_torch.federation.faults``). On CUDA the result
    is the same on every call."""
    common.check_slab("x", x, x)
    C, n = x.shape
    if not 0 <= 2 * t < C:
        raise ValueError(f"trim count {t} leaves no window for C={C}")
    if C > MAX_CLIENTS:
        raise ValueError(f"{C} clients exceed the trimmed-mean kernel's "
                         f"limit of {MAX_CLIENTS}")
    if common.device_type(x) == "cpu":
        LAUNCHES[("batched_trimmed_mean", "cpu")] += 1
        return ref.batched_trimmed_mean_ref(x, t)
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    common.raise_on(library().ra_trimmed_mean(
        x.data_ptr(), out.data_ptr(), C, n, t,
        common.sm_count(x.device.index),
        torch.cuda.current_stream(x.device).cuda_stream),
        "batched_trimmed_mean")
    LAUNCHES[("batched_trimmed_mean", "cuda")] += 1
    return out
