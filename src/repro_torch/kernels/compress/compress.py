"""Delta-compression kernels: wrappers around the CUDA kernels.

Port of ``repro/kernels/compress/compress.py``, on the packed (C, N)
flat buffer (``repro_torch.core.flat``), chunk-local over LANES = 128
consecutive elements:

  quantize_int8   — per-chunk symmetric int8 with one f32 scale
                    (absmax/127) per chunk. Replaces ``_quantize_kernel``.
  dequantize_int8 — the server-side inverse, q·s. Replaces
                    ``_dequantize_kernel``.
  topk_mask       — keep exactly k slots per chunk by magnitude (ties by
                    first index), zero the rest. Replaces ``_topk_kernel``.

Per round, int8 costs exactly 2 launches and top-k 1, whatever the leaf
and client counts. All three are bound by memory on the card; what their
CUDA design does about it is written at the top of ``csrc/compress.cu``.
``quantize_grid`` gives quantize a warp for every QUANT_STEP chunks,
``dequantize_grid`` dequantize one for every DEQUANT_STEP.
A wrapper given CUDA tensors launches its kernel (built from that source
at first use, see ``repro_torch.kernels.build``) or raises; given CPU
tensors it runs the plain version in ``ref.py``. There is no other
switch. ``LAUNCHES`` counts calls per ``(function, device type)``, as in
``repro_torch.kernels.delta_sgd``.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.core.flat import LANES
from repro_torch.kernels import build, common
from repro_torch.kernels.compress import ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "compress.cu",)

# quantize_int8 and dequantize_int8: chunks a warp takes (kQuantStep,
# kDequantStep), threads a block (kThreads)
QUANT_STEP = 4
DEQUANT_STEP = 1
QUANT_THREADS = 256

LAUNCHES: Counter = Counter()


def reset_launch_count() -> None:
    LAUNCHES.clear()


def launch_count(device_type: Optional[str] = None) -> int:
    """Total calls, or only those on ``device_type`` ("cuda"/"cpu")."""
    return common.count(LAUNCHES, device_type)


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library (compiled from SOURCES at first use)."""
    lib = build.load_library("compress", SOURCES)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.cmp_quantize_int8.argtypes = [vp, vp, vp, i64, i64, vp]
    lib.cmp_dequantize_int8.argtypes = [vp, vp, vp, i64, i64, vp]
    lib.cmp_topk_mask.argtypes = [vp, vp, i64, ctypes.c_int, vp]
    for fn in (lib.cmp_quantize_int8, lib.cmp_dequantize_int8,
               lib.cmp_topk_mask):
        fn.restype = ctypes.c_int
    for fn in (lib.cmp_quantize_chunks_a_step,
               lib.cmp_dequantize_chunks_a_step, lib.cmp_quantize_threads):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    if (lib.cmp_quantize_chunks_a_step(), lib.cmp_dequantize_chunks_a_step(),
            lib.cmp_quantize_threads()) != (QUANT_STEP, DEQUANT_STEP,
                                            QUANT_THREADS):
        raise RuntimeError("csrc/compress.cu and compress.py disagree on "
                           "the (de)quantize grids")
    return lib


def quantize_grid(chunks: int) -> int:
    """``quantize_int8``'s blocks of QUANT_THREADS threads: warp w of the
    grid takes chunks QUANT_STEP·w .. QUANT_STEP·w + QUANT_STEP − 1 (the
    last warp's ragged), every warp one step. A grid of resident warps
    that stride over the steps was slower (scripts/hist_quant_probe.py),
    so the grid reads no SM count."""
    return max(1, -(-chunks // (QUANT_STEP * (QUANT_THREADS // 32))))


def dequantize_grid(chunks: int) -> int:
    """``dequantize_int8``'s blocks of QUANT_THREADS threads: warp w
    takes chunks DEQUANT_STEP·w .. DEQUANT_STEP·(w + 1) − 1 (one chunk a
    warp, the parent's layout; more chunks a warp measured slower,
    scripts/hist_quant_probe.py). Reads no SM count."""
    return max(1, -(-chunks // (DEQUANT_STEP * (QUANT_THREADS // 32))))


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed (C, N) f32 -> ((C, N) int8, (C, N/128) f32 per-chunk
    scales). One launch for all clients and chunks; bitwise equal to
    ``ref.quantize_int8_ref``."""
    common.check_slab("x", x, x)
    if common.device_type(x) == "cpu":
        LAUNCHES[("quantize_int8", "cpu")] += 1
        return ref.quantize_int8_ref(x)
    C, n = x.shape
    q = torch.empty((C, n), dtype=torch.int8, device=x.device)
    s = torch.empty((C, n // LANES), dtype=torch.float32, device=x.device)
    chunks = C * (n // LANES)
    common.raise_on(library().cmp_quantize_int8(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), chunks,
        quantize_grid(chunks), _stream(x)), "quantize_int8")
    LAUNCHES[("quantize_int8", "cuda")] += 1
    return q, s


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """((C, N) int8, (C, N/128) f32) -> (C, N) f32. One launch
    (``dequantize_grid``); bitwise equal to ``ref.dequantize_int8_ref``,
    NaN and inf scales included."""
    common.check_slab("q", q, q, dtype=torch.int8)
    C, n = q.shape
    common.check_tensor("scales", scales, (C, n // LANES), torch.float32, q)
    if common.device_type(q) == "cpu":
        LAUNCHES[("dequantize_int8", "cpu")] += 1
        return ref.dequantize_int8_ref(q, scales)
    out = torch.empty((C, n), dtype=torch.float32, device=q.device)
    chunks = C * (n // LANES)
    common.raise_on(library().cmp_dequantize_int8(
        q.data_ptr(), scales.data_ptr(), out.data_ptr(), chunks,
        dequantize_grid(chunks), _stream(q)), "dequantize_int8")
    LAUNCHES[("dequantize_int8", "cuda")] += 1
    return out


def topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """Keep exactly ``k`` slots per 128-chunk of (C, N) by magnitude,
    ties by first index; the rest are +0.0. One launch; exact."""
    if not 1 <= k <= LANES:
        raise ValueError(f"topk k must be in [1, {LANES}], got {k}")
    common.check_slab("x", x, x)
    if common.device_type(x) == "cpu":
        LAUNCHES[("topk_mask", "cpu")] += 1
        return ref.topk_mask_ref(x, k)
    C, n = x.shape
    out = torch.empty_like(x)
    common.raise_on(library().cmp_topk_mask(
        x.data_ptr(), out.data_ptr(), C * (n // LANES), k, _stream(x)),
        "topk_mask")
    LAUNCHES[("topk_mask", "cuda")] += 1
    return out
