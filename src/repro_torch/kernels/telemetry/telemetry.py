"""Telemetry kernels: wrappers around the CUDA kernels.

Port of ``repro/kernels/telemetry/telemetry.py``. Both reduce a (C,)
per-client vector to a fixed-shape summary, once per round when the
round's telemetry is on:

  lane_histogram  (C,) values + (B+1,) bin edges -> (B,) f32 counts.
                  Replaces ``_hist_kernel``.
  lane_quantiles  (C,) values -> (Q,) order statistics (min, deciles,
                  max at Q = 11). Replaces ``_quantile_kernel``.

Both results are exact: counts are small integers in f32, and the
quantiles are entries of the input. What the CUDA designs do is written
at the top of ``csrc/telemetry.cu``; ``hist_grid`` picks the
histogram's path (one warp up to HIST_WARP_LANES lanes, a grid of
blocks past them, with a workspace kept per stream). A wrapper given
CUDA tensors launches its kernel (built from that source at first use,
see ``repro_torch.kernels.build``) or raises; given CPU tensors it runs
the plain version in ``ref.py``. There is no other switch.

``LAUNCHES`` counts calls per ``(function, device type)`` in its own
book: the Δ-SGD counter of ``repro_torch.kernels.delta_sgd`` (two
launches per local step) never moves for telemetry.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.telemetry import ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "telemetry.cu",)

# the kernels' limits (kMaxBins, kMaxQuantiles, kMaxLanes, kQuantTile in
# csrc/telemetry.cu): lane_quantiles sorts up to QUANTILE_TILE lanes in
# one block, more in tiles of QUANTILE_TILE that a second launch ranks
# against each other (work growing as C² / QUANTILE_TILE, hence the cap)
MAX_BINS = 4096
MAX_QUANTILES = 256
MAX_LANES = 1 << 17
QUANTILE_TILE = 2048
# lane_histogram: lanes up to which one warp counts (the crossover,
# measured by scripts/hist_quant_probe.py) and the lanes a thread holds
# on it (32 times the last is kWarpMaxLanes in csrc/telemetry.cu); lanes
# a grid block takes a sweep (kHistBlockLanes; a block for each, up to
# one an SM) and a thread of it
HIST_WARP_LANES = 128
HIST_WARP_PER_THREAD = (1, 4)
HIST_BLOCK_LANES = 4096
HIST_PER_THREAD = 8
# the kernels index lanes, and a sweep past the last, with 32-bit ints
MAX_HIST_LANES = 2 ** 30

LAUNCHES: Counter = Counter()
# lane_histogram's grid path: (edge counts of each block, ticket) for
# each (device index, stream). The last block puts the ticket back to
# zero, so only a new workspace is filled.
_HIST_WORKSPACE: dict = {}


def reset_launch_count() -> None:
    LAUNCHES.clear()


def launch_count(device_type: Optional[str] = None) -> int:
    """Total calls, or only those on ``device_type`` ("cuda"/"cpu")."""
    return common.count(LAUNCHES, device_type)


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library (compiled from SOURCES at first use)."""
    lib = build.load_library("telemetry", SOURCES)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.tele_max_bins, lib.tele_max_quantiles,
               lib.tele_max_lanes, lib.tele_quantile_tile):
        fn.argtypes = []
        fn.restype = i32
    for fn in (lib.tele_hist_warp_max_lanes, lib.tele_hist_block_lanes):
        fn.argtypes = []
        fn.restype = i32
    lib.tele_lane_histogram.argtypes = [vp, i32, vp, i32, i32, i32, vp, vp,
                                        vp, vp]
    lib.tele_lane_histogram.restype = i32
    lib.tele_lane_quantiles.argtypes = [vp, i32, ctypes.POINTER(i32), i32,
                                        vp, vp, vp]
    lib.tele_lane_quantiles.restype = i32
    if (lib.tele_max_bins(), lib.tele_max_quantiles(), lib.tele_max_lanes(),
            lib.tele_quantile_tile()) != (MAX_BINS, MAX_QUANTILES,
                                          MAX_LANES, QUANTILE_TILE):
        raise RuntimeError("csrc/telemetry.cu and telemetry.py disagree on "
                           "the kernels' limits")
    if (lib.tele_hist_warp_max_lanes(), lib.tele_hist_block_lanes()) != (
            32 * HIST_WARP_PER_THREAD[-1], HIST_BLOCK_LANES):
        raise RuntimeError("csrc/telemetry.cu and telemetry.py disagree on "
                           "the histogram's grid")
    return lib


class HistGrid(NamedTuple):
    blocks: int       # 0: one warp; else the blocks of the grid
    per_thread: int   # lanes of x a thread holds (a sweep, on the grid)


def hist_grid(C: int, B: int, sms: int) -> HistGrid:
    """``lane_histogram``'s path. Up to HIST_WARP_LANES lanes, one warp
    whose lane l holds lanes 32 k + l of x, k < per_thread (the fewest of
    HIST_WARP_PER_THREAD that cover C). Past that, a grid of
    ⌈C / HIST_BLOCK_LANES⌉ blocks, at most one an SM: block r of k
    takes lanes [s + r·HIST_BLOCK_LANES, s + (r + 1)·HIST_BLOCK_LANES) of
    each sweep s = 0, k·HIST_BLOCK_LANES, ..., thread t lanes s +
    r·HIST_BLOCK_LANES + m·512 + t, m < per_thread. Every lane is
    counted once on either path, and the counts are integers, so the
    path moves no bit."""
    del B   # the bins cut neither path: each counts every bin's edges
    if C <= HIST_WARP_LANES:
        per = next(v for v in HIST_WARP_PER_THREAD if 32 * v >= C)
        return HistGrid(0, per)
    return HistGrid(min(sms, -(-C // HIST_BLOCK_LANES)), HIST_PER_THREAD)


def _hist_workspace(device: torch.device, stream: int, B: int, blocks: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grid path's (edge counts, ticket) on this stream, for a grid
    of more than one block: at least (B + 1)·blocks int32 and one int32,
    the ticket zero. Calls on one stream run in order, so they share it
    safely; another stream has its own."""
    key = (device.index, stream)
    partial, ticket = _HIST_WORKSPACE.get(key, (None, None))
    if partial is None or partial.numel() < (B + 1) * blocks:
        partial = torch.empty(((B + 1) * blocks,), dtype=torch.int32,
                              device=device)
        if ticket is None:
            ticket = torch.zeros((1,), dtype=torch.int32, device=device)
        _HIST_WORKSPACE[key] = (partial, ticket)
    return partial, ticket


def _check_lanes(x: torch.Tensor) -> int:
    if x.dim() != 1:
        raise ValueError(f"x must be a (C,) vector, got {tuple(x.shape)}")
    common.check_tensor("x", x, x.shape, torch.float32, x)
    return x.shape[0]


def lane_histogram(x: torch.Tensor, edges) -> torch.Tensor:
    """(C,) f32 values, (B+1,) bin edges -> (B,) f32 counts of
    ``edges[b] <= x < edges[b+1]``; NaN counts in no bin.

    ``edges`` is best a contiguous f32 tensor on x's device (the round
    builds it once); anything else is converted, a copy per call."""
    C = _check_lanes(x)
    if not (isinstance(edges, torch.Tensor) and edges.dtype == torch.float32
            and edges.device == x.device and edges.is_contiguous()):
        edges = torch.as_tensor(edges, dtype=torch.float32,
                                device=x.device).contiguous()
    if edges.dim() != 1 or not 2 <= edges.shape[0] <= MAX_BINS + 1:
        raise ValueError(f"edges must be (B+1,) with 1 <= B <= {MAX_BINS}, "
                         f"got {tuple(edges.shape)}")
    B = edges.shape[0] - 1
    if C > MAX_HIST_LANES:
        raise ValueError(f"lane_histogram takes at most {MAX_HIST_LANES} "
                         f"lanes, got C = {C}")
    if common.device_type(x) == "cpu":
        LAUNCHES[("lane_histogram", "cpu")] += 1
        return ref.lane_histogram_ref(x, edges)
    out = torch.empty((B,), dtype=torch.float32, device=x.device)
    grid = hist_grid(C, B, common.sm_count(x.device.index))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    partial = ticket = None
    if grid.blocks > 1:
        partial, ticket = _hist_workspace(x.device, stream, B, grid.blocks)
    common.raise_on(library().tele_lane_histogram(
        x.data_ptr(), C, edges.data_ptr(), B, grid.blocks, grid.per_thread,
        None if partial is None else partial.data_ptr(),
        None if ticket is None else ticket.data_ptr(), out.data_ptr(),
        stream), "lane_histogram")
    LAUNCHES[("lane_histogram", "cuda")] += 1
    return out


def lane_quantiles(x: torch.Tensor, Q: int = 11) -> torch.Tensor:
    """(C,) f32 values -> (Q,) f32 order statistics at the sorted
    positions ``quantile_indices(C, Q)``, sorted as ``jnp.sort`` sorts
    (NaN last, ties in lane order). C is at most MAX_LANES; above
    QUANTILE_TILE the call makes two kernel launches (counted as one
    call) and a scratch buffer of 8 bytes a lane."""
    C = _check_lanes(x)
    idx = ref.quantile_indices(C, Q)       # host ints, raises on C < 1
    if Q > MAX_QUANTILES:
        raise ValueError(f"Q = {Q} exceeds the kernel's limit of "
                         f"{MAX_QUANTILES}")
    if C > MAX_LANES:
        raise ValueError(f"lane_quantiles takes at most {MAX_LANES} lanes "
                         f"(2^17), got C = {C}")
    if common.device_type(x) == "cpu":
        LAUNCHES[("lane_quantiles", "cpu")] += 1
        return ref.lane_quantiles_ref(x, Q)
    out = torch.empty((Q,), dtype=torch.float32, device=x.device)
    scratch = None
    if C > QUANTILE_TILE:
        tiles = -(-C // QUANTILE_TILE)
        scratch = torch.empty((tiles * QUANTILE_TILE,), dtype=torch.int64,
                              device=x.device)
    common.raise_on(library().tele_lane_quantiles(
        x.data_ptr(), C, (ctypes.c_int * Q)(*idx), Q,
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream), "lane_quantiles")
    LAUNCHES[("lane_quantiles", "cuda")] += 1
    return out
