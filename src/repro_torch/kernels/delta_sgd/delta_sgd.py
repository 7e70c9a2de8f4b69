"""Δ-SGD's kernels: wrappers around the CUDA kernels.

Port of ``repro/kernels/delta_sgd/delta_sgd.py``. The per-local-step
pair, on packed (C, N) slabs:

  batched_norms  — per-client ``(Σ(g−g_prev)², Σg²)``: the dual norms of
                   Eq. (4), one pass over (G, G_prev). Replaces the TPU
                   kernel ``_batched_norms_kernel``.
  batched_apply  — ``P ← P − η_c·G`` IN PLACE on P, with an optional (N,)
                   bf16 round mask. Replaces ``_batched_apply_kernel`` and
                   ``_batched_apply_masked_kernel``.

and the single-tensor pair, whose one caller is the kernel parity matrix
(``repro_torch.conformance.kernels``):

  norms          — ``(Σ(g−g_prev)², Σg²)`` over one tensor of any shape,
                   f32 or bf16. Replaces ``_norms_kernel``.
  apply_update   — ``p − η·g`` with a scalar η, in p's dtype, into a new
                   tensor. Replaces ``_apply_kernel``.

All four are bound by memory on the card; what their CUDA design does
about it is written at the top of ``csrc/delta_sgd.cu``. Both norms run
one kernel, whose last block of a row sums the blocks' pairs from a
workspace kept per (device, stream) (``_norms_workspace``). The grids
are chosen here: ``norms_grid`` (a block per NORMS_CHUNK elements of a
row, from N alone, so the sums' order and bits depend on (C, N) only),
``single_norms_grid`` (a function of (n, dtype) alone: a chunk that
shrinks with n, so that small tensors still spread over the card) and
``apply_grid`` (a thread per 16-byte column and group of clients, sized
to the SMs). A wrapper given CUDA tensors launches its kernel (built
from that source at first use, see ``repro_torch.kernels.build``) or
raises; given CPU tensors it runs the plain version in ``ref.py``.
There is no other switch.

``LAUNCHES`` counts calls per ``(function, device type)``: a wrapper
adds one to its ``"cuda"`` entry after its kernel launched without
error, and to its ``"cpu"`` entry when it ran the plain version, so the
``"cuda"`` entries count exactly the kernel launches. The single-tensor
pair counts under its own keys (``"norms"``, ``"apply_update"``), so the
two launches per local step of the batched pair stay what they count.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from pathlib import Path
from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.delta_sgd import ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "delta_sgd.cu",)

# batched_norms: the client index is its grid's y dimension
_MAX_CLIENTS = 65535
# batched_norms: elements of one client row that one block sums
# (kNormsChunk; the library refuses a grid cut otherwise)
NORMS_CHUNK = 8192
# batched_apply: most clients a thread updates (kApplyGroup); the row
# length from which threads take groups of clients (a client row of p
# in, g in, p out and the mask, 16·N bytes, then passes the 50 MB L2,
# so the mask would come from HBM once per client); widest block; most
# blocks per SM before the grid strides
APPLY_GROUP = 8
APPLY_GROUP_N = 2 ** 22
APPLY_THREADS = 256
APPLY_WAVES = 32
# norms: threads a block (kThreads); the 16-byte loads a thread of each
# input a chunk may take (the library's instances); the least chunks a
# grid takes the most loads a thread for
NORMS_THREADS = 256
NORMS_VECS = (1, 2, 4, 8)
NORMS_MIN_CHUNKS = 64
# dtype codes of the single-tensor entry points (csrc/delta_sgd.cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Counter = Counter()
# the norms' (partial pairs, per-row tickets) for each (device index,
# stream), shared by batched_norms and norms. The kernel leaves every
# ticket at zero, so only a new or larger workspace is filled.
_NORMS_WORKSPACE: dict = {}


def reset_launch_count() -> None:
    LAUNCHES.clear()


def launch_count(device_type: Optional[str] = None) -> int:
    """Total calls, or only those on ``device_type`` ("cuda"/"cpu")."""
    return common.count(LAUNCHES, device_type)


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library (compiled from SOURCES at first use)."""
    lib = build.load_library("delta_sgd", SOURCES)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    i32 = ctypes.c_int
    lib.dsgd_batched_norms.argtypes = [vp, vp, i64, i64, i64, vp, vp, vp,
                                       vp, vp]
    lib.dsgd_batched_norms.restype = ctypes.c_int
    lib.dsgd_batched_apply.argtypes = [vp, vp, vp, vp, i64, i64, i32, i32,
                                       i64, i32, vp]
    lib.dsgd_batched_apply.restype = ctypes.c_int
    lib.dsgd_norms_chunk.argtypes = [i32, i32]
    lib.dsgd_norms_chunk.restype = i64
    lib.dsgd_norms.argtypes = [vp, vp, i32, i64, i32, i32, i64, vp, vp, vp,
                               vp]
    lib.dsgd_norms.restype = ctypes.c_int
    lib.dsgd_apply_update.argtypes = [vp, vp, vp, ctypes.c_float, vp,
                                      ctypes.c_int, i64, ctypes.c_int,
                                      ctypes.c_int, vp]
    lib.dsgd_apply_update.restype = ctypes.c_int
    chunks = {(dt, v): lib.dsgd_norms_chunk(code, v)
              for dt, code in _DTYPES.items() for v in NORMS_VECS}
    if chunks != {(dt, v): _norms_chunk(v, dt) for dt, v in chunks}:
        raise RuntimeError("csrc/delta_sgd.cu and delta_sgd.py disagree on "
                           "norms' grid")
    return lib


class ApplyGrid(NamedTuple):
    group: int        # clients a thread updates
    threads: int      # threads a block
    blocks: int
    stream: bool      # evict-first loads and stores (large slabs)


def norms_grid(C: int, N: int) -> int:
    """``batched_norms``' blocks a row: one per NORMS_CHUNK elements, the
    last one ragged. Block b sums elements [b·NORMS_CHUNK, (b + 1)·
    NORMS_CHUNK) of its row in a fixed tree, and the last block of the
    row adds the blocks' pairs in block order (a fixed tree over them).
    A function of N alone (C only sets the grid's rows), never of the
    SM count, so the summation order, and the bits, depend on (C, N)
    only."""
    del C   # every row is cut alike
    return -(-N // NORMS_CHUNK)


class NormsGrid(NamedTuple):
    vecs: int         # 16-byte loads a thread of each input a chunk
    chunks: int       # chunks of NORMS_THREADS·vecs pieces, a block each


def _norms_chunk(vecs: int, dtype: torch.dtype) -> int:
    """Elements of one norms chunk: ``vecs`` 16-byte pieces a thread."""
    return NORMS_THREADS * vecs * (16 // dtype.itemsize)


def single_norms_grid(n: int, dtype: torch.dtype) -> NormsGrid:
    """``norms``' grid: a block a chunk, with the most 16-byte loads a
    thread that still leaves NORMS_MIN_CHUNKS blocks, down to one (71
    blocks of 1,024 f32 elements at the paper's width, where the parent
    ran 9 of 8,192). A function of (n, dtype) alone, never of the SM
    count, so the order of the sums, and the bits, are the same on any
    card."""
    for vecs in sorted(NORMS_VECS, reverse=True):
        chunks = -(-n // _norms_chunk(vecs, dtype))
        if chunks >= NORMS_MIN_CHUNKS:
            break
    return NormsGrid(vecs, chunks)


def _norms_workspace(device: torch.device, stream: int, C: int,
                     chunks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The norms' (partial, tickets) on this stream, at least
    (C·chunks, 2) f32 and (C,) int32; tickets zero. Calls on one stream
    run in order, so they share it safely; another stream has its own."""
    key = (device.index, stream)
    partial, tickets = _NORMS_WORKSPACE.get(key, (None, None))
    if partial is None or partial.shape[0] < C * chunks \
            or tickets.shape[0] < C:
        rows = max(C * chunks, 0 if partial is None else partial.shape[0])
        clients = max(C, 0 if tickets is None else tickets.shape[0])
        partial = torch.empty((rows, 2), dtype=torch.float32, device=device)
        tickets = torch.zeros((clients,), dtype=torch.int32, device=device)
        _NORMS_WORKSPACE[key] = (partial, tickets)
    return partial, tickets


def apply_grid(C: int, N: int, sms: int) -> ApplyGrid:
    """``batched_apply``'s grid. A thread owns one 16-byte column of a
    group of clients and reads the mask column once for all of them.
    Rows shorter than APPLY_GROUP_N take one client a thread: the mask
    stays in L2 between clients (287 KB at the paper's width). Longer
    rows take the fewest groups of at most APPLY_GROUP clients, of equal
    size (the last one may be short), so the mask is read from HBM once
    a group.

    A unit is one column of one group. Up to four units per thread of a
    full wave (sms blocks of APPLY_THREADS), one unit a thread: the
    block halves, down to a warp, until every SM has a block. Larger
    slabs: blocks of APPLY_THREADS, at most APPLY_WAVES per SM,
    grid-stride past that, with evict-first loads and stores."""
    group = 1
    if N >= APPLY_GROUP_N:
        group = -(-C // -(-C // APPLY_GROUP))
    units = -(-C // group) * (N // 4)
    if units >= sms * APPLY_THREADS * 4:
        blocks = min(-(-units // APPLY_THREADS), sms * APPLY_WAVES)
        return ApplyGrid(group, APPLY_THREADS, blocks, True)
    threads = APPLY_THREADS
    while threads > 32 and -(-units // threads) < sms:
        threads //= 2
    return ApplyGrid(group, threads, -(-units // threads), False)


def _check_vec(name: str, x: torch.Tensor, n: int, like: torch.Tensor, *,
               aligned: bool = False) -> None:
    common.check_tensor(name, x, (n,), torch.float32, like, aligned=aligned)


def batched_norms(g: torch.Tensor, g_prev: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-client ``(Σ(g−g_prev)², Σg²)`` over packed (C, N) f32 slabs.

    One launch for all clients and all packed leaves (``norms_grid``);
    returns two (C,) f32 vectors and issues no other device work (the
    workspace is filled once, when it is made for a stream). On CUDA the
    sums' order is a function of (C, N) only, so they are bitwise
    reproducible on any card and stream; a non-finite element reaches
    only its own client's sums."""
    common.check_slab("g", g, g)
    common.check_slab("g_prev", g_prev, g)
    if g.shape[0] > _MAX_CLIENTS:
        raise ValueError(f"batched_norms: {g.shape[0]} clients exceed "
                         f"{_MAX_CLIENTS}, its grid's y limit (a grid row "
                         "per client)")
    if common.device_type(g) == "cpu":
        LAUNCHES[("batched_norms", "cpu")] += 1
        return ref.batched_norms_ref(g, g_prev)
    C, n = g.shape
    chunks = norms_grid(C, n)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    partial, tickets = _norms_workspace(g.device, stream, C, chunks)
    dg = torch.empty((C,), dtype=torch.float32, device=g.device)
    gg = torch.empty((C,), dtype=torch.float32, device=g.device)
    common.raise_on(library().dsgd_batched_norms(
        g.data_ptr(), g_prev.data_ptr(), C, n, chunks, partial.data_ptr(),
        tickets.data_ptr(), dg.data_ptr(), gg.data_ptr(), stream),
        "batched_norms")
    LAUNCHES[("batched_norms", "cuda")] += 1
    return dg, gg


def batched_apply(p: torch.Tensor, g: torch.Tensor, eta: torch.Tensor, *,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``P ← P − η_c·G`` on packed (C, N) slabs with per-client η (C,).

    Updates ``p`` IN PLACE and returns it (the TPU kernel aliased P to
    its output). ``mask`` is the optional (N,) round mask from
    ``repro_torch.core.flat.round_mask``: where it is > 0 the result is
    rounded to bf16, as a bf16 leaf is after every step. One launch
    (``apply_grid``); bitwise equal to the plain version."""
    common.check_slab("p", p, p)
    common.check_slab("g", g, p)
    C, n = p.shape
    _check_vec("eta", eta, C, p)
    if mask is not None:
        _check_vec("mask", mask, n, p, aligned=True)
    if common.device_type(p) == "cpu":
        LAUNCHES[("batched_apply", "cpu")] += 1
        return p.copy_(ref.batched_apply_ref(p, g, eta, mask))
    grid = apply_grid(C, n, common.sm_count(p.device.index))
    common.raise_on(library().dsgd_batched_apply(
        p.data_ptr(), g.data_ptr(), eta.data_ptr(),
        mask.data_ptr() if mask is not None else None, C, n, grid.group,
        grid.threads, grid.blocks, int(grid.stream),
        torch.cuda.current_stream(p.device).cuda_stream), "batched_apply")
    LAUNCHES[("batched_apply", "cuda")] += 1
    return p


def _check_pair(a_name: str, a: torch.Tensor, b_name: str,
                b: torch.Tensor) -> None:
    """``a`` and ``b``: contiguous, non-empty, the same shape, both f32
    or both bf16, on one device."""
    if a.dtype not in _DTYPES:
        raise TypeError(f"{a_name} must be float32 or bfloat16, got "
                        f"{a.dtype}")
    common.check_tensor(a_name, a, a.shape, a.dtype, a)
    common.check_tensor(b_name, b, a.shape, a.dtype, a)
    if a.numel() == 0:
        raise ValueError(f"{a_name} is empty")


def _aligned(*ts: torch.Tensor) -> int:
    return int(all(t.data_ptr() % 16 == 0 for t in ts))


def norms(g: torch.Tensor, g_prev: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(Σ(g−g_prev)², Σg²)`` over one tensor of any shape, f32 or bf16,
    summed in f32 -> two 0-d f32 tensors on g's device. One launch and no
    other device work (``single_norms_grid``; the workspace, shared with
    ``batched_norms``, is filled once, when it is made for a stream),
    read in place (no cast, no pad); on CUDA the sums' order is a
    function of (n, dtype, alignment), so they are bitwise reproducible
    on any card and stream. A NaN or inf reaches both sums."""
    _check_pair("g", g, "g_prev", g_prev)
    if common.device_type(g) == "cpu":
        LAUNCHES[("norms", "cpu")] += 1
        return ref.norms_ref(g, g_prev)
    lib = library()
    n = g.numel()
    grid = single_norms_grid(n, g.dtype)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    partial, tickets = _norms_workspace(g.device, stream, 1, grid.chunks)
    out = torch.empty((2,), dtype=torch.float32, device=g.device)
    common.raise_on(lib.dsgd_norms(
        g.data_ptr(), g_prev.data_ptr(), _DTYPES[g.dtype], n,
        _aligned(g, g_prev), grid.vecs, grid.chunks, partial.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), stream), "norms")
    LAUNCHES[("norms", "cuda")] += 1
    return out[0], out[1]


def apply_update(p: torch.Tensor, g: torch.Tensor,
                 eta: Union[float, torch.Tensor]) -> torch.Tensor:
    """``p − η·g`` in f32, rounded to p's dtype (f32 or bf16) -> a new
    tensor shaped like p. ``eta`` is a Python float or a 0-d f32 tensor
    on p's device, which the kernel reads where it lies (never
    ``.item()``)."""
    _check_pair("p", p, "g", g)
    if isinstance(eta, torch.Tensor):
        common.check_tensor("eta", eta, (), torch.float32, p)
    else:
        eta = float(eta)
    if common.device_type(p) == "cpu":
        LAUNCHES[("apply_update", "cpu")] += 1
        return ref.apply_ref(p, g, eta)
    out = torch.empty_like(p)
    on_device = isinstance(eta, torch.Tensor)
    common.raise_on(library().dsgd_apply_update(
        p.data_ptr(), g.data_ptr(), eta.data_ptr() if on_device else None,
        0.0 if on_device else eta, out.data_ptr(), _DTYPES[p.dtype],
        p.numel(), _aligned(p, g, out), common.sm_count(p.device.index),
        torch.cuda.current_stream(p.device).cuda_stream), "apply_update")
    LAUNCHES[("apply_update", "cuda")] += 1
    return out
