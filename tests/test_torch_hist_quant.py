"""The grids and the arithmetic of ``lane_histogram`` and ``quantize_int8``'s
CUDA designs, checked on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); what they are handed is computed here, and what they
compute is emulated in numpy from the index formulas and the order of
operations in ``csrc/telemetry.cu`` and ``csrc/compress.cu``:

* ``hist_grid`` and ``quantize_grid`` hand every lane and every chunk to
  exactly one thread, at SM counts of 132 (H100 SXM) and 114 (H100 PCIe);
* the histogram's counts (lanes at or above each edge, summed over the
  grid's blocks, a bin the difference of its two edges' counts where
  its lower edge is at most its upper) equal the plain version and the
  reference's kernel in interpret mode, for ascending and non-ascending
  edges;
* quantize's layout (8 lanes a chunk, a width-8 butterfly over a max
  that keeps NaN, per-element f32 products, rounding half to even, the
  clamp) equals ``quantize_int8_ref`` bit for bit and the reference's
  kernel in interpret mode (its scales within one ulp, as
  ``tests/test_torch_compress.py`` holds them)."""
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.compress import compress as rk
from repro.kernels.telemetry import telemetry as r_tk
from repro_torch.kernels import common
from repro_torch.kernels.compress import compress as tc
from repro_torch.kernels.compress import ref as tcref
from repro_torch.kernels.telemetry import ref as ttref
from repro_torch.kernels.telemetry import telemetry as tt
from test_torch_delta_sgd_grid import FakeLibrary

SMS = [132, 114]
X = tt.HIST_WARP_LANES          # the crossover
HIST_LANES = [1, 31, 32, 33, X - 1, X, X + 1, 16384, 16385, 100000]
# a chunk, 7 (a ragged warp), 4k + 3 (a ragged last warp after whole
# ones), the paper's (10, 71,808), a part-filled last block, 2^24 a row
CHUNKS = [1, 7, 4 * 1000 + 3, 10 * 561, 32 * 41 + 5, 10 * 2 ** 17]
CU = (tt.SOURCES[0]).read_text()
REG_EDGES = int(re.search(r"kRegEdges = (\d+);", CU).group(1))
TILE = 32 * REG_EDGES
THREADS = tt.HIST_BLOCK_LANES // tt.HIST_PER_THREAD


def hist_lanes(grid, C):
    """(block, lanes) the kernel's threads load, in [0, C), for each
    block of ``grid`` (one warp: block 0)."""
    if grid.blocks == 0:
        lanes = np.arange(32 * grid.per_thread)
        return [(0, lanes[lanes < C])]
    out = []
    for r in range(grid.blocks):
        lanes = []
        for s0 in range(r * tt.HIST_BLOCK_LANES, C,
                        grid.blocks * tt.HIST_BLOCK_LANES):
            i = s0 + (np.arange(grid.per_thread)[:, None] * THREADS
                      + np.arange(THREADS)[None, :]).ravel()
            lanes.append(i[i < C])
        out.append((r, np.concatenate(lanes) if lanes
                    else np.zeros(0, np.int64)))
    return out


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("C", HIST_LANES)
def test_hist_grid_counts_every_lane_once(C, sms):
    grid = tt.hist_grid(C, 16, sms)
    if C <= tt.HIST_WARP_LANES:
        assert grid.blocks == 0
        assert grid.per_thread in tt.HIST_WARP_PER_THREAD
        assert 32 * grid.per_thread >= C
        assert grid.per_thread == min(v for v in tt.HIST_WARP_PER_THREAD
                                      if 32 * v >= C)
    else:
        assert 1 <= grid.blocks <= sms
        assert grid.blocks == min(sms, -(-C // tt.HIST_BLOCK_LANES))
        assert grid.per_thread == tt.HIST_PER_THREAD
    seen = np.zeros(C, np.int64)
    for r, lanes in hist_lanes(grid, C):
        assert lanes.size > 0, f"block {r} has no lane"
        np.add.at(seen, lanes, 1)
    assert (seen == 1).all()
    assert tt.HIST_WARP_LANES <= 32 * tt.HIST_WARP_PER_THREAD[-1]


def test_hist_grid_takes_no_bins_and_few_sms():
    """The bins cut neither path; the grid has at most a block an SM."""
    for C in HIST_LANES:
        assert tt.hist_grid(C, 1, 132) == tt.hist_grid(C, 4096, 132)
    assert tt.hist_grid(100000, 16, 4).blocks == 4


@pytest.mark.parametrize("B", [1, 16, 126, 127, 128, 129, 254, 4096])
def test_warp_path_tiles_write_every_bin_once(B):
    """Tiles of TILE edges, TILE − 1 bins apart: bin first + t (t < TILE
    − 1) is written by the tile at ``first``, its two edges t and t + 1
    both among the tile's counted edges."""
    written = np.zeros(B, np.int64)
    for first in range(0, B, TILE - 1):
        ne = min(TILE, B + 1 - first)
        for t in range(TILE - 1):
            if first + t < B:
                assert t + 1 < ne
                written[first + t] += 1
    assert (written == 1).all()


def _nan_max(a, b):
    return np.where((a > b) | np.isnan(a), a, b)


def emulate_histogram(x, edges, grid):
    """The kernels' arithmetic: each block counts its lanes at or above
    every edge (NaN lanes and NaN edges count none), the last block sums
    the blocks' counts, and bin b is G[b] − G[b + 1] where edges[b] <=
    edges[b + 1], else 0."""
    C, B = x.shape[0], edges.shape[0] - 1
    G = np.zeros(B + 1, np.int64)
    for _, lanes in hist_lanes(grid, C):
        G += (x[lanes][None, :] >= edges[:, None]).sum(axis=1)
    lo, hi = edges[:-1], edges[1:]
    return np.where(lo <= hi, G[:-1] - G[1:], 0).astype(np.float32)


def _hist_lanes(C, seed):
    r = np.random.default_rng(seed)
    x = (10.0 ** r.uniform(-6.0, 3.5, C)).astype(np.float32)
    special = np.asarray([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0,
                          1.0, 1e-38, 2e-45], np.float32)
    n = min(C, special.size)
    x[r.permutation(C)[:n]] = special[:n]
    return x


def _edges(B, kind, seed):
    e = np.concatenate([[0.0], np.logspace(-6, 3, B)]).astype(np.float32)
    if kind == "mixed":
        r = np.random.default_rng(seed)
        e = r.permutation(e)
        e[r.integers(0, B + 1)] = np.nan
        e[min(B, 1)] = e[0]          # an empty bin of equal edges
    return e


@pytest.mark.parametrize("kind", ["ascending", "mixed"])
@pytest.mark.parametrize("B", [1, 16, 33])
@pytest.mark.parametrize("C", [10, X + 1, 16385, 100000])
def test_histogram_emulation_equals_plain_and_reference(C, B, kind):
    x = _hist_lanes(C, C + B)
    e = _edges(B, kind, B)
    grid = tt.hist_grid(C, B, 132)
    got = emulate_histogram(x, e, grid)
    plain = tt.lane_histogram(torch.from_numpy(x), torch.from_numpy(e))
    np.testing.assert_array_equal(got, ttref.lane_histogram_ref(
        torch.from_numpy(x), torch.from_numpy(e)).numpy())
    np.testing.assert_array_equal(got, plain.numpy())
    ref = r_tk.lane_histogram(jnp.asarray(x), jnp.asarray(e),
                              interpret=True)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_quantize_grid_reads_no_sm_count(monkeypatch):
    assert list(inspect.signature(tc.quantize_grid).parameters) == [
        "chunks"]

    def no_sm_count(index):
        raise AssertionError("quantize_grid read the SM count")
    monkeypatch.setattr(common, "sm_count", no_sm_count)
    tc.quantize_grid(10 * 561)


@pytest.mark.parametrize("chunks", CHUNKS)
def test_quantize_grid_takes_every_chunk_once(chunks):
    """Warp w takes chunks QUANT_STEP·w .. QUANT_STEP·w + 3; every block
    has a warp with a chunk."""
    blocks = tc.quantize_grid(chunks)
    warps = blocks * (tc.QUANT_THREADS // 32)
    c = (np.arange(warps)[:, None] * tc.QUANT_STEP
         + np.arange(tc.QUANT_STEP)[None, :]).ravel()
    seen = np.bincount(c[c < chunks], minlength=chunks)
    assert (seen == 1).all()
    assert (blocks - 1) * (tc.QUANT_THREADS // 32) * tc.QUANT_STEP < chunks


def emulate_quantize(x):
    """quantize_int8_kernel's arithmetic: lane j of a chunk's 8 holds its
    16-byte pieces j + 8m; each lane's max over its 16 |x| in the
    kernel's order, then the width-8 xor butterfly (offsets 4, 2, 1),
    all with the max that keeps NaN; inv = 127/a (0 unless a > 0), q =
    clamp(rint(x·inv)) with NaN -> 0, scale = a/127, all in f32."""
    C, N = x.shape
    ch = x.reshape(-1, 128).astype(np.float32)
    # (chunks, lane j, piece m, 4) -> the lane's elements
    lanes = np.abs(ch.reshape(-1, 4, 8, 4).transpose(0, 2, 1, 3))
    a = np.zeros(lanes.shape[:2], np.float32)
    for m in range(4):
        p = lanes[:, :, m]
        a = _nan_max(a, _nan_max(_nan_max(p[..., 0], p[..., 1]),
                                 _nan_max(p[..., 2], p[..., 3])))
    for off in (4, 2, 1):
        a = _nan_max(a, a[:, np.arange(8) ^ off])
    c127 = np.float32(127.0)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        inv = np.where(a > 0, c127 / a, np.float32(0.0)).astype(np.float32)
        # element 4(j + 8m) + t of the chunk sits in lane j
        lane_of = (np.arange(128) // 4) % 8
        r = np.rint(ch * inv[:, lane_of])
    q = np.clip(np.nan_to_num(r, nan=0.0), -127, 127).astype(np.int8)
    with np.errstate(invalid="ignore"):
        scale = (a[:, 0] / c127).astype(np.float32)
    # every lane of a chunk ends with the same max (NaN aside)
    fin = ~np.isnan(a[:, 0])
    assert (a[fin] == a[fin, :1]).all()
    return q.reshape(C, N), scale.reshape(C, N // 128)


def _quant_inputs(C, N, seed):
    """Round-delta-like chunks with a zero chunk, NaN, ±inf, denormals,
    exact .5 products (absmax 127, so inv is 1) and ties."""
    r = np.random.default_rng(seed)
    scale = np.exp(r.normal(size=(C, N // 128, 1)) * 3).repeat(128, axis=2)
    x = (r.normal(size=(C, N)) * scale.reshape(C, N)).astype(np.float32)
    x[:, :128] = 0.0
    x[0, 128:256] = np.arange(128) - 63.5
    x[0, 128] = 127.0
    x[0, 256:384] *= np.float32(1e-39)          # denormals
    x[-1, 384:512] = np.float32(2e-45)          # all the least denormal
    if N > 640:
        x[0, 520] = np.nan
        x[-1, 600] = np.inf
        x[-1, 610] = -np.inf
    return x


def _nan_eq_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(
        np.where(np.isnan(a), 0, a).view(np.uint32),
        np.where(np.isnan(b), 0, b).view(np.uint32))


@pytest.mark.parametrize("C,N", [(3, 128 * 41), (2, 1024 * 128)])
def test_quantize_emulation_equals_plain_and_reference(C, N):
    x = _quant_inputs(C, N, C)
    q, s = emulate_quantize(x)
    wq, ws = tcref.quantize_int8_ref(torch.from_numpy(x))
    np.testing.assert_array_equal(q, wq.numpy())
    _nan_eq_bits(s, ws.numpy())
    pq, ps = tc.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q, pq.numpy())
    _nan_eq_bits(s, ps.numpy())
    # the reference's kernel, on a copy with denormals flushed to ±0 (XLA
    # on the CPU reads them as zero; the card and the plain version
    # compare them exactly, as above), against the emulation of the same
    # copy: q equal; at a 1024-row block XLA computes absmax/127 as
    # absmax·(1/127), one ulp off the true division in some scales
    # (tests/test_torch_compress.py)
    flushed = np.where(np.abs(x) < np.finfo(np.float32).tiny,
                       np.copysign(np.float32(0.0), x), x)
    q, s = emulate_quantize(flushed)
    rq, rs = rk.quantize_int8(jnp.asarray(flushed), interpret=True)
    np.testing.assert_array_equal(q, np.asarray(rq))
    rs = np.asarray(rs)
    fin = np.isfinite(s)
    np.testing.assert_array_equal(np.isnan(s), np.isnan(rs))
    np.testing.assert_array_max_ulp(s[fin], rs[fin], 1)


def test_quantize_emulation_rounds_half_to_even():
    """Absmax 127 makes inv exactly 1: x·inv hits every .5 tie."""
    x = np.zeros((1, 128), np.float32)
    x[0, :9] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5]
    q, s = emulate_quantize(x)
    assert q[0, :9].tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 126]
    assert s[0, 0] == np.float32(1.0)


def test_dequantize_grid_reads_no_sm_count(monkeypatch):
    assert list(inspect.signature(tc.dequantize_grid).parameters) == [
        "chunks"]

    def no_sm_count(index):
        raise AssertionError("dequantize_grid read the SM count")
    monkeypatch.setattr(common, "sm_count", no_sm_count)
    tc.dequantize_grid(10 * 561)


def dequantize_lanes(chunks):
    """(chunk, elements) each thread of dequantize_int8_kernel's grid
    writes: warp w takes chunk w (DEQUANT_STEP = 1), if it is one; lane
    j its elements 4j .. 4j + 3."""
    assert tc.DEQUANT_STEP == 1
    warps = tc.dequantize_grid(chunks) * (tc.QUANT_THREADS // 32)
    chunk = np.repeat(np.arange(warps), 32)
    j = np.tile(np.arange(32), warps)
    live = chunk < chunks
    chunk, j = chunk[live], j[live]
    return chunk, 4 * j[:, None] + np.arange(4)


@pytest.mark.parametrize("chunks", CHUNKS)
def test_dequantize_grid_writes_every_element_once(chunks):
    """Every element of every chunk is written once, by a thread of its
    own chunk (so with its chunk's scale), at ragged chunk counts; every
    block has a warp with a chunk."""
    blocks = tc.dequantize_grid(chunks)
    assert (blocks - 1) * (tc.QUANT_THREADS // 32) * tc.DEQUANT_STEP \
        < chunks <= blocks * (tc.QUANT_THREADS // 32) * tc.DEQUANT_STEP
    chunk, elem = dequantize_lanes(chunks)
    flat = (chunk[:, None] * 128 + elem).ravel()
    assert np.bincount(flat, minlength=chunks * 128).tolist() == [1] * (
        chunks * 128)


# (clients, chunks a row): ragged warps and blocks, each row at most the
# reference's 1,024-row block (its grid takes no ragged block)
@pytest.mark.parametrize("C,M", [(1, 1), (3, 7), (1, 4 * 250 + 3),
                                 (2, 32 * 31 + 5), (3, 1024)])
def test_dequantize_layout_equals_plain_and_reference(C, M):
    """The kernel's layout, each product an f32 multiply of the code by
    its chunk's scale, bit for bit the plain version, with NaN, ±inf,
    zero and denormal scales beside zero codes (0 · inf is NaN); and the
    reference's kernel in interpret mode (NaN where it has NaN: XLA's
    NaN may carry another payload; scales normal or non-finite, as XLA
    on the CPU flushes denormals)."""
    r = np.random.default_rng(C * M)
    q = r.integers(-127, 128, (C, M * 128)).astype(np.int8)
    s = np.exp(r.normal(size=(C, M)) * 3).astype(np.float32)
    q[:, :64] = 0
    s.reshape(-1)[:5] = np.array([np.nan, np.inf, -np.inf, 0.0, 1e-40],
                                 np.float32)[:min(5, C * M)]
    chunk, elem = dequantize_lanes(C * M)
    out = np.full(C * M * 128, np.float32(-1.0))
    qf = q.reshape(-1).astype(np.float32)
    idx = chunk[:, None] * 128 + elem
    with np.errstate(invalid="ignore"):
        out[idx] = qf[idx] * s.reshape(-1)[chunk][:, None]
    out = out.reshape(C, M * 128)
    plain = tcref.dequantize_int8_ref(torch.from_numpy(q),
                                      torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), plain.view(np.uint32))
    np.testing.assert_array_equal(
        out.view(np.uint32),
        tc.dequantize_int8(torch.from_numpy(q),
                           torch.from_numpy(s)).numpy().view(np.uint32))
    s_ref = np.where(np.abs(s) < np.finfo(np.float32).tiny, 0.0, s).astype(
        np.float32)
    with np.errstate(invalid="ignore"):
        want = (q.reshape(C, M, 128).astype(np.float32)
                * s_ref[..., None]).reshape(C, M * 128)
    ref = np.asarray(rk.dequantize_int8(jnp.asarray(q), jnp.asarray(s_ref),
                                        interpret=True))
    _nan_eq_bits(ref, want)


@pytest.mark.parametrize("quant,dequant,threads,ok", [
    (tc.QUANT_STEP, tc.DEQUANT_STEP, tc.QUANT_THREADS, True),
    (tc.QUANT_STEP, 4, tc.QUANT_THREADS, False),
    (tc.QUANT_STEP, 8, tc.QUANT_THREADS, False),
    (1, tc.DEQUANT_STEP, tc.QUANT_THREADS, False),
    (tc.QUANT_STEP, tc.DEQUANT_STEP, 128, False)])
def test_library_whose_quantize_grids_disagree_is_refused(
        quant, dequant, threads, ok, monkeypatch):
    """The wrapper checks the library's chunks a warp step of both
    kernels and its block width when it loads it."""
    from repro_torch.kernels import build
    fake = FakeLibrary(cmp_quantize_chunks_a_step=lambda: quant,
                        cmp_dequantize_chunks_a_step=lambda: dequant,
                        cmp_quantize_threads=lambda: threads)
    monkeypatch.setattr(build, "load_library", lambda name, sources: fake)
    tc.library.cache_clear()
    try:
        if ok:
            assert tc.library() is fake
        else:
            with pytest.raises(RuntimeError, match="grids"):
                tc.library()
    finally:
        tc.library.cache_clear()
