#!/usr/bin/env python3
"""Times the histogram's and the int8 (de)quantizer's designs on the card.

    python3 scripts/hist_quant_probe.py

``quantize_int8`` (``csrc/compress.cu``) spreads a chunk over 8 lanes,
16 elements a lane, a warp taking 4 chunks (``quantize_grid``). This
script holds the kernel, through its C entry point, against the designs
it was chosen from, each an instance of QUANT_SOURCE below:

  parent layout    a warp a chunk, one 16-byte load a lane, a 5-step
                   butterfly, a 4-byte scale store (the parent's kernel);
  grid stride      the parent's layout on a grid of at most WAVES blocks
                   an SM, each warp loading its next chunk before it
                   reduces this one;
  8 lanes a chunk  16 contiguous elements a lane (four 16-byte loads),
                   one 16-byte store of 16 int8 values, the 4 scales of a
                   warp's 4 chunks as one 16-byte store;
  both             8 lanes a chunk on the grid stride;
  8 lanes interleaved, and the same on the grid stride
                   lane j of a group holding 16-byte pieces j, j + 8,
                   j + 16, j + 24 of the chunk (every load instruction
                   reads whole 128-byte lines) and storing four 4-byte
                   words: "8 lanes interleaved" is the kernel's design;
  8 lanes interleaved, 2 steps a warp
                   each warp taking 8 consecutive chunks, all 8 loads a
                   lane issued before either step is reduced;
  8 lanes interleaved, streaming stores
                   the kernel's design with evict-first stores.

Each runs at each (C, N) of QUANT_SHAPES on round-delta-like data (as
chip_smoke.py makes it), is held bitwise to the plain version, and is
timed in ROUNDS interleaved rounds (chip_smoke.py's device_ms, median
device time of 60 launches) beside the bytes' bound.

``dequantize_int8`` (``out = q · s`` per chunk) gives each warp one
chunk, a lane one 4-byte load and one 16-byte store, stored evict-first
(``dequantize_grid``). The script runs the kernel through its C entry
point against DEQUANT_SOURCE's instances, the designs it was chosen
over:

  parent layout        the parent's kernel: the same layout, plain
                       stores; "..., streaming stores" is the kernel's
                       own design built in the probe;
  ..., 2 or 4 chunks a warp
                       2 or 4 consecutive chunks a warp, every load
                       issued before any product;
  16 bytes a lane, shuffled to whole stores
                       one 16-byte load a lane (a warp 4 chunks), the
                       words shuffled so that each of the warp's four
                       stores writes one chunk's 512 bytes;
  8 lanes interleaved  quantize's layout mirrored: a chunk over 8 lanes,
                       lane j its 4-byte pieces j, j + 8, j + 16, j + 24,
                       a warp 4 chunks, four whole-line stores a lane;
  16 contiguous a lane 8 lanes a chunk, lane j one 16-byte load of
                       elements 16j..16j+15 and four 16-byte stores;
  ..., streaming stores, ..., 2 steps a warp
                       either of the last two with evict-first stores or
                       8 chunks a warp;

and torch.mul (the same products, one library call), at each (C, N) of
DEQUANT_SHAPES, each bitwise equal to the plain version (NaN and inf
scales among them), in ROUNDS interleaved rounds beside the bytes'
bound and the launch floor.

``lane_histogram`` counts with one warp up to HIST_WARP_LANES lanes and
with a grid of blocks past that, whose last block, found by a ticket,
sums the blocks' edge counts from a workspace (``hist_grid``). At each C
of CROSS_LANES the script times the one-warp path against a grid of one
block (the crossover); at each C of HIST_LANES the grid at one block per
4,096, 1,024 and 512 lanes (at most one an SM; hist_grid takes one per
HIST_BLOCK_LANES, 4,096) against the design it was chosen over, a
thread-block cluster of up to 8 blocks that gathers the counts in block
0's shared memory over distributed shared memory (no workspace, no
ticket; CLUSTER_SOURCE, built on the kernel's own counting code), and
against the plain version. B = 16 (the telemetry spec's edges); each is
held exactly to the plain version. The launch floor
(chip_smoke.launch_floor: an empty kernel from a library built like the
port's) is timed in every round. One JSON line per shape. Builds the
kernel libraries with nvcc as the port does; needs a GPU.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

QUANT_SHAPES = ((10, 71808), (10, 2 ** 20), (10, 2 ** 24))
# name -> quant_variant_launch's variant
QUANT_VARIANTS = {"parent layout": 0, "grid stride": 1,
                  "8 lanes a chunk": 2, "both": 3,
                  "8 lanes interleaved": 4,
                  "8 lanes interleaved, grid stride": 5,
                  "8 lanes interleaved, 2 steps a warp": 6,
                  "8 lanes interleaved, streaming stores": 7}
# name -> dequant_variant_launch's (layout, steps a warp, streaming)
DEQUANT_SHAPES = ((10, 71808), (10, 2 ** 18), (10, 2 ** 19), (10, 2 ** 20),
                  (10, 2 ** 24))
DEQUANT_VARIANTS = {"parent layout": (0, 1, 0),
                    "parent layout, 2 chunks a warp": (0, 2, 0),
                    "parent layout, 4 chunks a warp": (0, 4, 0),
                    "parent layout, streaming stores": (0, 1, 1),
                    "16 bytes a lane, shuffled to whole stores": (3, 1, 0),
                    "8 lanes interleaved": (1, 1, 0),
                    "16 contiguous a lane": (2, 1, 0),
                    "8 lanes interleaved, streaming stores": (1, 1, 1),
                    "16 contiguous a lane, streaming stores": (2, 1, 1),
                    "8 lanes interleaved, 2 steps a warp": (1, 2, 0),
                    "16 contiguous a lane, 2 steps a warp": (2, 2, 0)}
CROSS_LANES = (10, 32, 64, 128, 129, 256, 512)
HIST_LANES = (1000, 16384, 100000)
ROUNDS = 3
# blocks an SM of the grid-stride variants (256 threads, up to 55
# registers a thread)
WAVES = 4

QUANT_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ unsigned int quant4(const float4 v, float inv) {
  const float e[4] = {v.x, v.y, v.z, v.w};
  unsigned int w = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = __float2int_rn(__fmul_rn(e[i], inv));
    w |= static_cast<unsigned int>(
             static_cast<unsigned char>(min(max(r, -127), 127))) << (8 * i);
  }
  return w;
}

__device__ __forceinline__ void store(unsigned int* p, unsigned int v,
                                      bool stream) {
  if (stream) __stcs(p, v); else *p = v;
}

// LAYOUT 0: a warp a chunk, lane j its elements 4j..4j+3. 1: 8 lanes a
// chunk, lane j its elements 16j..16j+15. 2: 8 lanes a chunk, lane j its
// 16-byte pieces j + 8m, m < 4. STRIDE: the grid is sized to the SMs and
// each warp walks its units (a unit: the chunks a warp takes at once),
// loading the next before it reduces this one. Else each warp takes
// UNITS consecutive units, every load issued before any is reduced.
// STCS: evict-first (streaming) stores.
template <int LAYOUT, bool STRIDE, int UNITS, bool STCS>
__global__ void __launch_bounds__(kThreads)
quant_variant(const float* __restrict__ x, unsigned char* __restrict__ q,
              float* __restrict__ s, int64_t chunks) {
  constexpr int G = LAYOUT == 0 ? 32 : 8;     // lanes a chunk
  constexpr int NV = LAYOUT == 0 ? 1 : 4;     // 16-byte pieces a lane
  constexpr int U = 32 / G;                   // chunks a unit
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;
  const int j = lane % G;
  const int64_t units = (chunks + U - 1) / U;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  auto load = [&](int64_t u, float4 (&v)[NV]) {
    const int64_t c = u * U + grp;
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int piece = LAYOUT == 1 ? 4 * j + m : j + G * m;
      v[m] = c < chunks ? __ldcs(reinterpret_cast<const float4*>(
                                     x + c * kLanes) + piece)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto reduce = [&](int64_t unit, const float4 (&cur)[NV]) {
    float m = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      m = nan_max(m, nan_max(nan_max(fabsf(cur[i].x), fabsf(cur[i].y)),
                             nan_max(fabsf(cur[i].z), fabsf(cur[i].w))));
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(kFull, m, off));
    const float inv = m > 0.0f ? 127.0f / m : 0.0f;
    const float sc = m / 127.0f;
    const int64_t c = unit * U + grp;
    unsigned int* qw = reinterpret_cast<unsigned int*>(q);
    if (c < chunks) {
      if (LAYOUT == 0) {
        store(qw + c * 32 + j, quant4(cur[0], inv), STCS);
      } else if (LAYOUT == 1) {
        reinterpret_cast<uint4*>(q)[c * 8 + j] =
            make_uint4(quant4(cur[0], inv), quant4(cur[NV > 1 ? 1 : 0], inv),
                       quant4(cur[NV > 2 ? 2 : 0], inv),
                       quant4(cur[NV > 3 ? 3 : 0], inv));
      } else {
#pragma unroll
        for (int i = 0; i < NV; ++i)
          store(qw + c * 32 + j + 8 * i, quant4(cur[i], inv), STCS);
      }
    }
    if (LAYOUT == 0) {
      if (lane == 0) s[c] = sc;
    } else {
      const float s1 = __shfl_sync(kFull, sc, 8);
      const float s2 = __shfl_sync(kFull, sc, 16);
      const float s3 = __shfl_sync(kFull, sc, 24);
      const int64_t c0 = unit * U;
      if (lane == 0 && c0 < chunks) {
        if (c0 + U <= chunks) {
          *reinterpret_cast<float4*>(s + c0) = make_float4(sc, s1, s2, s3);
        } else {
          s[c0] = sc;
          if (c0 + 1 < chunks) s[c0 + 1] = s1;
          if (c0 + 2 < chunks) s[c0 + 2] = s2;
        }
      }
    }
  };
  if (STRIDE) {
    int64_t unit = warp;
    float4 cur[NV];
    load(unit, cur);
    for (; unit < units; unit += warps) {
      float4 next[NV];
      load(unit + warps, next);
      reduce(unit, cur);
#pragma unroll
      for (int i = 0; i < NV; ++i) cur[i] = next[i];
    }
  } else {
    float4 cur[UNITS][NV];
#pragma unroll
    for (int u = 0; u < UNITS; ++u) load(warp * UNITS + u, cur[u]);
#pragma unroll
    for (int u = 0; u < UNITS; ++u)
      if (warp * UNITS + u < units) reduce(warp * UNITS + u, cur[u]);
  }
}

template <int LAYOUT, bool STRIDE, int UNITS = 1, bool STCS = false>
int launch(const float* x, void* q, float* s, int64_t chunks, int sms,
           int waves, cudaStream_t st) {
  constexpr int U = LAYOUT == 0 ? 1 : 4;
  const int64_t units = (chunks + U - 1) / U;
  const int64_t per_block = (kThreads / 32) * (STRIDE ? 1 : UNITS);
  int64_t blocks = (units + per_block - 1) / per_block;
  if (STRIDE && blocks > static_cast<int64_t>(sms) * waves)
    blocks = static_cast<int64_t>(sms) * waves;
  quant_variant<LAYOUT, STRIDE, UNITS, STCS>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(
          x, static_cast<unsigned char*>(q), s, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int quant_variant_launch(const float* x, void* q, float* s,
                                    int64_t chunks, int variant, int sms,
                                    int waves, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<0, false>(x, q, s, chunks, sms, waves, st);
    case 1: return launch<0, true>(x, q, s, chunks, sms, waves, st);
    case 2: return launch<1, false>(x, q, s, chunks, sms, waves, st);
    case 3: return launch<1, true>(x, q, s, chunks, sms, waves, st);
    case 4: return launch<2, false>(x, q, s, chunks, sms, waves, st);
    case 5: return launch<2, true>(x, q, s, chunks, sms, waves, st);
    case 6: return launch<2, false, 2>(x, q, s, chunks, sms, waves, st);
    case 7: return launch<2, false, 1, true>(x, q, s, chunks, sms, waves,
                                             st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
"""

DEQUANT_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ float4 scale4(char4 c, float s) {
  return make_float4(__fmul_rn(static_cast<float>(c.x), s),
                     __fmul_rn(static_cast<float>(c.y), s),
                     __fmul_rn(static_cast<float>(c.z), s),
                     __fmul_rn(static_cast<float>(c.w), s));
}

__device__ __forceinline__ void put(float4* p, float4 v, bool stream) {
  if (stream) __stcs(p, v); else *p = v;
}

union Int4Chars {
  int4 i;
  char4 c[4];
};

// LAYOUT 0: a warp a chunk, lane j its char4 j (the parent's, plain
// load and store). 1: 8 lanes a chunk, lane j its char4s j + 8m, m < 4.
// 2: 8 lanes a chunk, lane j its 16 contiguous int8 16j..16j+15 by one
// 16-byte load, four 16-byte stores. Each warp takes STEPS consecutive
// steps (a step: the chunks a warp takes at once), every load issued
// before any product. STCS: evict-first stores.
template <int LAYOUT, int STEPS, bool STCS>
__global__ void __launch_bounds__(kThreads)
dequant_variant(const char4* __restrict__ q, const float* __restrict__ s,
                float* __restrict__ out, int64_t chunks) {
  constexpr int G = LAYOUT == 0 ? 32 : 8;     // lanes a chunk
  constexpr int NV = LAYOUT == 0 ? 1 : 4;     // char4s a lane
  constexpr int U = 32 / G;                   // chunks a step
  const int lane = threadIdx.x & 31;
  const int j = lane % G;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  char4 v[STEPS][NV];
  float sc[STEPS];
#pragma unroll
  for (int u = 0; u < STEPS; ++u) {
    const int64_t c = (warp * STEPS + u) * U + lane / G;
    if (c < chunks) {
      const char4* src = q + c * (kLanes / 4);
      if (LAYOUT == 0) {
        v[u][0] = src[j];
      } else if (LAYOUT == 1) {
#pragma unroll
        for (int m = 0; m < NV; ++m) v[u][m] = __ldcs(src + j + G * m);
      } else {
        Int4Chars w;
        w.i = __ldcs(reinterpret_cast<const int4*>(src) + j);
#pragma unroll
        for (int m = 0; m < NV; ++m) v[u][m] = w.c[m];
      }
      sc[u] = __ldg(s + c);
    }
  }
#pragma unroll
  for (int u = 0; u < STEPS; ++u) {
    const int64_t c = (warp * STEPS + u) * U + lane / G;
    if (c >= chunks) continue;
    float4* dst = reinterpret_cast<float4*>(out + c * kLanes);
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      const int piece = LAYOUT == 2 ? 4 * j + m : j + G * m;
      put(dst + piece, scale4(v[u][m], sc[u]), STCS);
    }
  }
}

union Int4Words {
  int4 i;
  int w[4];
};

// 16 contiguous int8 a lane (one 16-byte load; a warp 4 chunks, 512
// bytes), then shuffled so that store m of the warp writes chunk m's 512
// output bytes contiguously: lane l stores elements 4l..4l+3 of the
// chunk, held by lane 8m + l / 4 as its word l % 4.
__global__ void __launch_bounds__(kThreads)
dequant_shuffled(const char4* __restrict__ q, const float* __restrict__ s,
                 float* __restrict__ out, int64_t chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t c0 =
      (static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
       (threadIdx.x >> 5)) * 4;
  if (c0 >= chunks) return;   // whole warps leave together
  Int4Words v;
  v.i = c0 + lane / 8 < chunks
            ? __ldcs(reinterpret_cast<const int4*>(q + c0 * (kLanes / 4)) +
                     lane)
            : make_int4(0, 0, 0, 0);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int src = 8 * m + (lane >> 2);
    int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __shfl_sync(0xffffffffu, v.w[i], src);
    const int at = lane & 3;
    const int mine = at == 0 ? w[0] : at == 1 ? w[1] : at == 2 ? w[2] : w[3];
    if (c0 + m < chunks) {
      const char4 c = *reinterpret_cast<const char4*>(&mine);
      reinterpret_cast<float4*>(out + (c0 + m) * kLanes)[lane] =
          scale4(c, __ldg(s + c0 + m));
    }
  }
}

int launch_shuffled(const void* q, const float* s, float* out,
                    int64_t chunks, cudaStream_t st) {
  const int64_t blocks = (chunks + 4 * (kThreads / 32) - 1) /
                         (4 * (kThreads / 32));
  dequant_shuffled<<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(
      static_cast<const char4*>(q), s, out, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <int LAYOUT, int STEPS, bool STCS>
int launch(const void* q, const float* s, float* out, int64_t chunks,
           cudaStream_t st) {
  constexpr int U = LAYOUT == 0 ? 1 : 4;
  const int64_t per_block = (kThreads / 32) * STEPS * U;
  const int64_t blocks = (chunks + per_block - 1) / per_block;
  dequant_variant<LAYOUT, STEPS, STCS>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(
          static_cast<const char4*>(q), s, out, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dequant_variant_launch(const void* q, const float* s,
                                      float* out, int64_t chunks,
                                      int layout, int steps, int stream_st,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int code = layout * 100 + steps * 10 + stream_st;
  switch (code) {
    case 10: return launch<0, 1, false>(q, s, out, chunks, st);
    case 20: return launch<0, 2, false>(q, s, out, chunks, st);
    case 40: return launch<0, 4, false>(q, s, out, chunks, st);
    case 11: return launch<0, 1, true>(q, s, out, chunks, st);
    case 310: return launch_shuffled(q, s, out, chunks, st);
    case 110: return launch<1, 1, false>(q, s, out, chunks, st);
    case 210: return launch<2, 1, false>(q, s, out, chunks, st);
    case 111: return launch<1, 1, true>(q, s, out, chunks, st);
    case 211: return launch<2, 1, true>(q, s, out, chunks, st);
    case 120: return launch<1, 2, false>(q, s, out, chunks, st);
    case 220: return launch<2, 2, false>(q, s, out, chunks, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
"""

# Appended to the text of csrc/telemetry.cu (one translation unit), so
# it counts with the kernel's own load_sweep / load_edges / count_tile.
CLUSTER_SOURCE = r"""
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Block r of a cluster of k takes the lanes of block r of a grid of k;
// each warp adds its edge counts into block 0's shared counters over
// distributed shared memory, which block 0 zeroes before the first
// cluster barrier; after the second, block 0 writes the bins.
__global__ void __launch_bounds__(kHistThreads)
hist_cluster_kernel(const float* __restrict__ x, int C,
                    const float* __restrict__ edges, int B,
                    float* __restrict__ out) {
  extern __shared__ int total[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int stride = static_cast<int>(cluster.num_blocks()) *
                     kHistBlockLanes;
  const int lane = threadIdx.x & 31;
  const int s_first = rank * kHistBlockLanes;
  float cur[kHistPerThread];
  load_sweep(x, C, s_first, cur);
  const int b0 = threadIdx.x;
  const float lo0 = b0 < B ? edges[b0] : 0.0f;
  const float hi0 = b0 < B ? edges[b0 + 1] : 0.0f;
  if (rank == 0)
    for (int i = threadIdx.x; i <= B; i += kHistThreads) total[i] = 0;
  cluster_arrive();
  int* const sum = cluster.map_shared_rank(total, 0);
  bool waited = false;
  for (int first = 0; first <= B; first += kTileEdges) {
    if (first > 0) load_sweep(x, C, s_first, cur);
    float e[kRegEdges];
    int g[kRegEdges] = {};
    load_edges(edges, B, first, lane, e);
    const int ne = min(kTileEdges, B + 1 - first);
    for (int s0 = s_first; s0 < C; s0 += stride) {
      float next[kHistPerThread];
      load_sweep(x, C, s0 + stride, next);
      count_tile<kHistPerThread>(cur, e, ne, lane, g);
#pragma unroll
      for (int m = 0; m < kHistPerThread; ++m) cur[m] = next[m];
    }
    if (!waited) {
      cluster_wait();
      waited = true;
    }
#pragma unroll
    for (int j = 0; j < kRegEdges; ++j) {
      const int i = first + 32 * j + lane;
      if (i <= B && g[j] != 0) atomicAdd(sum + i, g[j]);
    }
  }
  cluster_arrive();
  if (rank != 0) return;
  cluster_wait();
  for (int b = b0; b < B; b += kHistThreads) {
    const float lo = b == b0 ? lo0 : edges[b];
    const float hi = b == b0 ? hi0 : edges[b + 1];
    out[b] = lo <= hi ? static_cast<float>(total[b] - total[b + 1]) : 0.0f;
  }
}

}  // namespace

extern "C" int hist_cluster_launch(const float* x, int C, const float* edges,
                                   int B, int blocks, float* out,
                                   void* stream) {
  if (blocks < 1 || blocks > 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(blocks));
  cfg.blockDim = dim3(kHistThreads);
  cfg.dynamicSmemBytes = sizeof(int) * static_cast<size_t>(B + 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(blocks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, hist_cluster_kernel, x, C, edges, B, out));
}
"""


def probe_library(name, text):
    from repro_torch.kernels import build
    src = build.BUILD_DIR.parent / "probe" / f"{name}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    return build.load_library(name, [src]), build.library_path(
        name, [src]).with_suffix(".log")


def probe_dequantize(torch, tcomp, tcref, dlib, floor, gen, C, N, bw):
    """dequantize_int8's layouts at (C, N): one JSON line."""
    from chip_smoke import device_ms
    from repro_torch.kernels import common
    M = N // 128
    chunks = C * M
    stream = torch.cuda.current_stream().cuda_stream
    q = torch.randint(-127, 128, (C, N), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = torch.exp(3 * torch.randn((C, M), generator=gen, device="cuda"))
    q[0, :128] = 0
    s[0, 1:4] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    s[0, 0] = float("inf")        # 0 · inf: NaN
    want = tcref.dequantize_int8_ref(q, s).view(torch.int32)
    out = torch.empty((C, N), device="cuda")

    def variant(layout, steps, st):
        common.raise_on(dlib.dequant_variant_launch(
            q.data_ptr(), s.data_ptr(), out.data_ptr(), chunks, layout,
            steps, st, stream), "dequant_variant")
        return out

    def kernel():
        common.raise_on(tcomp.library().cmp_dequantize_int8(
            q.data_ptr(), s.data_ptr(), out.data_ptr(), chunks,
            tcomp.dequantize_grid(chunks), stream), "dequantize_int8")
        return out

    timed = {"the kernel": kernel}
    timed.update({name: (lambda a=a: variant(*a))
                  for name, a in DEQUANT_VARIANTS.items()})
    for name, fn in timed.items():
        out.fill_(-1.0)
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want):
            raise AssertionError(f"dequantize {name} at {(C, N)}: not "
                                 "bitwise equal to the plain version")
    timed["torch.mul"] = lambda: torch.mul(q.view(C, M, 128), s[..., None])
    timed["launch floor"] = floor
    us = {name: [] for name in timed}
    for _ in range(ROUNDS):
        for name, fn in timed.items():
            us[name].append(round(device_ms(fn, torch) * 1e3, 3))
    print(json.dumps({
        "dequantize_int8": [C, N], "us": us,
        "grid": tcomp.dequantize_grid(chunks),
        "bound_us": round((5 * C * N + 4 * chunks) / bw * 1e6, 3)}),
        flush=True)
    del q, s, out, want
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("hist_quant_probe: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import _tele_lanes, device_ms, launch_floor, peaks
    from repro_torch.kernels import build, common
    from repro_torch.kernels.compress import compress as tcomp
    from repro_torch.kernels.compress import ref as tcref
    from repro_torch.kernels.telemetry import ref as ttref
    from repro_torch.kernels.telemetry import telemetry as tt
    from repro_torch.telemetry import TelemetrySpec

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    bw = peaks(torch.cuda.get_device_name(0))[0]
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    qlib, qlog = probe_library("quant_variants", QUANT_SOURCE)
    qlib.quant_variant_launch.argtypes = [vp, vp, vp, i64, i32, i32, i32,
                                          vp]
    dlib, dlog = probe_library("dequant_variants", DEQUANT_SOURCE)
    dlib.dequant_variant_launch.argtypes = [vp, vp, vp, i64, i32, i32, i32,
                                            vp]
    clib, clog = probe_library("hist_cluster", tt.SOURCES[0].read_text()
                               + CLUSTER_SOURCE)
    clib.hist_cluster_launch.argtypes = [vp, i32, vp, i32, i32, vp, vp]
    floor = launch_floor(torch, build)
    tcomp.library(), tt.library()
    for log in (build.library_path("compress", tcomp.SOURCES)
                .with_suffix(".log"),
                build.library_path("telemetry", tt.SOURCES)
                .with_suffix(".log"), qlog, dlog, clog):
        print("\n".join(line for line in log.read_text().splitlines()
                        if "Used" in line or "spill" in line
                        or "error" in line))
    stream = torch.cuda.current_stream().cuda_stream
    sms = common.sm_count(0)
    gen = torch.Generator(device="cuda").manual_seed(1)

    for C, N in QUANT_SHAPES:
        M = N // 128
        scale = torch.exp(3 * torch.randn((C, M, 1), generator=gen,
                                          device="cuda"))
        x = (torch.randn((C, M, 128), generator=gen, device="cuda")
             * scale).view(C, N)
        x[:, :128] = 0.0
        want_q, want_s = tcref.quantize_int8_ref(x)
        q = torch.empty((C, N), dtype=torch.int8, device="cuda")
        s = torch.empty((C, M), device="cuda")
        chunks = C * M

        def variant(code):
            common.raise_on(qlib.quant_variant_launch(
                x.data_ptr(), q.data_ptr(), s.data_ptr(), chunks, code, sms,
                WAVES, stream), "quant_variant")
            return q, s

        def kernel():
            common.raise_on(tcomp.library().cmp_quantize_int8(
                x.data_ptr(), q.data_ptr(), s.data_ptr(), chunks,
                tcomp.quantize_grid(chunks), stream), "quantize_int8")
            return q, s

        timed = {"the kernel": kernel}
        timed.update({name: (lambda c=c: variant(c))
                      for name, c in QUANT_VARIANTS.items()})
        for name, fn in timed.items():
            q.fill_(99)
            s.fill_(-1.0)
            got_q, got_s = fn()
            torch.cuda.synchronize()
            if not (torch.equal(got_q, want_q) and torch.equal(
                    got_s.view(torch.int32), want_s.view(torch.int32))):
                raise AssertionError(f"{name} at {(C, N)}: not bitwise "
                                     "equal to the plain version")
        timed["launch floor"] = floor
        us = {name: [] for name in timed}
        for _ in range(ROUNDS):
            for name, fn in timed.items():
                us[name].append(round(device_ms(fn, torch) * 1e3, 3))
        print(json.dumps({
            "quantize_int8": [C, N], "us": us,
            "grid": tcomp.quantize_grid(chunks),
            "bound_us": round((5 * C * N + 4 * chunks) / bw * 1e6, 3)}),
            flush=True)
        del x, q, s, want_q, want_s
        torch.cuda.empty_cache()
    for C, N in DEQUANT_SHAPES:
        probe_dequantize(torch, tcomp, tcref, dlib, floor, gen, C, N, bw)

    edges = TelemetrySpec().edges_on("cuda")
    B = edges.numel() - 1
    out = torch.empty((B,), device="cuda")

    def direct(x, blocks, per_thread):
        partial = ticket = None
        if blocks > 1:
            partial, ticket = tt._hist_workspace(x.device, stream, B, blocks)
        common.raise_on(tt.library().tele_lane_histogram(
            x.data_ptr(), x.numel(), edges.data_ptr(), B, blocks,
            per_thread, None if partial is None else partial.data_ptr(),
            None if ticket is None else ticket.data_ptr(), out.data_ptr(),
            stream), "lane_histogram")
        return out

    def cluster(x, k):
        common.raise_on(clib.hist_cluster_launch(
            x.data_ptr(), x.numel(), edges.data_ptr(), B, k, out.data_ptr(),
            stream), "hist_cluster")
        return out

    for C in CROSS_LANES + HIST_LANES:
        x = torch.from_numpy(_tele_lanes(C, C)).cuda().abs()
        want = ttref.lane_histogram_ref(x, edges)
        per = next((v for v in tt.HIST_WARP_PER_THREAD if 32 * v >= C),
                   None)
        timed = {}
        if per is not None:
            timed[f"one warp, {per} a thread"] = (
                lambda x=x, per=per: direct(x, 0, per))
        for lanes in (4096, 1024, 512) if C in HIST_LANES else (C,):
            kb = min(sms, -(-C // lanes))
            timed[f"grid of {kb}"] = (
                lambda x=x, kb=kb: direct(x, kb, tt.HIST_PER_THREAD))
        if C in HIST_LANES:
            k = min(8, -(-C // tt.HIST_BLOCK_LANES))
            timed[f"cluster of {k}"] = lambda x=x, k=k: cluster(x, k)
            timed["plain version"] = (
                lambda x=x: ttref.lane_histogram_ref(x, edges))
        timed["wrapper " + str(tuple(tt.hist_grid(C, B, sms)))] = (
            lambda x=x: tt.lane_histogram(x, edges))
        for name, fn in timed.items():
            out.fill_(-1.0)
            for _ in range(2):
                got = fn().clone()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"lane_histogram {name} at C = {C}:"
                                         f" {got} != plain {want}")
        timed["launch floor"] = floor
        us = {name: [] for name in timed}
        for _ in range(ROUNDS):
            for name, fn in timed.items():
                us[name].append(round(device_ms(fn, torch) * 1e3, 3))
        print(json.dumps({"lane_histogram": C, "bins": B, "us": us}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
