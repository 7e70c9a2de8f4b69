#!/usr/bin/env python3
"""Times the Δ-SGD kernels' designs and grid choices on the card.

    python3 scripts/norms_probe.py

``batched_norms`` and the single-tensor ``norms`` run one kernel.
``batched_norms`` runs it on a block per 8,192 elements of a row, the
last block of each row summing the blocks' pairs, its workspace kept
per stream (``norms_grid``). This script holds it against the
design it was chosen over, one thread-block cluster per client row
(CLUSTER_SOURCE below: k blocks deal the row's trips among them, stage
them in shared memory with cp.async and gather their pairs in rank 0
over distributed shared memory; no workspace), for each k in CLUSTERS
(8 is the portable cluster limit), and against the kernel with its
tickets zeroed before every call, as a wrapper without a kept
workspace must, at each (C, N) in NORMS_SHAPES, from the paper's CNN
width (10, 71,808) to (10, 2**24). Each is checked against the plain
version (rtol 1e-5) and two calls of it for equal bits.

``batched_apply`` gives each thread one 16-byte column of a group of
clients; ``apply_grid`` picks the group and the block. At each shape of
APPLY_SHAPES the script runs the wrapper's grid and each group size of
APPLY_GROUPS on apply_grid's block rule, masked and not, each bitwise
equal to the plain version.

Every variant, the wrappers' own choices and torch.addcmul are then
timed in ROUNDS interleaved rounds (chip_smoke.py's device_ms, median
device time of 60 launches); one JSON line per shape lists each
variant's times in µs.

``norms`` (one tensor, f32 or bf16) runs the same kernel on the grid
``single_norms_grid`` picks from (n, dtype): a block a chunk, the chunk
shrinking with n. At each n of SINGLE_SIZES, in f32 and bf16, the
script times, through C entry points and beside the launch floor
(chip_smoke.launch_floor):

  (a) parent        the parent's kernel (PARENT_SOURCE below: a block
                    per 8,192 f32 or 16,384 bf16 elements, its ticket
                    zeroed by a fill before every call, scratch made
                    each call);
  (b) ticket grid, 8 loads a thread
                    the parent's chunk with the workspace kept per
                    stream (no fill);
  (c) ticket grid, 1, 2 or 4 loads a thread
                    a chunk of 1,024 to 4,096 f32 (2,048 to 8,192 bf16)
                    elements, so more blocks;
  (d) cluster of k  one thread-block cluster of k = 4, 8 or 16 blocks
                    (16 is a non-portable size) dealing the chunks of 8
                    loads a thread among them and gathering the pairs
                    over distributed shared memory, no workspace (up to
                    2**20 elements; SINGLE_SOURCE below);
  stride            a fixed number of blocks (SINGLE_STRIDES) striding
                    over the chunks, each loading its next chunk before
                    it sums this one, then the ticket (from 2**20
                    elements; SINGLE_SOURCE below);

and the wrapper. Each is held to the plain version (rtol 1e-5 f32, 3e-3
bf16) and to itself bitwise over two calls. At NORMS_SHAPES the script
also holds ``batched_norms`` bitwise to the parent's kernel, and times
that kernel beside it: it keeps its bits and its time. Builds the
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

NORMS_SHAPES = ((10, 71808), (10, 2 ** 18), (10, 2 ** 20), (10, 2 ** 24))
APPLY_SHAPES = ((10, 71808), (50, 71808), (100, 71808), (10, 2 ** 24))
CLUSTERS = (4, 8)
APPLY_GROUPS = (1, 5, 8)
ROUNDS = 3
SINGLE_SIZES = (71808, 2 ** 18, 2 ** 20, 2 ** 24)
SINGLE_CLUSTERS = (4, 8, 16)
SINGLE_CLUSTER_MAX_N = 2 ** 20
# (loads a thread, blocks) of the stride candidates, from 2**20 elements
SINGLE_STRIDES = ((2, 256), (2, 512), (4, 128), (4, 256))
SINGLE_STRIDE_MIN_N = 2 ** 20

# The cluster design: grid (k, C), cluster (k, 1, 1), 512 threads a
# block. Trips of 1,024 float4s a row are dealt round the k blocks
# (block r takes trips r, r + k, ...); each thread stages its own pieces
# of a trip with cp.async three trips ahead of the one it sums; the
# block tree, then each block's pair into rank 0's shared memory, and
# rank 0 sums the k pairs in rank order.
CLUSTER_SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;
constexpr int kT = 512;
constexpr int kWarps = kT / 32;
constexpr int kTrip = 1024;
constexpr int kStages = 4;
constexpr int kRing = kStages * 2 * kTrip * 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kWarps];
  __shared__ float sb[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? sa[lane] : 0.0f;
    b = lane < kWarps ? sb[lane] : 0.0f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned int>(__cvta_generic_to_shared(smem))),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__global__ void __launch_bounds__(kT)
cluster_norms(const float* __restrict__ g, const float* __restrict__ gp,
              int64_t n, float* __restrict__ dg_out,
              float* __restrict__ gg_out) {
  constexpr int kV = kTrip / kT;
  extern __shared__ float4 ring[];   // [stage][g, g_prev][kV][kT]
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t c = blockIdx.y;
  const int64_t n4 = n / 4;
  const float4* g4 = reinterpret_cast<const float4*>(g + c * n);
  const float4* gp4 = reinterpret_cast<const float4*>(gp + c * n);
  const int k = static_cast<int>(cluster.num_blocks());
  const int64_t row_trips = (n4 + kTrip - 1) / kTrip;
  const int64_t trips = row_trips > rank ? (row_trips - rank + k - 1) / k : 0;
  auto issue = [&](int64_t q) {
    if (q < trips) {
      float4* slot = ring + (q % kStages) * 2 * kTrip + threadIdx.x;
      const int64_t base = (rank + q * k) * kTrip + threadIdx.x;
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int64_t j = base + i * kT;
        const int64_t at = j < n4 ? j : 0;
        const int bytes = j < n4 ? 16 : 0;
        cp_async16(slot + i * kT, g4 + at, bytes);
        cp_async16(slot + (kV + i) * kT, gp4 + at, bytes);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  float dg = 0.0f;
  float gg = 0.0f;
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) issue(q);
  for (int64_t q = 0; q < trips; ++q) {
    issue(q + kStages - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    const float4* slot = ring + (q % kStages) * 2 * kTrip + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const float4 a = slot[i * kT];
      const float4 b = slot[(kV + i) * kT];
      const float dx = a.x - b.x, dy = a.y - b.y;
      const float dz = a.z - b.z, dw = a.w - b.w;
      dg += dx * dx + dy * dy + dz * dz + dw * dw;
      gg += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
    }
  }
  block_sum2(dg, gg);
  __shared__ float2 pairs[kMaxCluster];
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x == 0)
    *cluster.map_shared_rank(&pairs[rank], 0) = make_float2(dg, gg);
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (rank != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (threadIdx.x == 0) {
    float sdg = 0.0f;
    float sgg = 0.0f;
    for (int r = 0; r < k; ++r) {
      sdg += pairs[r].x;
      sgg += pairs[r].y;
    }
    dg_out[c] = sdg;
    gg_out[c] = sgg;
  }
}

}  // namespace

extern "C" {

// Sets the ring's shared memory limit; once, before any launch.
int cluster_norms_init(void) {
  return static_cast<int>(cudaFuncSetAttribute(
      cluster_norms, cudaFuncAttributeMaxDynamicSharedMemorySize, kRing));
}

int cluster_norms_launch(const float* g, const float* gp, int64_t C,
                         int64_t n, int k, float* dg, float* gg,
                         void* stream) {
  if (k < 1 || k > kMaxCluster || n < 4 || C < 1 || C > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t trips = ((n / 4 + kTrip - 1) / kTrip + k - 1) / k;
  const int64_t stages = trips < kStages ? trips : kStages;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(k),
                     static_cast<unsigned int>(C));
  cfg.blockDim = dim3(kT);
  cfg.dynamicSmemBytes = static_cast<size_t>(stages * 2 * kTrip * 16);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(k);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, cluster_norms, g, gp, n, dg, gg));
}

}  // extern "C"
"""

# Appended to the text of csrc/delta_sgd.cu (one translation unit), so
# its candidates sum with the kernel's own chunk_sums / add_quad /
# block_sum2 / tail_sums: (d) one thread-block cluster, and a grid of a
# fixed number of blocks that stride over the chunks, each loading its
# next chunk before it sums this one (16-byte path only).
SINGLE_SOURCE = r"""
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

// most blocks of one norms cluster (past 8 the cluster size is
// non-portable, allowed per kernel by an attribute)
constexpr int kMaxCluster = 16;

// One cluster of k blocks over one tensor: block r sums chunks r, r + k,
// ... (one after another, each chunk's loads issued together), the block
// tree, then its pair into block 0's shared memory over distributed
// shared memory; block 0 adds the k pairs in rank order and the ragged
// end. No workspace, no ticket, no fence.
template <typename T, int kV, bool kVec>
__global__ void __launch_bounds__(kThreads)
norms_cluster_kernel(const T* __restrict__ g, const T* __restrict__ gp,
                     int64_t n, int64_t chunks, float* __restrict__ out) {
  __shared__ float2 pairs[kMaxCluster];
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int rank = cluster.block_rank();
  const unsigned int k = cluster.num_blocks();
  float dg = 0.0f;
  float gg = 0.0f;
  for (int64_t chunk = rank; chunk < chunks; chunk += k)
    chunk_sums<T, kV, kVec>(g, gp, n, chunk, dg, gg);
  block_sum2(dg, gg);
  // every block of the cluster has started: block 0's pairs exist
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x == 0)
    *cluster.map_shared_rank(&pairs[rank], 0) = make_float2(dg, gg);
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (rank != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (threadIdx.x == 0) {
    float sdg = 0.0f;
    float sgg = 0.0f;
    for (unsigned int r = 0; r < k; ++r) {
      sdg += pairs[r].x;
      sgg += pairs[r].y;
    }
    tail_sums<T, kVec>(g, gp, n, sdg, sgg);
    out[0] = sdg;
    out[1] = sgg;
  }
}

template <typename T, int kV, bool kVec>
int launch_norms_cluster(const T* g, const T* gp, int64_t n, int64_t chunks,
                         int k, float* out, cudaStream_t s) {
  auto kernel = &norms_cluster_kernel<T, kV, kVec>;
  if (k > 8) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(k));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(k);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, g, gp, n, chunks,
                                             out));
}

// Block b sums chunks b, b + gridDim.x, ... in order, the loads of the
// next issued before this one is summed; then the ticket ending of
// norms_kernel over gridDim.x pairs.
template <typename T, int kV>
__global__ void __launch_bounds__(kThreads)
norms_stride_kernel(const T* __restrict__ g, const T* __restrict__ gp,
                    int64_t n, int64_t chunks, float2* __restrict__ partial,
                    unsigned int* __restrict__ counter,
                    float* __restrict__ out) {
  using P = Pack16<T>;
  constexpr int kN = P::kN;
  const int64_t units = n / kN;
  const uint4* g16 = reinterpret_cast<const uint4*>(g);
  const uint4* gp16 = reinterpret_cast<const uint4*>(gp);
  const int64_t step = gridDim.x;
  auto load = [&](int64_t chunk, uint4 (&x)[kV], uint4 (&y)[kV]) {
    const int64_t base = chunk * (kThreads * kV) + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int64_t j = base + i * kThreads;
      if (chunk < chunks && j < units) {
        x[i] = __ldcs(g16 + j);
        y[i] = __ldcs(gp16 + j);
      } else {
        x[i] = make_uint4(0u, 0u, 0u, 0u);
        y[i] = x[i];
      }
    }
  };
  float dg = 0.0f;
  float gg = 0.0f;
  uint4 a[kV];
  uint4 b[kV];
  load(blockIdx.x, a, b);
  for (int64_t chunk = blockIdx.x; chunk < chunks; chunk += step) {
    uint4 na[kV];
    uint4 nb[kV];
    load(chunk + step, na, nb);
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      float x[kN];
      float y[kN];
      P::unpack(a[i], x);
      P::unpack(b[i], y);
#pragma unroll
      for (int q = 0; q < kN; q += 4) add_quad(x + q, y + q, dg, gg);
      a[i] = na[i];
      b[i] = nb[i];
    }
  }
  block_sum2(dg, gg);
  const int blocks = static_cast<int>(gridDim.x);
  __shared__ bool is_last;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = make_float2(dg, gg);
    __threadfence();
    is_last = atomicAdd(counter, 1u) == static_cast<unsigned int>(blocks - 1);
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float sdg = 0.0f;
  float sgg = 0.0f;
  for (int i = threadIdx.x; i < blocks; i += kThreads) {
    const float2 p = __ldcg(partial + i);
    sdg += p.x;
    sgg += p.y;
  }
  block_sum2(sdg, sgg);
  if (threadIdx.x == 0) {
    tail_sums<T, true>(g, gp, n, sdg, sgg);
    out[0] = sdg;
    out[1] = sgg;
    *counter = 0u;
  }
}

template <typename T, int kV>
int launch_stride(const void* g, const void* gp, int64_t n, int blocks,
                  void* partial, void* counter, float* out, cudaStream_t s) {
  const int64_t chunk = norms_chunk<T>(kV);
  norms_stride_kernel<T, kV><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(gp), n,
      (n + chunk - 1) / chunk, static_cast<float2*>(partial),
      static_cast<unsigned int*>(counter), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int probe_norms_cluster(const void* g, const void* gp, int dtype,
                                   int64_t n, int k, float* out,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    const int64_t chunk = norms_chunk<float>(8);
    return launch_norms_cluster<float, 8, true>(
        static_cast<const float*>(g), static_cast<const float*>(gp), n,
        (n + chunk - 1) / chunk, k, out, s);
  }
  const int64_t chunk = norms_chunk<__nv_bfloat16>(8);
  return launch_norms_cluster<__nv_bfloat16, 8, true>(
      static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(gp), n, (n + chunk - 1) / chunk, k,
      out, s);
}

extern "C" int probe_norms_stride(const void* g, const void* gp, int dtype,
                                  int64_t n, int vecs, int blocks,
                                  void* partial, void* counter, float* out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = dtype * 10 + vecs;
  switch (code) {
    case 2: return launch_stride<float, 2>(g, gp, n, blocks, partial,
                                           counter, out, s);
    case 4: return launch_stride<float, 4>(g, gp, n, blocks, partial,
                                           counter, out, s);
    case 12: return launch_stride<__nv_bfloat16, 2>(g, gp, n, blocks,
                                                    partial, counter, out, s);
    case 14: return launch_stride<__nv_bfloat16, 4>(g, gp, n, blocks,
                                                    partial, counter, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
"""

# The parent's single-tensor norms kernel (and its batched_norms kernel,
# to hold the new one's bits), as they stood before one kernel took both.
PARENT_SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNormsVecs = 8;
constexpr int kNormsChunk = kThreads * kNormsVecs * 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sums a and b over the block in a fixed tree; thread 0 holds the result.
// Callers separate two uses with __syncthreads (shared scratch reuse).
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kWarps];
  __shared__ float sb[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? sa[lane] : 0.0f;
    b = lane < kWarps ? sb[lane] : 0.0f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

__global__ void __launch_bounds__(kThreads)
batched_norms_kernel(const float* __restrict__ g,
                     const float* __restrict__ gp, int64_t n, int chunks,
                     float2* __restrict__ partial,
                     unsigned int* __restrict__ counter,
                     float* __restrict__ dg_out,
                     float* __restrict__ gg_out) {
  const int64_t c = blockIdx.y;
  const int chunk = blockIdx.x;
  const int64_t n4 = n / 4;
  const float4* g4 = reinterpret_cast<const float4*>(g + c * n);
  const float4* gp4 = reinterpret_cast<const float4*>(gp + c * n);
  const int64_t base = static_cast<int64_t>(chunk) * (kNormsChunk / 4);

  float4 a[kNormsVecs];
  float4 b[kNormsVecs];
#pragma unroll
  for (int i = 0; i < kNormsVecs; ++i) {
    const int64_t j = base + i * kThreads + threadIdx.x;
    if (j < n4) {
      a[i] = __ldcs(g4 + j);
      b[i] = __ldcs(gp4 + j);
    } else {
      a[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      b[i] = a[i];
    }
  }
  float dg = 0.0f;
  float gg = 0.0f;
#pragma unroll
  for (int i = 0; i < kNormsVecs; ++i) {
    const float dx = a[i].x - b[i].x, dy = a[i].y - b[i].y;
    const float dz = a[i].z - b[i].z, dw = a[i].w - b[i].w;
    dg += dx * dx + dy * dy + dz * dz + dw * dw;
    gg += a[i].x * a[i].x + a[i].y * a[i].y + a[i].z * a[i].z +
          a[i].w * a[i].w;
  }
  block_sum2(dg, gg);

  __shared__ bool is_last;
  if (threadIdx.x == 0) {
    partial[c * chunks + chunk] = make_float2(dg, gg);
    __threadfence();
    const unsigned int done = atomicAdd(counter + c, 1u);
    is_last = (done == static_cast<unsigned int>(chunks - 1));
  }
  __syncthreads();
  if (!is_last) return;

  // every other block's pair is visible (they fenced before counting):
  // thread t sums chunks t, t + kThreads, ..., then the fixed block tree
  __threadfence();
  float sdg = 0.0f;
  float sgg = 0.0f;
  const float2* row = partial + c * chunks;
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    const float2 p = __ldcg(row + i);
    sdg += p.x;
    sgg += p.y;
  }
  block_sum2(sdg, sgg);
  if (threadIdx.x == 0) {
    dg_out[c] = sdg;
    gg_out[c] = sgg;
    counter[c] = 0u;   // every block of this client has counted
  }
}

// 16 bytes of T: kN elements, unpacked to and packed from f32
template <typename T>
struct Pack16;

template <>
struct Pack16<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
};

template <>
struct Pack16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& r, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// elements of one tensor that one single-tensor norms block reduces
template <typename T>
__host__ __device__ constexpr int norms_chunk() {
  return kThreads * kNormsVecs * Pack16<T>::kN;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
norms_kernel(const T* __restrict__ g, const T* __restrict__ gp, int64_t n,
             int chunks, float2* __restrict__ partial,
             unsigned int* __restrict__ counter, float* __restrict__ out) {
  using P = Pack16<T>;
  constexpr int kN = P::kN;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * norms_chunk<T>();
  float dg = 0.0f;
  float gg = 0.0f;
  if (kVec) {
    // vector i of this thread holds elements e .. e + kN − 1; all loads
    // are issued before any is summed
    uint4 a[kNormsVecs];
    uint4 b[kNormsVecs];
#pragma unroll
    for (int i = 0; i < kNormsVecs; ++i) {
      const int64_t e = base + (static_cast<int64_t>(i) * kThreads +
                                threadIdx.x) * kN;
      if (e + kN <= n) {
        a[i] = __ldcs(reinterpret_cast<const uint4*>(g + e));
        b[i] = __ldcs(reinterpret_cast<const uint4*>(gp + e));
      } else {
        a[i] = make_uint4(0u, 0u, 0u, 0u);
        b[i] = a[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kNormsVecs; ++i) {
      const int64_t e = base + (static_cast<int64_t>(i) * kThreads +
                                threadIdx.x) * kN;
      float x[kN];
      float y[kN];
      if (e + kN <= n) {
        P::unpack(a[i], x);
        P::unpack(b[i], y);
      } else {
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          x[j] = e + j < n ? to_f32(g[e + j]) : 0.0f;
          y[j] = e + j < n ? to_f32(gp[e + j]) : 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float d = x[j] - y[j];
        dg += d * d;
        gg += x[j] * x[j];
      }
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < kNormsVecs * kN; ++i) {
      const int64_t e = base + static_cast<int64_t>(i) * kThreads +
                        threadIdx.x;
      if (e < n) {
        const float x = to_f32(g[e]);
        const float d = x - to_f32(gp[e]);
        dg += d * d;
        gg += x * x;
      }
    }
  }
  block_sum2(dg, gg);

  __shared__ bool is_last;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = make_float2(dg, gg);
    __threadfence();
    const unsigned int done = atomicAdd(counter, 1u);
    is_last = (done == static_cast<unsigned int>(chunks - 1));
  }
  __syncthreads();
  if (!is_last) return;
  // the last block sums the partials in chunk order (as batched_norms)
  __threadfence();
  float sdg = 0.0f;
  float sgg = 0.0f;
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    const float2 p = __ldcg(partial + i);
    sdg += p.x;
    sgg += p.y;
  }
  block_sum2(sdg, sgg);
  if (threadIdx.x == 0) {
    out[0] = sdg;
    out[1] = sgg;
  }
}

template <typename T>
int launch_norms(const void* g, const void* gp, int64_t n, bool vec,
                 void* partial, void* counter, float* out,
                 cudaStream_t s) {
  const int chunks =
      static_cast<int>((n + norms_chunk<T>() - 1) / norms_chunk<T>());
  const T* a = static_cast<const T*>(g);
  const T* b = static_cast<const T*>(gp);
  float2* pp = static_cast<float2*>(partial);
  unsigned int* c = static_cast<unsigned int*>(counter);
  if (vec)
    norms_kernel<T, true><<<chunks, kThreads, 0, s>>>(a, b, n, chunks, pp,
                                                      c, out);
  else
    norms_kernel<T, false><<<chunks, kThreads, 0, s>>>(a, b, n, chunks, pp,
                                                       c, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int parent_norms(const void* g, const void* g_prev, int dtype, int64_t n,
                 int vec, void* partial, void* counter, float* out,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_norms<float>(g, g_prev, n, vec != 0, partial, counter,
                               out, s);
  return launch_norms<__nv_bfloat16>(g, g_prev, n, vec != 0, partial,
                                     counter, out, s);
}

int parent_norms_chunk(int dtype) {
  return dtype == 0 ? norms_chunk<float>() : norms_chunk<__nv_bfloat16>();
}

int parent_batched_norms(const float* g, const float* g_prev, int64_t C,
                         int64_t n, void* partial, void* counter, float* dg,
                         float* gg, void* stream) {
  const int64_t chunks = (n + kNormsChunk - 1) / kNormsChunk;
  batched_norms_kernel<<<dim3(static_cast<unsigned int>(chunks),
                              static_cast<unsigned int>(C)),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, g_prev, n, static_cast<int>(chunks), static_cast<float2*>(partial),
      static_cast<unsigned int*>(counter), dg, gg);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
"""


def cluster_library():
    from repro_torch.kernels import build, common
    src = build.BUILD_DIR.parent / "probe" / "norms_cluster.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(CLUSTER_SOURCE)
    lib = build.load_library("norms_cluster", [src])
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.cluster_norms_launch.argtypes = [vp, vp, i64, i64, ctypes.c_int, vp,
                                         vp, vp]
    common.raise_on(lib.cluster_norms_init(), "cluster_norms_init")
    return lib


def single_library(tk):
    from repro_torch.kernels import build
    src = build.BUILD_DIR.parent / "probe" / "norms_single.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(tk.SOURCES[0].read_text() + SINGLE_SOURCE)
    lib = build.load_library("norms_single", [src])
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.probe_norms_cluster.argtypes = [vp, vp, i32, i64, i32, vp, vp]
    lib.probe_norms_stride.argtypes = [vp, vp, i32, i64, i32, i32, vp, vp,
                                       vp, vp]
    return lib, build.library_path("norms_single", [src]).with_suffix(".log")


def parent_library():
    from repro_torch.kernels import build
    src = build.BUILD_DIR.parent / "probe" / "norms_parent.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(PARENT_SOURCE)
    lib = build.load_library("norms_parent", [src])
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.parent_norms.argtypes = [vp, vp, i32, i64, i32, vp, vp, vp, vp]
    lib.parent_norms_chunk.argtypes = [i32]
    lib.parent_batched_norms.argtypes = [vp, vp, i64, i64, vp, vp, vp, vp,
                                         vp]
    return lib


def probe_single(torch, tk, tref, lib, slib, plib, floor, device_ms):
    """norms' candidates and the wrapper at each n of SINGLE_SIZES, f32
    and bf16: one JSON line each."""
    from repro_torch.kernels import common
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = torch.empty((2,), device="cuda")
    for n in SINGLE_SIZES:
        for dtype in (torch.float32, torch.bfloat16):
            code = tk._DTYPES[dtype]
            g = torch.randn((n,), generator=gen, device="cuda").to(dtype)
            gp = torch.randn((n,), generator=gen, device="cuda").to(dtype)
            want = torch.stack(tref.norms_ref(g, gp))
            rtol = 1e-5 if dtype == torch.float32 else 3e-3

            def parent():
                chunk = plib.parent_norms_chunk(code)
                partial = torch.empty((-(-n // chunk), 2), device="cuda")
                counter = torch.zeros((1,), dtype=torch.int32,
                                      device="cuda")
                common.raise_on(plib.parent_norms(
                    g.data_ptr(), gp.data_ptr(), code, n, 1,
                    partial.data_ptr(), counter.data_ptr(), out.data_ptr(),
                    stream), "parent norms")
                return out

            def ticket(vecs):
                chunks = -(-n // tk._norms_chunk(vecs, dtype))
                partial, tickets = tk._norms_workspace(g.device, stream, 1,
                                                       chunks)
                common.raise_on(lib.dsgd_norms(
                    g.data_ptr(), gp.data_ptr(), code, n, 1, vecs, chunks,
                    partial.data_ptr(), tickets.data_ptr(), out.data_ptr(),
                    stream), "norms")
                return out

            def cluster(k):
                common.raise_on(slib.probe_norms_cluster(
                    g.data_ptr(), gp.data_ptr(), code, n, k, out.data_ptr(),
                    stream), "norms cluster")
                return out

            def stride(vecs, blocks):
                partial, tickets = tk._norms_workspace(g.device, stream, 1,
                                                       blocks)
                common.raise_on(slib.probe_norms_stride(
                    g.data_ptr(), gp.data_ptr(), code, n, vecs, blocks,
                    partial.data_ptr(), tickets.data_ptr(), out.data_ptr(),
                    stream), "norms stride")
                return out

            variants = {"(a) parent": parent}
            for vecs in sorted(tk.NORMS_VECS, reverse=True):
                variants[f"ticket grid, {vecs} loads a thread "
                         f"({-(-n // tk._norms_chunk(vecs, dtype))} "
                         "blocks)"] = lambda v=vecs: ticket(v)
            if n <= SINGLE_CLUSTER_MAX_N:
                for k in SINGLE_CLUSTERS:
                    variants[f"cluster of {k}"] = lambda k=k: cluster(k)
            if n >= SINGLE_STRIDE_MIN_N:
                for vecs, blocks in SINGLE_STRIDES:
                    variants[f"stride, {vecs} loads a thread, {blocks} "
                             "blocks"] = lambda v=vecs, b=blocks: stride(v, b)
            variants["wrapper " + str(tuple(tk.single_norms_grid(n, dtype)))
                     ] = lambda: tk.norms(g, gp)
            for name, fn in variants.items():
                a = torch.stack(list(fn())).clone()
                b = torch.stack(list(fn())).clone()
                torch.cuda.synchronize()
                if not torch.equal(a, b):
                    raise AssertionError(f"norms {name} at {n}: two calls "
                                         "differ")
                torch.testing.assert_close(a, want, rtol=rtol, atol=0.0)
            variants["launch floor"] = floor
            us = {name: [] for name in variants}
            for _ in range(ROUNDS):
                for name, fn in variants.items():
                    us[name].append(round(device_ms(fn, torch) * 1e3, 3))
            print(json.dumps({"norms": n, "dtype": str(dtype)[6:],
                              "us": us}), flush=True)
            del g, gp
            torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("norms_probe: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import device_ms, launch_floor
    from repro_torch.kernels import build, common
    from repro_torch.kernels.delta_sgd import delta_sgd as tk
    from repro_torch.kernels.delta_sgd import ref as tref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    lib = tk.library()
    clib = cluster_library()
    slib, slog = single_library(tk)
    plib = parent_library()
    floor = launch_floor(torch, build)
    log = build.library_path("delta_sgd", tk.SOURCES).with_suffix(".log")
    for path in (log, slog):
        print("\n".join(line for line in path.read_text().splitlines()
                        if "Used" in line or "spill" in line
                        or "error" in line))
    probe_single(torch, tk, tref, lib, slib, plib, floor, device_ms)
    stream = torch.cuda.current_stream().cuda_stream
    sms = common.sm_count(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for C, N in sorted(set(NORMS_SHAPES) | set(APPLY_SHAPES)):
        g = torch.randn((C, N), generator=gen, device="cuda")
        gp = torch.randn((C, N), generator=gen, device="cuda")
        p = torch.randn((C, N), generator=gen, device="cuda")
        eta = torch.rand((C,), generator=gen, device="cuda") + 0.01
        mask = (torch.rand((N,), generator=gen, device="cuda") < 0.5).float()
        dg = torch.empty((C,), device="cuda")
        gg = torch.empty((C,), device="cuda")
        work = p.clone()
        timed = {}

        if (C, N) in NORMS_SHAPES:
            want = torch.stack(tref.batched_norms_ref(g, gp))
            chunks = tk.norms_grid(C, N)
            partial, tickets = tk._norms_workspace(g.device, stream, C,
                                                   chunks)

            def cluster(k):
                common.raise_on(clib.cluster_norms_launch(
                    g.data_ptr(), gp.data_ptr(), C, N, k, dg.data_ptr(),
                    gg.data_ptr(), stream), "cluster_norms")
                return dg, gg

            def zeroed():
                tickets.zero_()
                common.raise_on(lib.dsgd_batched_norms(
                    g.data_ptr(), gp.data_ptr(), C, N, chunks,
                    partial.data_ptr(), tickets.data_ptr(), dg.data_ptr(),
                    gg.data_ptr(), stream), "batched_norms")
                return dg, gg

            variants = {f"norms cluster k {k}": (lambda k=k: cluster(k))
                        for k in CLUSTERS}
            variants["norms tickets zeroed a call"] = zeroed
            variants["norms wrapper"] = lambda: tk.batched_norms(g, gp)
            pdg, pgg = torch.empty_like(dg), torch.empty_like(gg)
            ptickets = torch.zeros((C,), dtype=torch.int32, device="cuda")

            def parent_kernel():
                common.raise_on(plib.parent_batched_norms(
                    g.data_ptr(), gp.data_ptr(), C, N, partial.data_ptr(),
                    ptickets.data_ptr(), pdg.data_ptr(), pgg.data_ptr(),
                    stream), "parent batched_norms")
                return pdg, pgg
            variants["norms parent kernel, workspace kept"] = parent_kernel
            if not torch.equal(torch.stack(tk.batched_norms(g, gp)),
                               torch.stack(parent_kernel())):
                raise AssertionError(f"batched_norms at {(C, N)}: not the "
                                     "parent kernel's bits")
            for name, fn in variants.items():
                a = torch.stack(fn())
                b = torch.stack(fn())
                torch.cuda.synchronize()
                if not torch.equal(a, b):
                    raise AssertionError(f"{name}: two calls differ")
                torch.testing.assert_close(a, want, rtol=1e-5, atol=0.0)
                timed[name] = fn

        for masked in (False, True) if (C, N) in APPLY_SHAPES else ():
            m = mask if masked else None
            ref = tref.batched_apply_ref(p, g, eta, m)
            for group in APPLY_GROUPS:
                # apply_grid's block rule for another group size
                units = -(-C // group) * (N // 4)
                streamed = units >= sms * tk.APPLY_THREADS * 4
                threads = tk.APPLY_THREADS
                while (not streamed and threads > 32
                       and -(-units // threads) < sms):
                    threads //= 2
                cap = sms * tk.APPLY_WAVES if streamed else units
                grid = tk.ApplyGrid(group, threads,
                                    min(-(-units // threads), cap), streamed)

                def apply(out, grid=grid, m=m):
                    common.raise_on(lib.dsgd_batched_apply(
                        out.data_ptr(), g.data_ptr(), eta.data_ptr(),
                        None if m is None else m.data_ptr(), C, N,
                        grid.group, grid.threads, grid.blocks,
                        int(grid.stream), stream), "batched_apply")
                    return out
                got = apply(p.clone())
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise AssertionError(f"{grid}: not bitwise plain")
                timed[f"apply masked {masked}, {tuple(grid)}"] = (
                    lambda apply=apply: apply(work))
            timed[f"apply masked {masked}, wrapper "
                  f"{tuple(tk.apply_grid(C, N, sms))}"] = (
                lambda m=m: tk.batched_apply(work, g, eta, mask=m))
        if (C, N) in APPLY_SHAPES:
            timed["torch.addcmul"] = (
                lambda: torch.addcmul(work, eta[:, None], g, value=-1))

        us = {name: [] for name in timed}
        for _ in range(ROUNDS):
            for name, fn in timed.items():
                us[name].append(round(device_ms(fn, torch) * 1e3, 3))
        print(json.dumps({"shape": [C, N], "us": us}), flush=True)
        del g, gp, p, work
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
