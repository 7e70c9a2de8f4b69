// Telemetry kernels for Hopper (sm_90a), plain C interface.
//
// Both reduce a per-client (C,) f32 vector (round-end Δ-SGD step sizes,
// per-client mean losses) to a fixed-shape summary, once per round. They
// launch on the caller's stream and allocate nothing: the wrappers in
// ../telemetry.py allocate the outputs, check device, dtype and shape,
// and raise when a launch returns an error.
//
// tele_lane_histogram replaces the TPU kernel _hist_kernel
//   (repro/kernels/telemetry/telemetry.py, lane_histogram). Bin b counts
//   the lanes with edges[b] <= x < edges[b+1]; NaN fails both
//   comparisons and counts nowhere. Bound on this card by instructions
//   and latency, not bytes (100,000 lanes are 400 KB). Each lane is
//   compared with every EDGE, not every bin: G(e) counts the lanes with
//   x >= e (one compare and one add a lane and edge), and bin b holds
//   G(edges[b]) - G(edges[b+1]) where edges[b] <= edges[b+1], else 0.
//   That is exact for any edges: for lo <= hi, {lo <= x < hi} is
//   {x >= lo} less {x >= hi}, which it contains; for lo > hi, or a NaN
//   edge, no lane is in the bin. So edges that are not ascending give
//   the plain version's answer, and there is no binary search. A warp
//   holds V lanes a thread in registers; for each edge it counts them
//   with a ballot (V = 1) or a per-thread sum and one warp sum
//   (__reduce_add_sync), and the lane that owns the edge (lane l owns
//   edges l, l + 32, l + 64, l + 96 of a tile of 128) keeps the count in
//   a register, so a bin that most lanes fall in is no queue of atomics.
//   The counts are integers, so every design and order gives the same
//   bits. Two paths, picked by hist_grid in ../telemetry.py:
//   - up to HIST_WARP_LANES (128) lanes (the paper's cohort, C = 10):
//     one warp. x (V = 1 or 4 lanes a thread) and the owned edges are
//     loaded together, with no shared memory and no barrier; tiles of
//     128 edges 127 bins apart put both edges of every bin in one tile,
//     and each bin's owner reads its upper edge's count from the next
//     lane. From 256 lanes one block of the grid path is as fast as a
//     warp holding 16 lanes a thread (7.49-7.58 against 7.44-7.49 µs).
//   - more lanes: a grid of up to a block an SM (one for every 4,096
//     lanes) of 512 threads, 8 lanes a thread a sweep, the next sweep's
//     lanes loaded while this one is counted. Each warp adds its edge
//     counts to its block's B + 1 shared counters (one atomic a warp and
//     edge). One block writes the bins from them; more write them to a
//     workspace, edge-major, and the last block to take an integer
//     ticket (after __threadfence) sums them, a warp an edge, writes the
//     f32 bins and puts the ticket back to zero. The wrapper keeps the
//     workspace per (device, stream), its ticket zeroed once when made,
//     so a call is one device op.
//   The parent ran one block of 512 threads on one SM, staged the edges
//   and zeroed the counters before a barrier, then took one ballot and
//   one shared atomic a warp and bin (43.78 µs at 16,384 lanes, against
//   24.54 for the plain version). A thread-block cluster of up to 8
//   blocks that gathers the counts in block 0's shared memory over
//   distributed shared memory (no workspace, no ticket) was faster at
//   16,384 lanes (8.5 against 9.7 µs) and slower at 1,000 (8.6 against
//   7.7) and at 100,000 (14.7 against 10.0), where 8 SMs count what the
//   grid spreads over 25 (scripts/hist_quant_probe.py, H100 SXM, 700 W).
//   No stack frame or spill (ptxas -v, sm_90a, CUDA 12.8; chip_smoke.py
//   phase 2 checks it).
//
// tele_lane_quantiles replaces the TPU kernel _quantile_kernel
//   (lane_quantiles). It orders the C values and writes the entries at
//   the Q sorted positions it is given by value (the nearest-rank
//   indices, computed on the host from C and Q: no host-to-device copy
//   per call). Each lane becomes a 64-bit key: the order-preserving bits
//   of its canonical value (every zero +0.0, every NaN the same NaN, so
//   NaN sorts after +inf) above its lane index, so the keys are unique,
//   their order is total and equals a stable sort: jnp.sort's order.
//   The output reads the original value of the lane, so −0.0 and NaN
//   keep their bits. Bound on this card by the sort's shared-memory
//   steps and barriers, not by bytes (C = 16,384 moves 64 KB).
//   Design, by size:
//   - C <= kQuantTile (2,048): one block sorts the keys, padded to a
//     power of two with all-ones keys (which sort after every lane; the
//     TPU kernel padded with +inf, which sorts before NaN lanes), with a
//     bitonic network in shared memory, one compare-exchange per thread
//     and step, and reads the Q positions. The telemetry path's cohort
//     (C = 10) takes this path.
//   - larger C, two launches: (1) ⌈C / 2,048⌉ blocks each sort one tile
//     of keys the same way and write it to a scratch buffer the wrapper
//     allocates; (2) one block per tile, two keys a thread: each thread
//     counts, for each other tile, the keys below its own by a binary
//     search of that tile, staged whole in shared memory (one 16-byte
//     load a thread, the next tile in registers while this one is
//     searched). The key's global rank is those counts plus its place in
//     its own tile; the keys are unique, so the ranks are a permutation,
//     and the thread whose rank is a requested position writes that
//     output. No atomics: every output is written by one thread, the
//     same bits on every run. Sorting all of a large C in one block
//     would leave every other SM idle. The work of (2) grows as
//     C² / 2,048, so C is capped at 2^17. C is the per-round cohort: the
//     CNN paths send 10 lanes and the fleet presets 50 (10^5 registered
//     clients at participation 0.0005), so no path of the port or the
//     reference sends more than 2,048 today. This path lifts the port's
//     earlier 2^14 cap toward the reference kernel's any C, and is held
//     bit for bit at 16,385 and 100,000 lanes on the card.
//   Registers (ptxas -v, sm_90a, CUDA 12.8), no spills: one-block sort
//   18, tile sort 18, select 30; 16 KB and 32 KB of static shared
//   memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBins = 4096;
constexpr int kRegEdges = 4;                    // edges a lane owns a tile
constexpr int kTileEdges = 32 * kRegEdges;      // edges a warp counts at once
constexpr int kEdgeRun = 8;                     // edges counted unbranched
constexpr int kWarpMaxLanes = 32 * 4;           // the one-warp path's most
constexpr int kHistThreads = 512;               // a grid block's threads
constexpr int kHistPerThread = 8;               // lanes a thread a sweep
constexpr int kHistBlockLanes = kHistThreads * kHistPerThread;
constexpr int kMaxQuantiles = 256;
constexpr int kMaxLanes = 1 << 17;
constexpr int kQuantTile = 2048;                // keys a block sorts
constexpr int kSortThreads = kQuantTile / 2;    // one compare-exchange each

struct QuantileIndex {
  int v[kMaxQuantiles];
};

// How many of the warp's lanes v[0..V) (absent lanes NaN) are >= e.
template <int V>
__device__ __forceinline__ int warp_at_or_above(const float (&v)[V],
                                                float e) {
  if constexpr (V == 1) {
    return __popc(__ballot_sync(kFull, v[0] >= e));
  } else {
    int n = 0;
#pragma unroll
    for (int k = 0; k < V; ++k) n += v[k] >= e;
    return __reduce_add_sync(kFull, n);
  }
}

// Adds to g[j] of lane l the warp's lanes at or above edge e[j] of lane
// l, the tile's edge 32 j + l, for each of the tile's ne edges. Edges
// go in straight runs of kEdgeRun with no branch between them, so their
// warp sums overlap; an edge past B is NaN and counts no lane.
template <int V>
__device__ __forceinline__ void count_tile(const float (&v)[V],
                                           const float (&e)[kRegEdges],
                                           int ne, int lane,
                                           int (&g)[kRegEdges]) {
#pragma unroll
  for (int j = 0; j < kRegEdges; ++j) {
#pragma unroll
    for (int r = 0; r < 32; r += kEdgeRun) {
      if (32 * j + r >= ne) return;   // the same for the whole warp
#pragma unroll
      for (int l = r; l < r + kEdgeRun; ++l) {
        const int n = warp_at_or_above<V>(v, __shfl_sync(kFull, e[j], l));
        if (lane == l) g[j] += n;
      }
    }
  }
}

// Edge `first + 32 j + lane` of each slot j, NaN past edge B.
__device__ __forceinline__ void load_edges(const float* __restrict__ edges,
                                           int B, int first, int lane,
                                           float (&e)[kRegEdges]) {
#pragma unroll
  for (int j = 0; j < kRegEdges; ++j) {
    const int i = first + 32 * j + lane;
    e[j] = i <= B ? edges[i] : __int_as_float(0x7fc00000);
  }
}

// The one-warp path: lane l holds lanes 32 k + l (k < V) of x.
template <int V>
__global__ void __launch_bounds__(32)
hist_warp_kernel(const float* __restrict__ x, int C,
                 const float* __restrict__ edges, int B,
                 float* __restrict__ out) {
  const int lane = threadIdx.x;
  float v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int i = 32 * k + lane;
    v[k] = i < C ? x[i] : __int_as_float(0x7fc00000);
  }
  // tiles of kTileEdges edges, kTileEdges - 1 bins apart
  for (int first = 0; first < B; first += kTileEdges - 1) {
    float e[kRegEdges];
    int g[kRegEdges] = {};
    load_edges(edges, B, first, lane, e);
    count_tile<V>(v, e, min(kTileEdges, B + 1 - first), lane, g);
#pragma unroll
    for (int j = 0; j < kRegEdges; ++j) {
      // bin first + 32 j + lane: its upper edge is the next lane's, or
      // lane 0's of the next slot for lane 31
      const int jn = (j + 1) % kRegEdges;
      const int g_up = __shfl_down_sync(kFull, g[j], 1);
      const float e_up = __shfl_down_sync(kFull, e[j], 1);
      const int g_wrap = __shfl_sync(kFull, g[jn], 0);
      const float e_wrap = __shfl_sync(kFull, e[jn], 0);
      const int t = 32 * j + lane;
      if (t < kTileEdges - 1 && first + t < B) {
        const int g_hi = lane == 31 ? g_wrap : g_up;
        const float e_hi = lane == 31 ? e_wrap : e_up;
        out[first + t] = e[j] <= e_hi ? static_cast<float>(g[j] - g_hi)
                                      : 0.0f;
      }
    }
  }
}

// Lanes s0 + m * kHistThreads + threadIdx.x (m < kHistPerThread) of x,
// NaN past C.
__device__ __forceinline__ void load_sweep(const float* __restrict__ x,
                                           int C, int s0,
                                           float (&v)[kHistPerThread]) {
#pragma unroll
  for (int m = 0; m < kHistPerThread; ++m) {
    const int i = s0 + m * kHistThreads + threadIdx.x;
    v[m] = i < C ? x[i] : __int_as_float(0x7fc00000);
  }
}

// The grid path: block r of k takes sweeps of k * kHistBlockLanes lanes,
// its own kHistBlockLanes of each, and leaves its B + 1 edge counts in
// partial[e * k + r]; the last block to take a ticket sums them, writes
// the f32 bins and puts the ticket back to zero for the next call. A
// grid of one block writes its bins from its own counts.
__global__ void __launch_bounds__(kHistThreads)
hist_grid_kernel(const float* __restrict__ x, int C,
                 const float* __restrict__ edges, int B,
                 int* __restrict__ partial, unsigned int* __restrict__ ticket,
                 float* __restrict__ out) {
  extern __shared__ int total[];                // B + 1 edge counts
  __shared__ bool last;
  const int k = static_cast<int>(gridDim.x);
  const int rank = static_cast<int>(blockIdx.x);
  const int stride = k * kHistBlockLanes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s_first = rank * kHistBlockLanes;
  float cur[kHistPerThread];
  load_sweep(x, C, s_first, cur);
  // the bins of the end, loaded now
  const int b0 = threadIdx.x;
  const float lo0 = b0 < B ? edges[b0] : 0.0f;
  const float hi0 = b0 < B ? edges[b0 + 1] : 0.0f;
  for (int i = threadIdx.x; i <= B; i += kHistThreads) total[i] = 0;
  __syncthreads();
  for (int first = 0; first <= B; first += kTileEdges) {
    if (first > 0) load_sweep(x, C, s_first, cur);
    float e[kRegEdges];
    int g[kRegEdges] = {};
    load_edges(edges, B, first, lane, e);
    const int ne = min(kTileEdges, B + 1 - first);
    for (int s0 = s_first; s0 < C; s0 += stride) {   // uniform
      float next[kHistPerThread];
      load_sweep(x, C, s0 + stride, next);          // in flight
      count_tile<kHistPerThread>(cur, e, ne, lane, g);
#pragma unroll
      for (int m = 0; m < kHistPerThread; ++m) cur[m] = next[m];
    }
#pragma unroll
    for (int j = 0; j < kRegEdges; ++j) {
      const int i = first + 32 * j + lane;
      if (i <= B && g[j] != 0) atomicAdd(total + i, g[j]);
    }
  }
  __syncthreads();
  if (k > 1) {
    for (int i = threadIdx.x; i <= B; i += kHistThreads)
      partial[i * k + rank] = total[i];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == k - 1u;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // warp w sums edges w, w + 16, ... over the k blocks
    for (int i = warp; i <= B; i += kHistThreads / 32) {
      int n = 0;
#pragma unroll 4
      for (int r = lane; r < k; r += 32) n += __ldcg(partial + i * k + r);
      n = __reduce_add_sync(kFull, n);
      if (lane == 0) total[i] = n;
    }
    __syncthreads();
    if (threadIdx.x == 0) *ticket = 0u;
  }
  for (int b = b0; b < B; b += kHistThreads) {
    const float lo = b == b0 ? lo0 : edges[b];
    const float hi = b == b0 ? hi0 : edges[b + 1];
    out[b] = lo <= hi ? static_cast<float>(total[b] - total[b + 1]) : 0.0f;
  }
}

// Order-preserving unsigned image of a float's canonical value: every
// zero maps to +0.0's image and every NaN to one image above +inf's.
__device__ __forceinline__ uint32_t ordered_bits(float v) {
  if (isnan(v)) return 0xffc00000u;  // the image of +NaN (0x7fc00000)
  if (v == 0.0f) return 0x80000000u;  // the image of +0.0
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long lane_key(
    const float* __restrict__ x, int i, int C) {
  return i < C ? (static_cast<unsigned long long>(ordered_bits(x[i])) << 32) |
                     static_cast<unsigned int>(i)
               : ~0ull;
}

// Sorts P keys (a power of two) ascending in shared memory; the block's
// threads take the P / 2 compare-exchanges of a step between them.
__device__ void bitonic_sort(unsigned long long* keys, int P) {
  const int half = P >> 1;
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        // pair (lo, lo + j): lo has bit j clear
        const int lo = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int hi = lo + j;
        const bool ascending = (lo & k) == 0;
        const unsigned long long a = keys[lo];
        const unsigned long long b = keys[hi];
        if ((a > b) == ascending) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// C <= kQuantTile: one block sorts every key and reads the Q positions.
__global__ void __launch_bounds__(kSortThreads)
lane_quantiles_kernel(const float* __restrict__ x, int C, int P,
                      QuantileIndex idx, int Q, float* __restrict__ out) {
  __shared__ unsigned long long keys[kQuantTile];
  for (int i = threadIdx.x; i < P; i += blockDim.x) keys[i] = lane_key(x, i, C);
  __syncthreads();
  bitonic_sort(keys, P);
  if (threadIdx.x < Q) {
    const unsigned int lane =
        static_cast<unsigned int>(keys[idx.v[threadIdx.x]] & 0xffffffffu);
    out[threadIdx.x] = x[lane];
  }
}

// Launch 1 of a larger C: block b sorts lanes [b·T, b·T + T), padded with
// all-ones keys, into sorted[b·T, b·T + T).
__global__ void __launch_bounds__(kSortThreads)
quantile_tile_sort_kernel(const float* __restrict__ x, int C,
                          unsigned long long* __restrict__ sorted) {
  __shared__ unsigned long long keys[kQuantTile];
  const int base = blockIdx.x * kQuantTile;
  for (int i = threadIdx.x; i < kQuantTile; i += blockDim.x)
    keys[i] = lane_key(x, base + i, C);
  __syncthreads();
  bitonic_sort(keys, kQuantTile);
  for (int i = threadIdx.x; i < kQuantTile; i += blockDim.x)
    sorted[base + i] = keys[i];
}

// The number of the kQuantTile sorted keys s[] below key.
__device__ __forceinline__ int keys_below(const unsigned long long* s,
                                          unsigned long long key) {
  int pos = 0;
#pragma unroll
  for (int step = kQuantTile >> 1; step > 0; step >>= 1)
    if (s[pos + step - 1] < key) pos += step;
  return pos + (s[pos] < key ? 1 : 0);
}

// Launch 2: block b ranks the keys of sorted tile b against every other
// tile; the thread whose key has a requested rank writes that output.
__global__ void __launch_bounds__(kSortThreads)
quantile_select_kernel(const float* __restrict__ x,
                       const unsigned long long* __restrict__ sorted,
                       int tiles, QuantileIndex idx, int Q,
                       float* __restrict__ out) {
  __shared__ __align__(16) unsigned long long stage[2][kQuantTile];
  const int own = blockIdx.x;
  const int t = threadIdx.x;
  const unsigned long long key0 = sorted[own * kQuantTile + t];
  const unsigned long long key1 = sorted[own * kQuantTile + t + kSortThreads];
  int rank0 = t, rank1 = t + kSortThreads;    // places in the own tile
  // each thread moves 16 bytes of a tile: kSortThreads · 16 = 16 KB
  const ulonglong2* src = reinterpret_cast<const ulonglong2*>(sorted);
  int j = own == 0 ? 1 : 0;
  ulonglong2 next = make_ulonglong2(0ull, 0ull);
  if (j < tiles) next = src[j * kSortThreads + t];
  for (int buf = 0; j < tiles; buf ^= 1) {
    reinterpret_cast<ulonglong2*>(stage[buf])[t] = next;
    __syncthreads();
    int jn = j + 1;
    if (jn == own) ++jn;
    if (jn < tiles) next = src[jn * kSortThreads + t];   // in flight
    rank0 += keys_below(stage[buf], key0);
    rank1 += keys_below(stage[buf], key1);
    j = jn;
  }
  for (int q = 0; q < Q; ++q) {
    if (key0 != ~0ull && rank0 == idx.v[q])
      out[q] = x[static_cast<unsigned int>(key0 & 0xffffffffu)];
    if (key1 != ~0ull && rank1 == idx.v[q])
      out[q] = x[static_cast<unsigned int>(key1 & 0xffffffffu)];
  }
}

}  // namespace

extern "C" {

int tele_max_bins(void) { return kMaxBins; }
int tele_max_quantiles(void) { return kMaxQuantiles; }
int tele_max_lanes(void) { return kMaxLanes; }
int tele_quantile_tile(void) { return kQuantTile; }

int tele_hist_warp_max_lanes(void) { return kWarpMaxLanes; }
int tele_hist_block_lanes(void) { return kHistBlockLanes; }

// x: (C,) f32. edges: (B+1,) f32. out: (B,) f32. blocks == 0: the
// one-warp path, per_thread = V in {1, 4} lanes a thread, C <= 32 V;
// else a grid of blocks blocks, per_thread == kHistPerThread, and past
// one block partial: (B + 1) * blocks ints and ticket: one zero int that
// the call leaves at zero (hist_grid and the workspace in
// ../telemetry.py).
int tele_lane_histogram(const float* x, int C, const float* edges, int B,
                        int blocks, int per_thread, int* partial,
                        unsigned int* ticket, float* out, void* stream) {
  if (B < 1 || B > kMaxBins || C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks == 0) {
    if (C > 32 * per_thread) return static_cast<int>(cudaErrorInvalidValue);
    if (per_thread == 1)
      hist_warp_kernel<1><<<1, 32, 0, st>>>(x, C, edges, B, out);
    else if (per_thread == 4)
      hist_warp_kernel<4><<<1, 32, 0, st>>>(x, C, edges, B, out);
    else
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
  }
  if (blocks < 1 || blocks > 65535 || per_thread != kHistPerThread ||
      (blocks > 1 && (partial == nullptr || ticket == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  hist_grid_kernel<<<blocks, kHistThreads,
                     sizeof(int) * static_cast<size_t>(B + 1), st>>>(
      x, C, edges, B, partial, ticket, out);
  return static_cast<int>(cudaGetLastError());
}

// x: (C,) f32, 1 <= C <= 2^17. idx: Q host ints in [0, C), passed to the
// kernels by value. out: (Q,) f32. scratch: ⌈C / kQuantTile⌉ · kQuantTile
// 64-bit keys when C > kQuantTile (both launches go on the stream in
// order), else unused and may be null.
int tele_lane_quantiles(const float* x, int C, const int* idx, int Q,
                        void* scratch, float* out, void* stream) {
  if (C < 1 || C > kMaxLanes || Q < 1 || Q > kMaxQuantiles)
    return static_cast<int>(cudaErrorInvalidValue);
  QuantileIndex qi;
  for (int q = 0; q < Q; ++q) qi.v[q] = idx[q];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= kQuantTile) {
    int P = 2;
    while (P < C) P <<= 1;
    int threads = P / 2 < kSortThreads ? P / 2 : kSortThreads;
    if (threads < Q) threads = Q;
    threads = (threads + 31) / 32 * 32;
    lane_quantiles_kernel<<<1, threads, 0, st>>>(x, C, P, qi, Q, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  unsigned long long* sorted = static_cast<unsigned long long*>(scratch);
  const int tiles = (C + kQuantTile - 1) / kQuantTile;
  quantile_tile_sort_kernel<<<tiles, kSortThreads, 0, st>>>(x, C, sorted);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quantile_select_kernel<<<tiles, kSortThreads, 0, st>>>(x, sorted, tiles,
                                                          qi, Q, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
