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
//   comparisons and counts nowhere. At the cohorts of a round (C = 10 on
//   the paper task) it moves a few hundred bytes and is bound by launch
//   latency. Design: one block; the B+1 edges and B int counters live in
//   shared memory; each warp takes 32 lanes at a time and tests every bin
//   (no binary search, so edges that are not ascending give the plain
//   version's answer too) with a warp ballot, whose population count
//   lane 0 adds to the bin's shared counter: one integer atomic per warp
//   and bin, not one per lane, so a bin that most lanes fall in is not
//   a queue. Integer sums are the same in any order: the counts are
//   exact. The counters are written out as f32. The TPU kernel padded
//   the vector with NaN to a (rows, 128) tile; here lanes past C test
//   as NaN.
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
//   memory. lane_histogram 19.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHistThreads = 512;
constexpr int kMaxBins = 4096;
constexpr int kMaxQuantiles = 256;
constexpr int kMaxLanes = 1 << 17;
constexpr int kQuantTile = 2048;                // keys a block sorts
constexpr int kSortThreads = kQuantTile / 2;    // one compare-exchange each

struct QuantileIndex {
  int v[kMaxQuantiles];
};

__global__ void __launch_bounds__(kHistThreads)
lane_histogram_kernel(const float* __restrict__ x, int C,
                      const float* __restrict__ edges, int B,
                      float* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  float* e = reinterpret_cast<float*>(smem);
  int* counts = reinterpret_cast<int*>(e + B + 1);
  for (int b = threadIdx.x; b <= B; b += blockDim.x) e[b] = edges[b];
  for (int b = threadIdx.x; b < B; b += blockDim.x) counts[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  // the warp walks its lanes together, so every ballot is warp-wide
  for (int i0 = threadIdx.x - lane; i0 < C; i0 += blockDim.x) {
    const int i = i0 + lane;
    const float v = i < C ? x[i] : __int_as_float(0x7fc00000);
    for (int b = 0; b < B; ++b) {
      const unsigned int hit =
          __ballot_sync(0xffffffffu, e[b] <= v && v < e[b + 1]);
      if (lane == 0 && hit != 0u) atomicAdd(counts + b, __popc(hit));
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += blockDim.x)
    out[b] = static_cast<float>(counts[b]);
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

// x: (C,) f32. edges: (B+1,) f32. out: (B,) f32.
int tele_lane_histogram(const float* x, int C, const float* edges, int B,
                        float* out, void* stream) {
  if (B < 1 || B > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (B + 1) + sizeof(int) * B;
  lane_histogram_kernel<<<1, kHistThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(x, C, edges,
                                                               B, out);
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
