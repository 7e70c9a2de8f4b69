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
//   (lane_quantiles). It sorts the C values and writes the entries at
//   the Q sorted positions it is given by value (the nearest-rank
//   indices, computed on the host from C and Q: no host-to-device copy
//   per call). Design: one block; each lane becomes a 64-bit key in
//   dynamic shared memory, the order-preserving bits of its canonical
//   value (every zero +0.0, every NaN the same NaN, so NaN sorts after
//   +inf) above its lane index, so the key order is total and equals a
//   stable sort: jnp.sort's order. The keys are padded to a power of two
//   with all-ones keys, which sort after every lane (the TPU kernel
//   padded with +inf, which sorts before NaN lanes), and sorted with a
//   bitonic network, one compare-exchange per thread and step. The
//   output reads the original value of the lane, so −0.0 and NaN keep
//   their bits. 2^14 lanes take 128 KB of keys: the block opts in to
//   more than 48 KB of dynamic shared memory. Bound by the sort's
//   O(C log² C) shared-memory steps and their barriers, not by bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHistThreads = 512;
constexpr int kMaxBins = 4096;
constexpr int kMaxQuantiles = 256;
constexpr int kMaxLanesLog2 = 14;
constexpr int kMaxLanes = 1 << kMaxLanesLog2;
constexpr int kSortThreads = 1024;

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

__global__ void __launch_bounds__(kSortThreads)
lane_quantiles_kernel(const float* __restrict__ x, int C, int P,
                      QuantileIndex idx, int Q, float* __restrict__ out) {
  extern __shared__ unsigned long long keys[];
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    keys[i] = i < C ? (static_cast<unsigned long long>(ordered_bits(x[i]))
                       << 32) | static_cast<unsigned int>(i)
                    : ~0ull;
  __syncthreads();
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
  if (threadIdx.x < Q) {
    const unsigned int lane =
        static_cast<unsigned int>(keys[idx.v[threadIdx.x]] & 0xffffffffu);
    out[threadIdx.x] = x[lane];
  }
}

}  // namespace

extern "C" {

int tele_max_bins(void) { return kMaxBins; }
int tele_max_quantiles(void) { return kMaxQuantiles; }
int tele_max_lanes(void) { return kMaxLanes; }

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

// x: (C,) f32, 1 <= C <= 2^14. idx: Q host ints in [0, C), passed to the
// kernel by value. out: (Q,) f32.
int tele_lane_quantiles(const float* x, int C, const int* idx, int Q,
                        float* out, void* stream) {
  if (C < 1 || C > kMaxLanes || Q < 1 || Q > kMaxQuantiles)
    return static_cast<int>(cudaErrorInvalidValue);
  QuantileIndex qi;
  for (int q = 0; q < Q; ++q) qi.v[q] = idx[q];
  int P = 2;
  while (P < C) P <<= 1;
  const size_t smem = sizeof(unsigned long long) * P;
  // opt in once to the most shared memory any C can ask for
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        lane_quantiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(unsigned long long) * kMaxLanes));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  int threads = P / 2 < kSortThreads ? P / 2 : kSortThreads;
  if (threads < Q) threads = Q;
  threads = (threads + 31) / 32 * 32;
  lane_quantiles_kernel<<<1, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(x, C, P, qi,
                                                               Q, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
