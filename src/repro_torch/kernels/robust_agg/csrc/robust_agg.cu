// Robust-aggregation kernel for Hopper (sm_90a), plain C interface.
//
// ra_trimmed_mean replaces the TPU kernel built by _make_trimmed_kernel
//   (repro/kernels/robust_agg/robust_agg.py, batched_trimmed_mean). For
//   each coordinate j of the packed (C, N) client-delta slab it sorts the
//   C values, keeps the window [t, C−t) and returns its mean; t =
//   (C−1)/2 gives the coordinate-wise median. It launches on the
//   caller's stream and allocates nothing: the wrapper in
//   ../robust_agg.py allocates the (N,) output, checks the slab and
//   raises when the launch returns an error.
//
// Bound by bytes: it reads 4·C·N bytes and writes 4·N; the sort is
//   O(C log² C) compares per coordinate, small at the cohorts the
//   scenarios give (C = 10 on the paper task, 50 in the fleet presets).
//
// Design: one thread per coordinate. For a fixed client, neighbouring
//   threads read neighbouring addresses, so every load is coalesced and
//   each input byte is read once. The thread copies its C values into
//   its own column of shared memory (column stride = block size, so a
//   warp's accesses fall in 32 different banks), pads the column to the
//   next power of two P2 with +inf and sorts it with a bitonic network.
//   No thread reads another's column, so the sort needs no barrier. The
//   TPU kernel padded a copy of the whole slab with +inf rows in HBM;
//   here the padding exists only in shared memory. The window is summed
//   in ascending order with __fadd_rn and divided by C−2t with an IEEE
//   division, so the result is the same on every call. Block size is
//   chosen so a block's columns take at most 32 KB of shared memory.
//   Inputs are finite (the round zeroes invalid clients and the Δ-SGD
//   guard sanitises NaN gradients); a NaN would not sort like jnp.sort.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxClients = 256;
constexpr int kSmemFloats = 8192;  // 32 KB of columns per block
constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
trimmed_mean_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int c_count, int p2, int t, int64_t n) {
  extern __shared__ float columns[];
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (j >= n) return;
  const int stride = blockDim.x;
  float* col = columns + threadIdx.x;
  for (int c = 0; c < c_count; ++c)
    col[c * stride] = __ldcs(x + c * n + j);
  for (int c = c_count; c < p2; ++c) col[c * stride] = INFINITY;

  for (int k = 2; k <= p2; k <<= 1) {
    for (int h = k >> 1; h > 0; h >>= 1) {
      for (int i = 0; i < p2; ++i) {
        const int l = i ^ h;
        if (l <= i) continue;
        const float a = col[i * stride];
        const float b = col[l * stride];
        const bool ascending = (i & k) == 0;
        if (ascending ? (a > b) : (a < b)) {
          col[i * stride] = b;
          col[l * stride] = a;
        }
      }
    }
  }

  float acc = 0.0f;
  for (int c = t; c < c_count - t; ++c) acc = __fadd_rn(acc, col[c * stride]);
  out[j] = acc / static_cast<float>(c_count - 2 * t);
}

}  // namespace

extern "C" {

// The largest client count the kernel is built for.
int ra_max_clients(void) { return kMaxClients; }

// x: (C, n) f32, 1 <= C <= ra_max_clients(). out: (n,) f32.
// 0 <= 2t < C.
int ra_trimmed_mean(const float* x, float* out, int64_t c_count, int64_t n,
                    int64_t t, void* stream) {
  if (c_count < 1 || c_count > kMaxClients || t < 0 || 2 * t >= c_count)
    return static_cast<int>(cudaErrorInvalidValue);
  int p2 = 1;
  while (p2 < c_count) p2 <<= 1;
  int threads = kSmemFloats / p2;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = static_cast<size_t>(p2) * threads * sizeof(float);
  const unsigned int blocks =
      static_cast<unsigned int>((n + threads - 1) / threads);
  trimmed_mean_kernel<<<blocks, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, out, static_cast<int>(c_count), p2, static_cast<int>(t), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
