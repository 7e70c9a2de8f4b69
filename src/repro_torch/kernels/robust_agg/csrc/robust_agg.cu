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
// Bound by bytes: it reads 4·C·N bytes and writes 4·N. The sort is
//   O(C log² C) compares per coordinate, which the card's min/max rate
//   keeps below the bytes' time at the cohorts the scenarios give (C =
//   10 on the paper task, 50 in the fleet presets) only if the compares
//   are all the sort costs: no loads, stores or branches beside them.
//
// Design, C <= 64 (sorted_kernel<P2>): a thread owns VEC neighbouring
//   coordinates (4 up to P2 = 16, 2 at 32, 1 at 64, so 64 values in
//   registers) and reads them from each client row with one 16-, 8- or
//   4-byte load: rows are 16-byte aligned and N is a multiple of 128,
//   and neighbouring threads read neighbouring addresses. Lanes c >= C
//   hold +inf. The values are sorted in registers by Batcher's
//   odd-even merge network on P2 = the next power of two at or above C
//   (1, 5, 19, 63, 191 and 543 compare-exchanges at P2 = 2 .. 64, against
//   a bitonic network's 1, 6, 24, 80, 240 and 672), P2 being a template
//   argument, so every compare-exchange has constant indices
//   (no register array is indexed at run time, which would put it in
//   local memory) and is a branch-free fminf/fmaxf pair; the VEC
//   networks are independent, so their compares interleave. The window
//   is summed in ascending order from +0.0 with __fadd_rn, each add
//   taken under the predicate t <= i < C−t over the constant indices,
//   and divided by C−2t with an IEEE division: the plain version's
//   arithmetic, so the result is bitwise the same. fminf may order −0.0
//   and +0.0 otherwise than torch.sort; that cannot change the sum,
//   which starts from +0.0 and so never holds −0.0. Blocks of 128
//   threads (fewer when that fills more SMs), at most as many as are
//   resident on the card at once, walk the coordinates with a
//   grid-stride loop.
//
// Design, 64 < C <= 256 (no path sends that many clients, and 128 or
//   256 values do not fit in a thread's registers): one thread per
//   coordinate copies its C values into its own column of shared memory
//   (column stride = block size, so a warp's accesses fall in 32
//   different banks), pads it to P2 with +inf and sorts it with a
//   bitonic network; the same window sum and division.
//
// Inputs are finite (the round zeroes invalid clients and the Δ-SGD
//   guard sanitises NaN gradients); a NaN would not sort like jnp.sort.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxClients = 256;
constexpr int kMaxRegisterClients = 64;
constexpr int kThreads = 128;
constexpr int kSmemFloats = 8192;  // 32 KB of columns per block
constexpr int kSmemThreads = 256;

// coordinates a thread sorts at once: 64 values in registers
template <int P2>
__host__ __device__ constexpr int vec_of() {
  return P2 <= 16 ? 4 : 64 / P2;
}

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<2> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float2 a = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = a.x;
    v[1] = a.y;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldcs(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *p = v[0];
  }
};

// One pass (p, k) of Batcher's odd-even merge sort of v[0..P2)
// ascending, for each of the VEC coordinates, then the passes after it.
// p and k are template arguments, so the two loops have constant bounds
// and unroll completely: every index is a compile-time constant (loops
// whose bounds depend on an outer loop's variable were left rolled by
// nvcc at P2 >= 8, and the array went to local memory).
// tests/test_torch_select.py builds the same network from the same loops
// and checks it by the 0-1 principle.
template <int P2, int VEC, int P, int K>
__device__ __forceinline__ void merge_pass(float (&v)[P2][VEC]) {
#pragma unroll
  for (int j = K % P; j + K < P2; j += 2 * K) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int lo = i + j, hi = i + j + K;
      if (hi < P2 && lo / (2 * P) == hi / (2 * P)) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const float a = v[lo][q], b = v[hi][q];
          v[lo][q] = fminf(a, b);
          v[hi][q] = fmaxf(a, b);
        }
      }
    }
  }
  if constexpr (K > 1)
    merge_pass<P2, VEC, P, K / 2>(v);
  else if constexpr (2 * P < P2)
    merge_pass<P2, VEC, 2 * P, 2 * P>(v);
}

template <int P2, int VEC>
__device__ __forceinline__ void odd_even_merge_sort(float (&v)[P2][VEC]) {
  merge_pass<P2, VEC, 1, 1>(v);
}

template <int P2>
__global__ void __launch_bounds__(kThreads)
sorted_kernel(const float* __restrict__ x, float* __restrict__ out,
              int c_count, int t, int64_t n) {
  constexpr int VEC = vec_of<P2>();
  const int64_t units = n / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       u < units; u += stride) {
    const float* col = x + u * VEC;
    float v[P2][VEC];
#pragma unroll
    for (int c = 0; c < P2; ++c) {
      if (c < c_count) {
        Vec<VEC>::load(col + c * n, v[c]);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) v[c][q] = INFINITY;
      }
    }
    odd_even_merge_sort<P2, VEC>(v);
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
#pragma unroll
    for (int i = 0; i < P2; ++i) {
      if (i >= t && i < c_count - t) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], v[i][q]);
      }
    }
    const float w = static_cast<float>(c_count - 2 * t);
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = acc[q] / w;
    Vec<VEC>::store(out + u * VEC, acc);
  }
}

__global__ void __launch_bounds__(kSmemThreads)
shared_kernel(const float* __restrict__ x, float* __restrict__ out,
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

template <int P2>
int launch_sorted(const float* x, float* out, int c_count, int64_t n, int t,
                  int sms, cudaStream_t stream) {
  // blocks resident on one SM, read once per instantiation
  static int resident = 0;
  if (resident == 0) {
    int r = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &r, sorted_kernel<P2>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = r > 0 ? r : 1;
  }
  const int64_t units = n / vec_of<P2>();
  // narrower blocks where 128-thread blocks would leave SMs idle
  int threads = kThreads;
  while (threads > 32 && (units + threads - 1) / threads < sms)
    threads /= 2;
  const int64_t cap = static_cast<int64_t>(sms) * resident;
  int64_t blocks = (units + threads - 1) / threads;
  if (blocks > cap) blocks = cap;
  sorted_kernel<P2><<<static_cast<unsigned int>(blocks), threads, 0,
                      stream>>>(x, out, c_count, t, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest client count the kernel is built for.
int ra_max_clients(void) { return kMaxClients; }

// x: (C, n) f32, rows 16-byte aligned, n a multiple of 128,
// 1 <= C <= ra_max_clients(). out: (n,) f32. 0 <= 2t < C. sms: the
// device's SM count, which sizes the grid.
int ra_trimmed_mean(const float* x, float* out, int64_t c_count, int64_t n,
                    int64_t t, int sms, void* stream) {
  if (c_count < 1 || c_count > kMaxClients || t < 0 || 2 * t >= c_count ||
      n % 128 != 0 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int c = static_cast<int>(c_count), tt = static_cast<int>(t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (c <= 2) return launch_sorted<2>(x, out, c, n, tt, sms, s);
  if (c <= 4) return launch_sorted<4>(x, out, c, n, tt, sms, s);
  if (c <= 8) return launch_sorted<8>(x, out, c, n, tt, sms, s);
  if (c <= 16) return launch_sorted<16>(x, out, c, n, tt, sms, s);
  if (c <= 32) return launch_sorted<32>(x, out, c, n, tt, sms, s);
  if (c <= kMaxRegisterClients)
    return launch_sorted<64>(x, out, c, n, tt, sms, s);
  int p2 = 1;
  while (p2 < c) p2 <<= 1;
  int threads = kSmemFloats / p2;
  if (threads > kSmemThreads) threads = kSmemThreads;
  const size_t smem = static_cast<size_t>(p2) * threads * sizeof(float);
  const unsigned int blocks =
      static_cast<unsigned int>((n + threads - 1) / threads);
  shared_kernel<<<blocks, threads, smem, s>>>(x, out, c, p2, tt, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
