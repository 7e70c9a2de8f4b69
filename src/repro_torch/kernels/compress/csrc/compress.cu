// Delta-compression kernels for Hopper (sm_90a), plain C interface.
//
// All three work on the packed (C, N) client slabs of
// repro_torch.core.flat, seen as C*N/128 chunks of LANES = 128
// consecutive elements (N a multiple of 128, rows 16-byte aligned), and
// launch on the caller's stream. They allocate nothing: the Python
// wrappers in ../compress.py allocate the outputs, check dtype, shape,
// device, contiguity and alignment, and raise when a launch returns an
// error. Built without --use_fast_math: the divisions are IEEE-exact and
// nothing is contracted, so every output is bitwise equal to the plain
// PyTorch version in ../ref.py.
//
// Layout shared by the three: one warp per chunk, lane j holding the
// chunk's elements 4j..4j+3 (one 16-byte load), so the chunk's element
// order is the lane order and a warp reads 512 contiguous bytes.
//
// cmp_quantize_int8 replaces the TPU kernel _quantize_kernel
//   (repro/kernels/compress/compress.py, quantize_int8). Per chunk:
//   s = absmax/127, q = clamp(round_half_even(x * (127/absmax)), ±127).
//   Bound by bytes: it reads 4 bytes per element and writes 1 (plus one
//   f32 scale per chunk), a few flops per element. Design: the absmax is
//   a warp butterfly (__shfl_xor_sync) over a max that keeps NaN, as
//   jnp.max does (fmaxf drops it); __float2int_rn rounds half to even
//   and turns NaN into 0, as XLA's float-to-int conversion does; each
//   lane stores one char4, lane 0 the scale.
//
// cmp_dequantize_int8 replaces _dequantize_kernel (dequantize_int8):
//   q * s per chunk, char4 in, float4 out. Bound by bytes (1 byte read,
//   4 written per element).
//
// cmp_topk_mask replaces _topk_kernel (topk_mask): keeps exactly k slots
//   per chunk by |x| (ties by first index) and zeroes the rest. Bound by
//   bytes (4 read, 4 written per element); the selection is ~32 warp
//   reductions per chunk, all in registers. Design: the TPU kernel sorted
//   the chunk in VMEM; here the k-th largest |x| is found exactly by a
//   32-step radix select on the bits of |x| (non-negative floats order
//   like their uint32 bits; NaN sorts last, as in jnp.sort) with
//   __reduce_add_sync counts. The keep test then compares floats, as the
//   reference does, and ranks the elements equal to the threshold in
//   element order with a warp prefix sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kChunksPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ signed char quant(float x, float inv) {
  const int r = __float2int_rn(__fmul_rn(x, inv));
  return static_cast<signed char>(min(max(r, -127), 127));
}

__global__ void __launch_bounds__(kThreads)
quantize_int8_kernel(const float* __restrict__ x, char4* __restrict__ q,
                     float* __restrict__ s, int64_t chunks) {
  const int64_t chunk =
      static_cast<int64_t>(blockIdx.x) * kChunksPerBlock + (threadIdx.x >> 5);
  if (chunk >= chunks) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const float4 v =
      __ldcs(reinterpret_cast<const float4*>(x + chunk * kLanes) + lane);
  float m = nan_max(nan_max(fabsf(v.x), fabsf(v.y)),
                    nan_max(fabsf(v.z), fabsf(v.w)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(kFull, m, off));
  const float inv = m > 0.0f ? 127.0f / m : 0.0f;
  char4 out;
  out.x = quant(v.x, inv);
  out.y = quant(v.y, inv);
  out.z = quant(v.z, inv);
  out.w = quant(v.w, inv);
  q[chunk * (kLanes / 4) + lane] = out;
  if (lane == 0) s[chunk] = m / 127.0f;
}

__global__ void __launch_bounds__(kThreads)
dequantize_int8_kernel(const char4* __restrict__ q,
                       const float* __restrict__ s, float* __restrict__ out,
                       int64_t chunks) {
  const int64_t chunk =
      static_cast<int64_t>(blockIdx.x) * kChunksPerBlock + (threadIdx.x >> 5);
  if (chunk >= chunks) return;
  const int lane = threadIdx.x & 31;
  const char4 c = q[chunk * (kLanes / 4) + lane];
  const float sc = __ldg(s + chunk);
  float4 r;
  r.x = __fmul_rn(static_cast<float>(c.x), sc);
  r.y = __fmul_rn(static_cast<float>(c.y), sc);
  r.z = __fmul_rn(static_cast<float>(c.z), sc);
  r.w = __fmul_rn(static_cast<float>(c.w), sc);
  reinterpret_cast<float4*>(out + chunk * kLanes)[lane] = r;
}

__global__ void __launch_bounds__(kThreads)
topk_mask_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int64_t chunks, int k) {
  const int64_t chunk =
      static_cast<int64_t>(blockIdx.x) * kChunksPerBlock + (threadIdx.x >> 5);
  if (chunk >= chunks) return;
  const int lane = threadIdx.x & 31;
  const float4 v =
      __ldcs(reinterpret_cast<const float4*>(x + chunk * kLanes) + lane);
  const float xs[4] = {v.x, v.y, v.z, v.w};
  float a[4];
  unsigned bits[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = fabsf(xs[i]);
    bits[i] = __float_as_uint(a[i]);
  }

  // radix select: the bit pattern of the k-th largest |x| of the chunk
  unsigned prefix = 0u, mask = 0u;
  int remaining = k;
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned probe = 1u << bit;
    const unsigned want = prefix | probe;
    const unsigned m = mask | probe;
    unsigned c = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) c += (bits[i] & m) == want;
    c = __reduce_add_sync(kFull, c);
    if (static_cast<int>(c) >= remaining)
      prefix = want;
    else
      remaining -= static_cast<int>(c);
    mask = m;
  }
  const float thr = __uint_as_float(prefix);

  unsigned n_greater = 0u, n_eq = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    n_greater += a[i] > thr;
    n_eq += a[i] == thr;
  }
  n_greater = __reduce_add_sync(kFull, n_greater);
  // inclusive prefix sum of the per-lane counts of equal elements
  unsigned scan = n_eq;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, scan, off);
    if (lane >= off) scan += y;
  }
  int rank = static_cast<int>(scan - n_eq);  // equal elements before mine
  const int quota = k - static_cast<int>(n_greater);
  float r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bool keep = a[i] > thr;
    if (a[i] == thr) {
      ++rank;
      keep = rank <= quota;
    }
    r[i] = keep ? xs[i] : 0.0f;
  }
  reinterpret_cast<float4*>(out + chunk * kLanes)[lane] =
      make_float4(r[0], r[1], r[2], r[3]);
}

unsigned int blocks_for(int64_t chunks) {
  return static_cast<unsigned int>((chunks + kChunksPerBlock - 1) /
                                   kChunksPerBlock);
}

}  // namespace

extern "C" {

// x: (C, N) f32. q: (C, N) int8. s: (C, N / 128) f32. chunks = C*N/128.
int cmp_quantize_int8(const float* x, void* q, float* s, int64_t chunks,
                      void* stream) {
  quantize_int8_kernel<<<blocks_for(chunks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<char4*>(q), s, chunks);
  return static_cast<int>(cudaGetLastError());
}

// q: (C, N) int8. s: (C, N / 128) f32. out: (C, N) f32.
int cmp_dequantize_int8(const void* q, const float* s, float* out,
                        int64_t chunks, void* stream) {
  dequantize_int8_kernel<<<blocks_for(chunks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char4*>(q), s, out, chunks);
  return static_cast<int>(cudaGetLastError());
}

// x, out: (C, N) f32. 1 <= k <= 128 slots kept per chunk.
int cmp_topk_mask(const float* x, float* out, int64_t chunks, int k,
                  void* stream) {
  if (k < 1 || k > kLanes) return static_cast<int>(cudaErrorInvalidValue);
  topk_mask_kernel<<<blocks_for(chunks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(x, out, chunks, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
