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
// Layout of dequantize_int8 and topk_mask: one warp per chunk, lane j
// holding the chunk's elements 4j..4j+3, so the chunk's element order is
// the lane order and a warp reads (top-k) or writes 512 contiguous
// bytes.
//
// cmp_quantize_int8 replaces the TPU kernel _quantize_kernel
//   (repro/kernels/compress/compress.py, quantize_int8). Per chunk:
//   s = absmax/127, q = clamp(round_half_even(x * (127/absmax)), ±127).
//   Bound by bytes: it reads 4 bytes per element and writes 1 (plus one
//   f32 scale per chunk), a few flops per element. Design: a chunk is
//   spread over 8 lanes, lane j of the group holding its 16-byte pieces
//   j, j + 8, j + 16 and j + 24 (four loads, each instruction of the
//   warp reading whole 128-byte lines), so a warp takes 4 consecutive
//   chunks, 2 KB, its one step (quantize_grid in ../compress.py). The
//   absmax is a 3-step __shfl_xor_sync butterfly of width 8 over a max
//   that keeps NaN, as jnp.max does (fmaxf drops it); max is exact, so
//   the tree changes no finite scale. Each lane stores its pieces as
//   four 4-byte words (8 lanes write 32 contiguous bytes), and lane 0
//   the step's 4 contiguous scales as one 16-byte store. __float2int_rn
//   rounds half to even and turns NaN into 0, as XLA's float-to-int
//   conversion does; 127/absmax and absmax/127 are true divisions. The
//   parent gave each warp one chunk (one 16-byte load a lane, a 5-step
//   butterfly, a 4-byte scale store from lane 0): 292.5 against 284.5 µs
//   at (10, 2^24). A grid sized to the SMs whose warps walk their steps,
//   loading the next before reducing this one, was 4 % slower there, and
//   16 contiguous elements a lane with one 16-byte store 1 % slower
//   (scripts/hist_quant_probe.py, H100 SXM, 700 W).
//
// cmp_dequantize_int8 replaces _dequantize_kernel (dequantize_int8):
//   out = q * s per chunk, each product rounded by __fmul_rn (bitwise the
//   plain version's, NaN and inf scales too). Bound by bytes: it reads 1
//   byte per element (plus one f32 scale per chunk) and writes 4. Design:
//   a warp a chunk, lane j its 4-byte piece j (one char4 load, one
//   float4 store: each store instruction writes the chunk's 512 bytes
//   in one piece), 8 chunks a block (dequantize_grid in ../compress.py),
//   the stores evict-first (__stcs): at (10, 2^20), where the output
//   passes the L2, they took the parent's 23.3 µs to 20.6, and they
//   measured level with plain stores at every other shape from the
//   paper's width to 2^24. More bytes in flight a thread measured
//   slower at every shape, with the writes 4x the reads: 8 lanes a
//   chunk holding pieces j + 8m (2-3 % at (10, 2^24)), 16 contiguous
//   int8 a lane with four strided stores (76 %), 2 or 4 chunks a warp
//   (1-2 %), and 16 bytes a lane shuffled so each store writes a chunk
//   whole (1 %) (scripts/hist_quant_probe.py, H100 SXM, 700 W).
//
// cmp_topk_mask replaces _topk_kernel (topk_mask): keeps exactly k slots
//   per chunk by |x| (ties by first index) and zeroes the rest; NaN sorts
//   last (largest), as in jnp.sort and torch.sort. Bound by bytes (4 read,
//   4 written per element) once the select costs a few integer and float
//   operations per element. Design: the TPU kernel sorted the chunk in
//   VMEM; here the k-th largest |x| is found exactly by a binary search on
//   its bit pattern (non-negative floats order like their uint32 bits),
//   all in registers, one warp-uniform step per bit:
//   - the NaN lanes are counted once; if k or more, the threshold is NaN
//     and, as in the plain version, no slot is kept;
//   - the largest and smallest non-NaN |x| (fmaxf/fminf drop NaN, then
//     __reduce_max_sync/__reduce_min_sync on the bits) share their bits
//     above the highest bit where they differ: the search starts there,
//     so a constant or all-zero chunk takes no step at all;
//   - a step probes T = prefix | bit and counts |x| >= T with one float
//     compare and one add per element (a NaN compares false and is
//     counted apart; denormals are compared exactly, the build has no
//     --use_fast_math), then one __reduce_add_sync; T becomes the prefix
//     when k or more lie at or above it;
//   - it stops as soon as exactly k lie at or above the prefix: the
//     threshold is then the least of them, one __reduce_min_sync.
//   The keep test then compares floats, as the reference does. Only when
//   more elements equal the threshold than slots are left does it rank
//   them in element order, with a warp prefix sum. The parent's 32-pass
//   radix select (and + compare + add per element a pass), the same
//   passes stopping early, ballot counts, two bits a step, set.ge
//   counts, integer counts on the bits (1.7 % faster at 2^24, but NaN
//   then counts only while the probe stays at or below +inf's bits),
//   the tie scan on every chunk, and a grid of resident warps that each
//   walk many chunks, loading the next before selecting in the current
//   one, were measured beside it (scripts/topk_probe.py).

#include <cuda_runtime.h>
#include <math.h>
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

// quantize_int8: lanes a chunk, chunks a warp step
constexpr int kQuantGroup = 8;
constexpr int kQuantStep = 32 / kQuantGroup;

__device__ __forceinline__ unsigned int quant4(const float4 v, float inv) {
  return static_cast<unsigned char>(quant(v.x, inv)) |
         static_cast<unsigned int>(static_cast<unsigned char>(
             quant(v.y, inv))) << 8 |
         static_cast<unsigned int>(static_cast<unsigned char>(
             quant(v.z, inv))) << 16 |
         static_cast<unsigned int>(static_cast<unsigned char>(
             quant(v.w, inv))) << 24;
}

// Warp w takes chunks 4w..4w+3; lane (group, j) the 16-byte pieces
// j + 8m (m < 4) of chunk 4w + group.
__global__ void __launch_bounds__(kThreads)
quantize_int8_kernel(const float* __restrict__ x,
                     unsigned int* __restrict__ q, float* __restrict__ s,
                     int64_t chunks) {
  const int lane = threadIdx.x & 31;
  const int j = lane & (kQuantGroup - 1);
  const int64_t c0 =
      (static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
       (threadIdx.x >> 5)) * kQuantStep;
  if (c0 >= chunks) return;   // whole warps leave together
  const int64_t chunk = c0 + (lane >> 3);
  const bool live = chunk < chunks;
  const float4* src = reinterpret_cast<const float4*>(x + chunk * kLanes) + j;
  float4 v[4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
    v[m] = live ? __ldcs(src + kQuantGroup * m)
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float a = 0.0f;
#pragma unroll
  for (int m = 0; m < 4; ++m)
    a = nan_max(a, nan_max(nan_max(fabsf(v[m].x), fabsf(v[m].y)),
                           nan_max(fabsf(v[m].z), fabsf(v[m].w))));
#pragma unroll
  for (int off = kQuantGroup / 2; off > 0; off >>= 1)
    a = nan_max(a, __shfl_xor_sync(kFull, a, off));
  const float inv = a > 0.0f ? 127.0f / a : 0.0f;
  const float sc = a / 127.0f;
  if (live) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
      q[chunk * (kLanes / 4) + j + kQuantGroup * m] = quant4(v[m], inv);
  }
  // the step's scales, one from each group, to lane 0
  const float s1 = __shfl_sync(kFull, sc, 8);
  const float s2 = __shfl_sync(kFull, sc, 16);
  const float s3 = __shfl_sync(kFull, sc, 24);
  if (lane == 0) {
    if (c0 + kQuantStep <= chunks) {
      *reinterpret_cast<float4*>(s + c0) = make_float4(sc, s1, s2, s3);
    } else {   // the ragged last step: 1 to 3 chunks
      s[c0] = sc;
      if (c0 + 1 < chunks) s[c0 + 1] = s1;
      if (c0 + 2 < chunks) s[c0 + 2] = s2;
    }
  }
}

// dequantize_int8: chunks a warp
constexpr int kDequantStep = 1;

// Warp w takes chunk w: lane j its char4 j (elements 4j..4j+3) and their
// 16-byte product, stored evict-first.
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
  __stcs(reinterpret_cast<float4*>(out + chunk * kLanes) + lane,
         make_float4(__fmul_rn(static_cast<float>(c.x), sc),
                     __fmul_rn(static_cast<float>(c.y), sc),
                     __fmul_rn(static_cast<float>(c.z), sc),
                     __fmul_rn(static_cast<float>(c.w), sc)));
}

__global__ void __launch_bounds__(kThreads)
topk_mask_kernel(const float* __restrict__ x, float* __restrict__ out,
                 int64_t chunks, int k) {
  const int64_t chunk =
      static_cast<int64_t>(blockIdx.x) * kChunksPerBlock + (threadIdx.x >> 5);
  if (chunk >= chunks) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const float4 v =
      __ldcs(reinterpret_cast<const float4*>(x + chunk * kLanes) + lane);
  const float xs[4] = {v.x, v.y, v.z, v.w};
  float a[4];
  int nan = 0;
  float top = 0.0f, bottom = INFINITY;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = fabsf(xs[i]);
    nan += a[i] != a[i];
    top = fmaxf(top, a[i]);
    bottom = fminf(bottom, a[i]);
  }
  nan = __reduce_add_sync(kFull, nan);

  // the k-th largest |x| (NaN last); NaN itself when k or more are NaN
  float thr = __uint_as_float(0x7fc00000u);
  if (nan < k) {
    const unsigned hi = __reduce_max_sync(kFull, __float_as_uint(top));
    const unsigned lo = __reduce_min_sync(kFull, __float_as_uint(bottom));
    // every non-NaN |x| has the bits of hi above the highest bit where
    // hi and lo differ, so all kLanes lie at or above that prefix
    int bit = 31 - __clz(hi ^ lo);
    unsigned prefix = bit < 0 ? hi : hi & ~((2u << bit) - 1u);
    int at_or_above = kLanes;
    for (; bit >= 0 && at_or_above != k; --bit) {
      const unsigned probe = prefix | (1u << bit);
      const float p = __uint_as_float(probe);
      int c = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) c += a[i] >= p;
      c = __reduce_add_sync(kFull, c) + nan;
      if (c >= k) {
        prefix = probe;
        at_or_above = c;
      }
    }
    const float p = __uint_as_float(prefix);
    float least = INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (a[i] >= p) least = fminf(least, a[i]);
    thr = __uint_as_float(__reduce_min_sync(kFull, __float_as_uint(least)));
  }

  unsigned n_greater = 0u, n_eq = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    n_greater += a[i] > thr;
    n_eq += a[i] == thr;
  }
  // both counts (at most kLanes each) in one warp sum
  const unsigned both = __reduce_add_sync(kFull, n_greater | (n_eq << 16));
  n_greater = both & 0xffffu;
  float r[4];
  if (static_cast<int>(n_greater + (both >> 16)) <= k) {
    // every element equal to the threshold is kept: no rank needed (a
    // NaN threshold keeps nothing)
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = a[i] >= thr ? xs[i] : 0.0f;
    reinterpret_cast<float4*>(out + chunk * kLanes)[lane] =
        make_float4(r[0], r[1], r[2], r[3]);
    return;
  }
  // inclusive prefix sum of the per-lane counts of equal elements
  unsigned scan = n_eq;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, scan, off);
    if (lane >= off) scan += y;
  }
  int rank = static_cast<int>(scan - n_eq);  // equal elements before mine
  const int quota = k - static_cast<int>(n_greater);
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

int cmp_quantize_chunks_a_step(void) { return kQuantStep; }
int cmp_dequantize_chunks_a_step(void) { return kDequantStep; }
int cmp_quantize_threads(void) { return kThreads; }

// x: (C, N) f32. q: (C, N) int8. s: (C, N / 128) f32, 16-byte aligned.
// chunks = C*N/128. blocks: quantize_grid in ../compress.py, a warp for
// each kQuantStep chunks.
int cmp_quantize_int8(const float* x, void* q, float* s, int64_t chunks,
                      int64_t blocks, void* stream) {
  if (blocks < 1 || blocks > 0x7fffffff ||
      blocks * (kThreads / 32) * kQuantStep < chunks ||
      reinterpret_cast<uintptr_t>(s) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  quantize_int8_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<unsigned int*>(q), s, chunks);
  return static_cast<int>(cudaGetLastError());
}

// q: (C, N) int8. s: (C, N / 128) f32. out: (C, N) f32. chunks =
// C*N/128. blocks: dequantize_grid in ../compress.py, a warp for each
// kDequantStep chunks.
int cmp_dequantize_int8(const void* q, const float* s, float* out,
                        int64_t chunks, int64_t blocks, void* stream) {
  if (blocks < 1 || blocks > 0x7fffffff ||
      blocks * (kThreads / 32) * kDequantStep < chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  dequantize_int8_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
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
