// Δ-SGD per-local-step kernels for Hopper (sm_90a), plain C interface.
//
// Both kernels work on the packed (C, N) f32 client slabs of
// repro_torch.core.flat (N a multiple of 128, rows 16-byte aligned) and
// launch on the caller's stream. They allocate nothing: the Python
// wrappers in ../delta_sgd.py allocate outputs and scratch, check
// device, dtype, shape, contiguity and alignment, and raise when a
// launch returns an error.
//
// dsgd_batched_norms replaces the TPU kernel _batched_norms_kernel
//   (repro/kernels/delta_sgd/delta_sgd.py, batched_norms). Per client it
//   computes Σ(g−g_prev)² and Σg² in one pass. It is bound by memory: it
//   reads 2·C·N·4 bytes and does ~5 flops per element pair. Design: one
//   launch over a (chunk, client) grid, 16-byte loads, each thread
//   issuing all its loads before it sums them, a warp-shuffle block
//   reduction. The TPU kernel carried the sum across its sequential grid
//   axis; here blocks run in no order, so each block writes its partial
//   to scratch and the LAST block of each client (found with an integer
//   atomic counter after __threadfence) sums the partials in chunk
//   order. No float atomics: the result is bitwise the same on every
//   call, which matters because η's min branch amplifies reduction noise.
//
// dsgd_batched_apply replaces _batched_apply_kernel and
//   _batched_apply_masked_kernel (batched_apply). It computes
//   P ← P − η_c·G in place on P (the counterpart of the TPU kernel's
//   input_output_aliases={1: 0}); where the (N,) mask is > 0 the result
//   is rounded to bf16 and back (round to nearest even). It is bound by
//   memory: it reads 2·C·N·4 bytes (plus the mask) and writes C·N·4.
//   Design: a grid-stride elementwise pass with 16-byte loads and
//   stores. The multiply and the subtract use __fmul_rn/__fsub_rn so
//   they are never contracted into an FMA: the result rounds exactly
//   like the plain PyTorch version's separate multiply and subtract.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// float4 loads per thread per input in one norms block
constexpr int kNormsVecs = 8;
// elements of one client row that one norms block reduces
constexpr int kNormsChunk = kThreads * kNormsVecs * 4;
// float4 elements per thread in one apply block
constexpr int kApplyVecs = 4;

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
  const int c = blockIdx.y;
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
    partial[static_cast<int64_t>(c) * chunks + chunk] = make_float2(dg, gg);
    __threadfence();
    const unsigned int done = atomicAdd(counter + c, 1u);
    is_last = (done == static_cast<unsigned int>(chunks - 1));
  }
  __syncthreads();
  if (!is_last) return;

  // Last block of client c: every other block's partial is visible
  // (they fenced before counting). Sum them in chunk order: thread t
  // takes chunks t, t + kThreads, ... then the fixed block tree.
  __threadfence();
  float sdg = 0.0f;
  float sgg = 0.0f;
  const float2* row = partial + static_cast<int64_t>(c) * chunks;
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    const float2 p = __ldcg(row + i);
    sdg += p.x;
    sgg += p.y;
  }
  block_sum2(sdg, sgg);
  if (threadIdx.x == 0) {
    dg_out[c] = sdg;
    gg_out[c] = sgg;
  }
}

__device__ __forceinline__ float axpy_rn(float p, float e, float g) {
  return __fsub_rn(p, __fmul_rn(e, g));
}

__device__ __forceinline__ float round_bf16(float r, float m) {
  return m > 0.0f ? __bfloat162float(__float2bfloat16_rn(r)) : r;
}

template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
batched_apply_kernel(float* __restrict__ p, const float* __restrict__ g,
                     const float* __restrict__ eta,
                     const float* __restrict__ mask, int64_t n) {
  const int c = blockIdx.y;
  const float e = eta[c];
  const int64_t n4 = n / 4;
  float4* p4 = reinterpret_cast<float4*>(p + c * n);
  const float4* g4 = reinterpret_cast<const float4*>(g + c * n);
  const float4* m4 = reinterpret_cast<const float4*>(mask);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       j < n4; j += stride) {
    const float4 pv = p4[j];
    const float4 gv = __ldcs(g4 + j);
    float4 r;
    r.x = axpy_rn(pv.x, e, gv.x);
    r.y = axpy_rn(pv.y, e, gv.y);
    r.z = axpy_rn(pv.z, e, gv.z);
    r.w = axpy_rn(pv.w, e, gv.w);
    if (kMasked) {
      const float4 mv = __ldg(m4 + j);
      r.x = round_bf16(r.x, mv.x);
      r.y = round_bf16(r.y, mv.y);
      r.z = round_bf16(r.z, mv.z);
      r.w = round_bf16(r.w, mv.w);
    }
    p4[j] = r;
  }
}

}  // namespace

extern "C" {

// Elements of one client row that one norms block reduces: the wrapper
// sizes the (C, chunks) float2 partial scratch with it.
int dsgd_norms_chunk(void) { return kNormsChunk; }

// g, g_prev: (C, n) f32. partial: (C, ceil(n / chunk)) float2 scratch.
// counter: (C,) uint32, ZERO on entry. dg, gg: (C,) f32 outputs.
int dsgd_batched_norms(const float* g, const float* g_prev, int64_t C,
                       int64_t n, void* partial, void* counter, float* dg,
                       float* gg, void* stream) {
  const int chunks = static_cast<int>((n + kNormsChunk - 1) / kNormsChunk);
  const dim3 grid(chunks, static_cast<unsigned int>(C));
  batched_norms_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      g, g_prev, n, chunks, static_cast<float2*>(partial),
      static_cast<unsigned int*>(counter), dg, gg);
  return static_cast<int>(cudaGetLastError());
}

// p: (C, n) f32, updated in place. g: (C, n) f32. eta: (C,) f32.
// mask: (n,) f32 or NULL for the unmasked variant.
int dsgd_batched_apply(float* p, const float* g, const float* eta,
                       const float* mask, int64_t C, int64_t n,
                       void* stream) {
  const int64_t n4 = n / 4;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kApplyVecs;
  const unsigned int bx =
      static_cast<unsigned int>((n4 + per_block - 1) / per_block);
  const dim3 grid(bx, static_cast<unsigned int>(C));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mask != nullptr)
    batched_apply_kernel<true><<<grid, kThreads, 0, s>>>(p, g, eta, mask, n);
  else
    batched_apply_kernel<false><<<grid, kThreads, 0, s>>>(p, g, eta, mask,
                                                          n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
