// Δ-SGD per-local-step kernels for Hopper (sm_90a), plain C interface.
//
// Both kernels work on the packed (C, N) f32 client slabs of
// repro_torch.core.flat (N a multiple of 128, rows 16-byte aligned) and
// launch on the caller's stream. They allocate nothing: the Python
// wrappers in ../delta_sgd.py allocate the outputs and batched_norms'
// workspace, check device, dtype, shape, contiguity and alignment,
// choose the grid (norms_grid, apply_grid) and raise when a launch
// returns an error.
//
// dsgd_batched_norms replaces the TPU kernel _batched_norms_kernel
//   (repro/kernels/delta_sgd/delta_sgd.py, batched_norms). Per client it
//   computes Σ(g−g_prev)² and Σg² in one pass. It is bound by memory: it
//   reads 2·C·N·4 bytes and does ~5 flops per element pair. The TPU
//   kernel carried the sum across its sequential grid axis; here one
//   launch runs a (chunk, client) grid of 256-thread blocks, each
//   summing kNormsChunk elements of a row with 16-byte loads, every load
//   issued before any sum, and a fixed warp-shuffle tree. Blocks run in
//   no order, so each leaves its (dg, gg) pair in a workspace and the
//   LAST block of each client (an integer ticket after __threadfence)
//   sums the pairs in chunk order and puts the ticket back to zero. The
//   wrapper keeps one workspace per (device, stream), filled once when it
//   is made, so a call is one device op with no counter fill; calls on
//   one stream are ordered, so they never share a ticket. No float
//   atomics: the summation order is a function of (C, N) only (not of
//   the SM count, the call or the stream), so every bit of the result
//   is too. That matters because η's min branch amplifies reduction
//   noise. A NaN or inf in one row reaches only that row's sums.
//
// dsgd_batched_apply replaces _batched_apply_kernel and
//   _batched_apply_masked_kernel (batched_apply). It computes
//   P ← P − η_c·G in place on P (the counterpart of the TPU kernel's
//   input_output_aliases={1: 0}); where the (N,) mask is > 0 the result
//   is rounded to bf16 and back (round to nearest even). It is bound by
//   memory: it reads 2·C·N·4 bytes (plus the mask) and writes C·N·4.
//   One thread owns one 16-byte column of the slab across a group of
//   clients: it loads the mask column once, then η, p and g of each of
//   its clients, all before any arithmetic, then stores. The group is
//   one client while a client row of p, g and the mask fits in L2, as
//   at the paper's width; longer rows take groups of up to kApplyGroup
//   clients (apply_grid), so that the mask is read from HBM once per
//   group, not once per client. Up to four units (a column of a group)
//   per thread of a full wave, one unit a thread: the block halves
//   (down to a warp) until every SM has a block; larger slabs take
//   blocks of kThreads with evict-first loads of g and evict-first
//   stores, at most 32 blocks per SM, grid-stride past that.
//   The multiply and the subtract use __fmul_rn/__fsub_rn so they are
//   never contracted into an FMA: the result rounds exactly like the
//   plain PyTorch version's separate multiply and subtract.
//
// dsgd_norms and dsgd_apply_update replace the TPU kernels _norms_kernel
//   and _apply_kernel (norms, apply_update): the same two sums and the
//   same update on ONE tensor of any shape, f32 or bf16, with a scalar η.
//   Their one caller is the kernel parity matrix
//   (repro_torch.conformance.kernels). Both are bound by memory: norms
//   reads 2·n elements, apply reads 2·n and writes n. The TPU kernels
//   flattened and zero-padded a copy to (rows, 128); here the kernels
//   read the tensors where they lie, with 16-byte loads (4 f32 or 8
//   bf16) when every pointer is 16-byte aligned and one element a thread
//   otherwise, and mask the ragged end. norms is the same two-stage
//   reduction as batched_norms (per-block partials, the last block sums
//   them in order, no float atomics), so repeated calls are bitwise
//   equal. apply_update computes p − η·g in f32 with __fmul_rn/__fsub_rn
//   and rounds to p's dtype to nearest even, as the plain version does;
//   η is a value or, to keep it on the card, a pointer to a device f32.
//   At the paper's width (71,808 elements) the call is all latency: its
//   grid is sized from the element count and the SM count so that every
//   SM gets a block (the block shrinks to as little as a warp) and each
//   thread issues its loads of p, g and η together before it computes;
//   large tensors take blocks of 256 threads with four 16-byte pieces
//   each, at most 32 blocks per SM, grid-stride past that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// 16-byte loads per thread per input in one norms block, and the
// elements of one client row that one batched_norms block sums
constexpr int kNormsVecs = 8;
constexpr int kNormsChunk = kThreads * kNormsVecs * 4;
// most clients one batched_apply thread updates
constexpr int kApplyGroup = 8;
// 16-byte pieces per thread of a large apply_update, and its most blocks
// per SM before the grid strides
constexpr int kUpdateVecs = 4;
constexpr int kUpdateWaves = 32;

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

// A (chunk, client) grid of kThreads-thread blocks, each summing
// kNormsChunk elements of a row (every load issued before any is summed),
// so that the whole card streams one or two client rows at a time. Each
// block leaves its pair in the caller's partial workspace; the LAST
// block of a client, found with an integer atomic ticket after
// __threadfence, sums the pairs in chunk order and puts the ticket back
// to zero for the next call on the stream. No float atomics: the sum
// order is a function of (C, N).
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

__device__ __forceinline__ float axpy_rn(float p, float e, float g) {
  return __fsub_rn(p, __fmul_rn(e, g));
}

__device__ __forceinline__ float round_bf16(float r, float m) {
  return m > 0.0f ? __bfloat162float(__float2bfloat16_rn(r)) : r;
}

// Unit u of batched_apply: float4 column u % n4 of the clients
// [grp·group, min(C, (grp + 1)·group)), grp = u / n4. A thread loads the
// mask column, η and the p and g columns of its clients before any
// arithmetic, then stores; grid-stride over the units. stream: large
// slabs, streamed through L2 with evict-first loads of g and
// evict-first stores. kG (1 or kApplyGroup) bounds the group, so a
// thread of one client holds just that client's registers.
template <int kG>
__global__ void __launch_bounds__(kThreads)
batched_apply_kernel(float* __restrict__ p, const float* __restrict__ g,
                     const float* __restrict__ eta,
                     const float* __restrict__ mask, int64_t C, int64_t n4,
                     int group, int64_t units, int stream) {
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* m4 = reinterpret_cast<const float4*>(mask);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       u < units; u += stride) {
    const int64_t grp = u / n4;
    const int64_t col = u - grp * n4;
    const int64_t c0 = grp * group;
    const int64_t left = C - c0;
    const int cn = left < group ? static_cast<int>(left) : group;
    const int64_t at0 = c0 * n4 + col;
    float4 mv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (mask != nullptr) mv = __ldg(m4 + col);
    float4 pv[kG];
    float4 gv[kG];
    float e[kG];
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      if (i < cn) {
        const int64_t at = at0 + i * n4;
        e[i] = __ldg(eta + c0 + i);
        pv[i] = p4[at];
        gv[i] = stream ? __ldcs(g4 + at) : g4[at];
      }
    }
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      if (i < cn) {
        float4 r;
        r.x = axpy_rn(pv[i].x, e[i], gv[i].x);
        r.y = axpy_rn(pv[i].y, e[i], gv[i].y);
        r.z = axpy_rn(pv[i].z, e[i], gv[i].z);
        r.w = axpy_rn(pv[i].w, e[i], gv[i].w);
        if (mask != nullptr) {
          r.x = round_bf16(r.x, mv.x);
          r.y = round_bf16(r.y, mv.y);
          r.z = round_bf16(r.z, mv.z);
          r.w = round_bf16(r.w, mv.w);
        }
        const int64_t at = at0 + i * n4;
        if (stream)
          __stcs(p4 + at, r);
        else
          p4[at] = r;
      }
    }
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
  __device__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
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
  __device__ static uint4 pack(const float* v) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return r;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
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

// One apply_update thread: kV 16-byte pieces (kVec) or kV elements, a
// block's threads on neighbouring pieces, every load issued before any
// arithmetic; grid-stride past the grid. The ragged end (n not a whole
// number of pieces) is block 0's. Large tensors (kV > 1) stream through
// L2 with evict-first loads of g and stores; small ones, which the
// caller reads back from L2, keep plain ones.
template <typename T, bool kVec, int kV>
__global__ void __launch_bounds__(kThreads)
apply_update_kernel(const T* __restrict__ p, const T* __restrict__ g,
                    const float* __restrict__ eta_ptr, float eta_val,
                    T* __restrict__ out, int64_t n) {
  using P = Pack16<T>;
  constexpr int kN = kVec ? P::kN : 1;
  const float e = eta_ptr != nullptr ? __ldg(eta_ptr) : eta_val;
  const int64_t units = n / kN;
  const int64_t step = static_cast<int64_t>(blockDim.x);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * step * kV;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * step * kV +
                      threadIdx.x;
       base < units; base += stride) {
    if (kVec) {
      const uint4* p4 = reinterpret_cast<const uint4*>(p);
      const uint4* g4 = reinterpret_cast<const uint4*>(g);
      uint4 a[kV];
      uint4 b[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int64_t j = base + i * step;
        if (j < units) {
          a[i] = p4[j];
          b[i] = kV > 1 ? __ldcs(g4 + j) : g4[j];
        }
      }
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int64_t j = base + i * step;
        if (j < units) {
          float x[P::kN];
          float y[P::kN];
          P::unpack(a[i], x);
          P::unpack(b[i], y);
#pragma unroll
          for (int k = 0; k < P::kN; ++k) x[k] = axpy_rn(x[k], e, y[k]);
          if (kV > 1)
            __stcs(reinterpret_cast<uint4*>(out) + j, P::pack(x));
          else
            reinterpret_cast<uint4*>(out)[j] = P::pack(x);
        }
      }
    } else {
      T a[kV];
      T b[kV];
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int64_t j = base + i * step;
        if (j < units) {
          a[i] = p[j];
          b[i] = g[j];
        }
      }
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int64_t j = base + i * step;
        if (j < units) from_f32(axpy_rn(to_f32(a[i]), e, to_f32(b[i])),
                                out + j);
      }
    }
    if (kV == 1) break;   // the small grid covers every piece at once
  }
  if (kVec && blockIdx.x == 0 && threadIdx.x < n - units * kN) {
    const int64_t i = units * kN + threadIdx.x;
    from_f32(axpy_rn(to_f32(p[i]), e, to_f32(g[i])), out + i);
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

// apply_update's grid. Large tensors: 256 threads of kUpdateVecs pieces,
// at most kUpdateWaves blocks per SM (grid-stride past them). Smaller
// ones: one piece a thread, the block halved (down to a warp) until the
// grid has a block for every SM, so that no SM idles and no thread
// waits on a second trip.
template <typename T>
int launch_apply(const void* p, const void* g, const float* eta_ptr,
                 float eta, void* out, int64_t n, bool vec, int sms,
                 cudaStream_t s) {
  const int64_t units = vec ? n / Pack16<T>::kN : n;
  const T* a = static_cast<const T*>(p);
  const T* b = static_cast<const T*>(g);
  T* o = static_cast<T*>(out);
  const int64_t wide = static_cast<int64_t>(kThreads) * kUpdateVecs;
  if (units >= sms * wide) {
    const int64_t want = (units + wide - 1) / wide;
    const int64_t cap = static_cast<int64_t>(sms) * kUpdateWaves;
    const unsigned int blocks =
        static_cast<unsigned int>(want < cap ? want : cap);
    if (vec)
      apply_update_kernel<T, true, kUpdateVecs><<<blocks, kThreads, 0, s>>>(
          a, b, eta_ptr, eta, o, n);
    else
      apply_update_kernel<T, false, kUpdateVecs><<<blocks, kThreads, 0, s>>>(
          a, b, eta_ptr, eta, o, n);
  } else {
    int threads = kThreads;
    while (threads > 32 && (units + threads - 1) / threads < sms)
      threads /= 2;
    const int64_t want = (units + threads - 1) / threads;
    const unsigned int blocks = static_cast<unsigned int>(want > 0 ? want : 1);
    if (vec)
      apply_update_kernel<T, true, 1><<<blocks, threads, 0, s>>>(
          a, b, eta_ptr, eta, o, n);
    else
      apply_update_kernel<T, false, 1><<<blocks, threads, 0, s>>>(
          a, b, eta_ptr, eta, o, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype codes of the single-tensor entry points
// (kDtypes in ../delta_sgd.py): 0 = f32, 1 = bf16.

// Elements of one tensor that one single-tensor norms block reduces:
// the wrapper sizes the (chunks,) float2 partial scratch with it.
int dsgd_single_norms_chunk(int dtype) {
  return dtype == 0 ? norms_chunk<float>() : norms_chunk<__nv_bfloat16>();
}

// g, g_prev: n elements of dtype, n >= 1. vec: both 16-byte aligned.
// partial: (ceil(n / chunk),) float2 scratch. counter: one uint32, ZERO
// on entry. out: (2,) f32, Σ(g−g_prev)² then Σg².
int dsgd_norms(const void* g, const void* g_prev, int dtype, int64_t n,
               int vec, void* partial, void* counter, float* out,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_norms<float>(g, g_prev, n, vec != 0, partial, counter,
                               out, s);
  if (dtype == 1)
    return launch_norms<__nv_bfloat16>(g, g_prev, n, vec != 0, partial,
                                       counter, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// p, g, out: n elements of dtype, n >= 1. vec: all three 16-byte
// aligned. eta_ptr: a device f32, or NULL to use eta. sms: the device's
// SM count (the wrapper reads it once), which sizes the grid.
int dsgd_apply_update(const void* p, const void* g, const float* eta_ptr,
                      float eta, void* out, int dtype, int64_t n, int vec,
                      int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_apply<float>(p, g, eta_ptr, eta, out, n, vec != 0, sms,
                               s);
  if (dtype == 1)
    return launch_apply<__nv_bfloat16>(p, g, eta_ptr, eta, out, n,
                                       vec != 0, sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// g, g_prev: (C, n) f32, n >= 4. chunks: blocks a row, ceil(n /
// kNormsChunk) (norms_grid in ../delta_sgd.py; any other count is
// refused, so the wrapper's rule cannot drift from the kernel's).
// partial: (C, chunks) float2 workspace. counter: (C,) uint32, ZERO on
// entry and left zero. dg, gg: (C,) f32 outputs.
int dsgd_batched_norms(const float* g, const float* g_prev, int64_t C,
                       int64_t n, int64_t chunks, void* partial,
                       void* counter, float* dg, float* gg, void* stream) {
  if (n < 4 || C < 1 || C > 65535 ||
      chunks != (n + kNormsChunk - 1) / kNormsChunk || chunks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  batched_norms_kernel<<<dim3(static_cast<unsigned int>(chunks),
                              static_cast<unsigned int>(C)),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, g_prev, n, static_cast<int>(chunks), static_cast<float2*>(partial),
      static_cast<unsigned int*>(counter), dg, gg);
  return static_cast<int>(cudaGetLastError());
}

// p: (C, n) f32, updated in place. g: (C, n) f32. eta: (C,) f32.
// mask: (n,) f32 or NULL for the unmasked variant. group: clients a
// thread updates (1 .. kApplyGroup); threads (1 .. kThreads), blocks:
// the grid; stream_l2: evict-first loads and stores (apply_grid in
// ../delta_sgd.py).
int dsgd_batched_apply(float* p, const float* g, const float* eta,
                       const float* mask, int64_t C, int64_t n, int group,
                       int threads, int64_t blocks, int stream_l2,
                       void* stream) {
  if (group < 1 || group > kApplyGroup || threads < 1 ||
      threads > kThreads || blocks < 1 || blocks > 0x7fffffff || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n4 = n / 4;
  const int64_t units = (C + group - 1) / group * n4;
  auto kernel = group == 1 ? &batched_apply_kernel<1>
                           : &batched_apply_kernel<kApplyGroup>;
  kernel<<<static_cast<unsigned int>(blocks), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(p, g, eta, mask, C, n4,
                                                 group, units, stream_l2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
