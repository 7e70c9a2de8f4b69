// Δ-SGD per-local-step kernels for Hopper (sm_90a), plain C interface.
//
// The batched pair works on the packed (C, N) f32 client slabs of
// repro_torch.core.flat (N a multiple of 128, rows 16-byte aligned); the
// single-tensor pair on one tensor of any shape. All launch on the
// caller's stream and allocate nothing: the Python wrappers in
// ../delta_sgd.py allocate the outputs and the norms' workspace, check
// device, dtype, shape, contiguity and alignment, choose the grid
// (norms_grid, single_norms_grid, apply_grid) and raise when a launch
// returns an error.
//
// dsgd_batched_norms and dsgd_norms replace the TPU kernels
//   _batched_norms_kernel and _norms_kernel (repro/kernels/delta_sgd/
//   delta_sgd.py, batched_norms and norms): Σ(g−g_prev)² and Σg² in one
//   pass, per client of a (C, N) slab or over one tensor of f32 or bf16
//   (summed in f32). Both are bound by memory: they read 2·n elements
//   and do ~5 flops per element pair. The TPU kernels carried the sum
//   across a sequential grid axis; here both run ONE kernel,
//   norms_kernel<T, kV, kVec>: a (chunk, client) grid of 256-thread
//   blocks, each summing a chunk of kV 16-byte pieces a thread of each
//   input (every load issued before any sum; one element a thread, kV·8
//   or kV·4 of them, when a pointer is not 16-byte aligned) in a fixed
//   warp-shuffle tree. Blocks run in no order, so each leaves its pair in
//   a workspace and the LAST block of a row (an integer ticket after
//   __threadfence) sums the pairs in chunk order, adds the ragged end
//   (the elements past the last whole 16-byte piece) and puts the ticket
//   back to zero. The wrapper keeps one workspace per (device, stream),
//   filled once when it is made, shared by both entry points, so a call
//   is one device op with no counter fill; calls on one stream are
//   ordered, so they never share a ticket. No float atomics: the order
//   of the sums is a function of (C, N) for batched_norms (kV = 8, 8,192
//   elements a block, norms_grid) and of (n, dtype, alignment) for norms
//   (single_norms_grid: the most loads a thread, up to 8, that still
//   leave 64 blocks, so the paper's width, 71,808 elements, takes 71
//   blocks of one load a thread where the parent took 9 of eight), never
//   of the SM count, the call or the stream, so every bit of the result
//   is too. That matters because η's min branch amplifies reduction
//   noise. A NaN or inf reaches the sums of its own row. batched_norms'
//   instance does the parent's arithmetic in the parent's order, so its
//   bits are the parent's (scripts/norms_probe.py holds them); norms'
//   order, and so its bits, changed. One thread-block cluster of up to
//   16 blocks gathering the pairs over distributed shared memory (no
//   workspace, no ticket) was 0.6-1.7 µs slower at the paper's width,
//   and a fixed grid of blocks striding over the chunks with the next
//   chunk's loads in flight at most 0.4 µs faster at 2^24
//   (scripts/norms_probe.py, H100 SXM, 700 W).
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
// dsgd_apply_update replaces the TPU kernel _apply_kernel (apply_update):
//   the same update on ONE tensor of any shape, f32 or bf16, with a
//   scalar η. Its one caller, as norms', is the kernel parity matrix
//   (repro_torch.conformance.kernels). It is bound by memory: it reads
//   2·n elements and writes n. The TPU kernel flattened and zero-padded
//   a copy to (rows, 128); here the kernel reads the tensors where they
//   lie, with 16-byte loads (4 f32 or 8 bf16) when every pointer is
//   16-byte aligned and one element a thread otherwise, and masks the
//   ragged end. It computes p − η·g in f32 with __fmul_rn/__fsub_rn and
//   rounds to p's dtype to nearest even, as the plain version does; η is
//   a value or, to keep it on the card, a pointer to a device f32. At
//   the paper's width (71,808 elements) the call is all latency: its
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
// 16-byte loads per thread per input in one batched_norms block, and the
// elements of one client row that one batched_norms block sums
constexpr int kNormsVecs = 8;
constexpr int kNormsChunk = kThreads * kNormsVecs * 4;
// partial pairs one thread of a norms row's last block loads at once
constexpr int kSumVecs = 4;
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

// Adds (x − y)² and x² of four elements to dg and gg, each four summed
// left to right first: the order batched_norms' bits are defined by.
__device__ __forceinline__ void add_quad(const float* x, const float* y,
                                         float& dg, float& gg) {
  const float dx = x[0] - y[0], dy = x[1] - y[1];
  const float dz = x[2] - y[2], dw = x[3] - y[3];
  dg += dx * dx + dy * dy + dz * dz + dw * dw;
  gg += x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + x[3] * x[3];
}

// Elements of one norms chunk: kV 16-byte pieces a thread of the block.
template <typename T>
__host__ __device__ constexpr int64_t norms_chunk(int vecs) {
  return static_cast<int64_t>(kThreads) * vecs * Pack16<T>::kN;
}

// This thread's share of chunk `chunk` of one row of g and gp, added to
// dg and gg. kVec: piece i of the thread is 16-byte piece chunk·kThreads·
// kV + i·kThreads + threadIdx.x of the row, all loads issued before any
// is summed; whole pieces only (tail_sums adds the ragged end). Else one
// element a thread per step, kV·kN steps.
template <typename T, int kV, bool kVec>
__device__ __forceinline__ void chunk_sums(const T* __restrict__ g,
                                           const T* __restrict__ gp,
                                           int64_t n, int64_t chunk,
                                           float& dg, float& gg) {
  using P = Pack16<T>;
  constexpr int kN = P::kN;
  if constexpr (kVec) {
    const int64_t units = n / kN;
    const uint4* g16 = reinterpret_cast<const uint4*>(g);
    const uint4* gp16 = reinterpret_cast<const uint4*>(gp);
    const int64_t base = chunk * (kThreads * kV) + threadIdx.x;
    uint4 a[kV];
    uint4 b[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int64_t j = base + i * kThreads;
      if (j < units) {
        a[i] = __ldcs(g16 + j);
        b[i] = __ldcs(gp16 + j);
      } else {
        a[i] = make_uint4(0u, 0u, 0u, 0u);
        b[i] = a[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      float x[kN];
      float y[kN];
      P::unpack(a[i], x);
      P::unpack(b[i], y);
#pragma unroll
      for (int q = 0; q < kN; q += 4) add_quad(x + q, y + q, dg, gg);
    }
  } else {
    const int64_t base = chunk * norms_chunk<T>(kV) + threadIdx.x;
#pragma unroll 8
    for (int i = 0; i < kV * kN; ++i) {
      const int64_t e = base + static_cast<int64_t>(i) * kThreads;
      if (e < n) {
        const float x = to_f32(g[e]);
        const float d = x - to_f32(gp[e]);
        dg += d * d;
        gg += x * x;
      }
    }
  }
}

// The ragged end of the 16-byte path, in element order: the fewer than
// kN elements past the row's last whole piece (none in a packed slab).
template <typename T, bool kVec>
__device__ __forceinline__ void tail_sums(const T* __restrict__ g,
                                          const T* __restrict__ gp,
                                          int64_t n, float& dg, float& gg) {
  if constexpr (kVec) {
    for (int64_t e = n / Pack16<T>::kN * Pack16<T>::kN; e < n; ++e) {
      const float x = to_f32(g[e]);
      const float d = x - to_f32(gp[e]);
      dg += d * d;
      gg += x * x;
    }
  }
}

// The ticket grid: block (chunk, c) sums chunk `chunk` of row c and
// leaves its pair in partial[c·chunks + chunk]; the LAST block of the
// row, found with an integer atomic ticket after __threadfence, sums the
// pairs in chunk order (thread t takes chunks t, t + kThreads, ..., its
// loads kSumVecs at a time, then the block tree), adds the ragged end,
// writes the row's sums and puts the ticket back to zero for the next
// call on the stream. No float atomics.
template <typename T, int kV, bool kVec>
__global__ void __launch_bounds__(kThreads)
norms_kernel(const T* __restrict__ g, const T* __restrict__ gp, int64_t n,
             int chunks, float2* __restrict__ partial,
             unsigned int* __restrict__ counter,
             float* __restrict__ dg_out, float* __restrict__ gg_out) {
  const int64_t c = blockIdx.y;
  g += c * n;
  gp += c * n;
  float dg = 0.0f;
  float gg = 0.0f;
  chunk_sums<T, kV, kVec>(g, gp, n, blockIdx.x, dg, gg);
  block_sum2(dg, gg);

  __shared__ bool is_last;
  if (threadIdx.x == 0) {
    partial[c * chunks + blockIdx.x] = make_float2(dg, gg);
    __threadfence();
    const unsigned int done = atomicAdd(counter + c, 1u);
    is_last = (done == static_cast<unsigned int>(chunks - 1));
  }
  __syncthreads();
  if (!is_last) return;

  // every other block's pair is visible (they fenced before counting)
  __threadfence();
  float sdg = 0.0f;
  float sgg = 0.0f;
  const float2* row = partial + c * chunks;
  for (int i = threadIdx.x; i < chunks; i += kThreads * kSumVecs) {
    float2 p[kSumVecs];
#pragma unroll
    for (int u = 0; u < kSumVecs; ++u) {
      const int k = i + u * kThreads;
      p[u] = k < chunks ? __ldcg(row + k) : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kSumVecs; ++u) {
      sdg += p[u].x;
      sgg += p[u].y;
    }
  }
  block_sum2(sdg, sgg);
  if (threadIdx.x == 0) {
    tail_sums<T, kVec>(g, gp, n, sdg, sgg);
    dg_out[c] = sdg;
    gg_out[c] = sgg;
    counter[c] = 0u;   // every block of this row has counted
  }
}

// One tensor: the ticket grid, a block a chunk.
template <typename T, int kV>
int launch_single_norms(const void* g, const void* gp, int64_t n, bool vec,
                        int64_t chunks, void* partial, void* counter,
                        float* out, cudaStream_t s) {
  auto kernel =
      vec ? &norms_kernel<T, kV, true> : &norms_kernel<T, kV, false>;
  kernel<<<dim3(static_cast<unsigned int>(chunks), 1), kThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(gp), n,
      static_cast<int>(chunks), static_cast<float2*>(partial),
      static_cast<unsigned int*>(counter), out, out + 1);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_single_norms_v(const void* g, const void* gp, int64_t n,
                          bool vec, int vecs, int64_t chunks, void* partial,
                          void* counter, float* out, cudaStream_t s) {
  switch (vecs) {
    case 1:
      return launch_single_norms<T, 1>(g, gp, n, vec, chunks, partial,
                                       counter, out, s);
    case 2:
      return launch_single_norms<T, 2>(g, gp, n, vec, chunks, partial,
                                       counter, out, s);
    case 4:
      return launch_single_norms<T, 4>(g, gp, n, vec, chunks, partial,
                                       counter, out, s);
    case 8:
      return launch_single_norms<T, 8>(g, gp, n, vec, chunks, partial,
                                       counter, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
// (_DTYPES in ../delta_sgd.py): 0 = f32, 1 = bf16.

// Elements of one norms chunk of dtype at vecs 16-byte loads a thread
// (1, 2, 4 or 8); 0 for any other (dtype, vecs). The wrapper checks its
// mirror (single_norms_grid) against it when it loads the library.
int64_t dsgd_norms_chunk(int dtype, int vecs) {
  if (vecs != 1 && vecs != 2 && vecs != 4 && vecs != 8) return 0;
  if (dtype == 0) return norms_chunk<float>(vecs);
  if (dtype == 1) return norms_chunk<__nv_bfloat16>(vecs);
  return 0;
}

// g, g_prev: n >= 1 elements of dtype. vec: both 16-byte aligned. vecs:
// 16-byte loads a thread of each input in a chunk; chunks: ceil(n /
// dsgd_norms_chunk(dtype, vecs)), a block each (single_norms_grid in
// ../delta_sgd.py; any other count is refused). partial: a (chunks,)
// float2 workspace. counter: one uint32, ZERO on entry and left zero.
// out: (2,) f32, Σ(g−g_prev)² then Σg².
int dsgd_norms(const void* g, const void* g_prev, int dtype, int64_t n,
               int vec, int vecs, int64_t chunks, void* partial,
               void* counter, float* out, void* stream) {
  const int64_t chunk = dsgd_norms_chunk(dtype, vecs);
  if (n < 1 || chunk == 0 || chunks != (n + chunk - 1) / chunk ||
      chunks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_single_norms_v<float>(g, g_prev, n, vec != 0, vecs,
                                        chunks, partial, counter, out, s);
  return launch_single_norms_v<__nv_bfloat16>(g, g_prev, n, vec != 0, vecs,
                                              chunks, partial, counter, out,
                                              s);
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
  norms_kernel<float, kNormsVecs, true>
      <<<dim3(static_cast<unsigned int>(chunks),
              static_cast<unsigned int>(C)),
         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          g, g_prev, n, static_cast<int>(chunks),
          static_cast<float2*>(partial), static_cast<unsigned int*>(counter),
          dg, gg);
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
