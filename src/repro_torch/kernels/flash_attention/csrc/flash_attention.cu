// Flash attention for Hopper (sm_90a), plain C interface.
//
// fa_forward replaces the TPU kernel _fa_kernel behind flash_attention
//   (repro/kernels/flash_attention/flash_attention.py): causal or
//   bidirectional GQA attention with an optional sliding window, softmax
//   computed online over key tiles with f32 running max m, sum l and
//   accumulator acc, output in q's dtype (f32 or bf16). It launches on
//   the caller's stream and allocates nothing: the wrapper in
//   ../flash_attention.py allocates the output, checks shapes, dtypes,
//   contiguity and (bf16) 16-byte alignment, picks the q tile and
//   raises when the launch returns an error.
//
// Bound: at the prefill shapes of the LM zoo the kernel does about 4·hd
//   flops per visible (query, key) pair and reads each q, k, v and
//   output element once, so it is bound by operations, not bytes: the
//   f32 rate of the CUDA cores (67 TFLOP/s) for f32 inputs, the bf16
//   tensor-core rate (989 TFLOP/s) for bf16 inputs. At short prefills
//   (S = 64, B = 1) it is bound by how many SMs the grid fills.
//
// Grid: one block per (head, batch, q tile), the q tile the slowest
//   grid dimension and in reverse order, so that the causal tiles with
//   the most keys, of every head, start first and the light ones fill
//   the tail. The bf16 kernel's q tile has 64 rows. The f32 kernel's has
//   64, 32 or 16: the wrapper takes 64 unless that grid has fewer blocks
//   than the card has SMs, then the first of 32 and 16 that fills it (16
//   at S = 64, B = 1, H = 32: 128 blocks, not 32). A row's result does
//   not depend on the tile it is in. Smaller bf16 tiles measured no
//   faster at either serve prefill shape (one warp then issues a whole
//   K/V tile's copies), so the bf16 kernel is built for 64 rows alone.
//
// f32 kernel (dtype 0): f32 FMA on the CUDA cores. The port turns TF32
//   off to hold the reference's f32 numerics, so the tensor cores stay
//   out of it. 256 threads; the q tile sits in shared memory for the
//   whole sweep; each key tile of 64 rows is staged in shared memory, K
//   with a padded row stride (hd + 1) so that 16 threads reading 16
//   different keys at one dim hit 16 different banks. Thread (tr, tc) =
//   (tid / 16, tid % 16) owns rows tr + 16i (i < rows / 16): the scores
//   at keys tc + 16j (j < 4) and the output dims tc + 16j (j < hd / 16).
//   Every row sums its products in the same order whatever the tile
//   height. Row max and row sum reduce over the 16 threads of a row with
//   warp shuffles, so m and l need no shared memory.
//
// bf16 kernel (dtype 1): mma.sync m16n8k16 bf16 × bf16 → f32 on the
//   tensor cores. A bf16 × bf16 product is exact in f32, so Q·Kᵀ is the
//   reference's (which widens bf16 to f32 first) up to the order of the
//   f32 sums. One warp per 16 query rows, 4 warps a block.
//   K and V tiles of 64 keys stay bf16 in shared memory, two of each,
//   filled by 16-byte cp.async copies while the previous tile is
//   computed; rows are padded by 8 elements (16 bytes), so the eight
//   16-byte rows one ldmatrix phase reads fall in eight different bank
//   quads. The warp's Q fragments are loaded once (ldmatrix) and stay
//   in registers for the whole sweep; K comes by ldmatrix, V by
//   ldmatrix.trans. The scale multiplies the f32 scores after the
//   product, as on the TPU (1/√112 is not a power of two: folded into
//   bf16 q it would round). Each row of an m16n8 fragment is held by
//   four threads: row max and row sum reduce over them with two
//   __shfl_xor_sync. The score fragment is reused in registers as the A
//   operand of P·V (no shared-memory round trip), split as
//   P_hi = bf16_rn(P) and P_lo = bf16_rn(P − P_hi), and both go through
//   the tensor cores into the f32 acc, so P keeps about 16 significant
//   bits where a single bf16 P (as SDPA has) keeps 8: the reference
//   keeps p in f32. That is 1.5× the function's tensor-core work. The
//   output is acc / max(l, 1e-30) rounded to bf16 (RNE).
//
// Roundings are spelled out (__fmul_rn for the scale, __fmaf_rn for
//   l = alpha·l + Σp), so the compiler contracts nothing differently from
//   one instantiation to the next: an f32 row gets the same bits from a
//   16-, 32- or 64-row tile.
//
// Masked scores are −1e30, not −inf, and m starts at −1e30, as on the
//   TPU: a wholly masked tile adds exp(0) terms that the next real tile
//   wipes out through alpha = exp(−1e30 − m) = 0, and no NaN can appear.
//   Key tiles wholly above the diagonal (causal) or wholly before the
//   window of the tile's first row are skipped: the first add exact
//   zeros, the second are wiped out, so skipping them changes no bit.
//   Key rows past T are zero-filled (cp.async src-size 0), so masked
//   p = 0 never meets a stale value. Query head h reads KV head
//   h / (H / KV): no copy of K/V per query head. hd is any multiple of
//   16 up to 128 (64 TinyLlama, 112 Zamba2's shared block), a template
//   parameter, so the accumulators stay in registers.
//
// Registers a thread (ptxas -v, sm_90a, CUDA 12.8), no spill and no
//   stack frame in any of the 32 instantiations (chip_smoke.py fails
//   on one):
//     hd                      16  32  48  64  80  96 112 128
//     bf16, 64-row tile       89  99 128 137 154 174 188 206
//     f32, 64-row tile        64  62  63  80  80  80  79  80
//     f32, 32-row tile        40  48  40  47  40  40  74  64
//     f32, 16-row tile        40  40  32  40  32  32  40  48
//   bf16 at hd = 128: acc 64, Q fragments 32, scores 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kMaxHeadDim = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ f32 kernel

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int NJ, int MI>
constexpr size_t f32_smem_floats() {
  return static_cast<size_t>(16 * MI) * (16 * NJ + 1) +   // q
         static_cast<size_t>(kBlockK) * (16 * NJ + 1) +   // k
         static_cast<size_t>(kBlockK) * (16 * NJ) +       // v
         static_cast<size_t>(16 * MI) * (kBlockK + 1);    // p
}

// NJ = hd / 16; MI = q-tile rows / 16, the rows each thread owns
template <int NJ, int MI>
__global__ void __launch_bounds__(kThreads)
fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              int s_len, int t_len, int heads, int kv_heads, int causal,
              int window, float scale) {
  constexpr int HD = 16 * NJ;
  constexpr int BQ = 16 * MI;
  constexpr int QS = HD + 1;           // padded row stride of q and k
  constexpr int PS = kBlockK + 1;      // padded row stride of p
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + BQ * QS;
  float* sv = sk + kBlockK * QS;
  float* sp = sv + kBlockK * HD;

  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;

  for (int i = tid; i < BQ * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    const int s = q0 + r;
    sq[r * QS + d] =
        s < s_len ? q[((static_cast<int64_t>(b) * s_len + s) * heads + h) *
                          HD + d]
                  : 0.0f;
  }

  float m[MI], l[MI], acc[MI][NJ];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  // key tiles that can hold a visible key for some row of this tile
  const int last_row = min(q0 + BQ, s_len) - 1;
  int kt_end = (t_len + kBlockK - 1) / kBlockK;
  if (causal) kt_end = min(kt_end, last_row / kBlockK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBlockK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD, d = i - r * HD;
      const int t = k0 + r;
      float kv = 0.0f, vv = 0.0f;
      if (t < t_len) {
        const int64_t off =
            ((static_cast<int64_t>(b) * t_len + t) * kv_heads + kvh) * HD + d;
        kv = k[off];
        vv = v[off];
      }
      sk[r * QS + d] = kv;
      sv[r * HD + d] = vv;
    }
    __syncthreads();

    float s[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[MI], c[4];
#pragma unroll
      for (int i = 0; i < MI; ++i) a[i] = sq[(tr + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = sk[(tc + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int row = q0 + tr + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc + 16 * j;
        bool ok = col < t_len;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && row - col < window;
        s[i][j] = ok ? __fmul_rn(s[i][j], scale) : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sp[(tr + 16 * i) * PS + tc + 16 * j] = p;
        ps += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = __fmaf_rn(alpha, l[i], row_sum16(ps));
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float p[MI], vv[NJ];
#pragma unroll
      for (int i = 0; i < MI; ++i) p[i] = sp[(tr + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sv[c * HD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* o = out + ((static_cast<int64_t>(b) * s_len + row) * heads + h) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[tc + 16 * j] = acc[i][j] / denom;
  }
}

// ----------------------------------------------------------- bf16 kernel

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a · b, a 16×16 bf16 (row), b 16×8 bf16 (col), d 16×8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> bf16 pairs hi = rn(x, y) and lo = rn(x − hi, y − hi), the
// lower column in the lower half as the A fragment wants
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// 2^x on the SFU alone: a result below 2^-126 flushes to zero (the
// library's exp2f spends three more instructions to keep it)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

constexpr int kBf16Warps = 4;               // 16 q rows a warp
constexpr int kBf16Rows = 16 * kBf16Warps;

template <int NJ>
constexpr size_t bf16_smem_bytes() {
  // q tile, then two K and two V tiles, rows padded by 8 elements
  return static_cast<size_t>(kBf16Rows + 4 * kBlockK) * (16 * NJ + 8) *
         sizeof(__nv_bfloat16);
}

// NJ = hd / 16. One block an SM in the bound gives up to 255 registers a
// thread: with the thread count alone ptxas held hd = 64 to 128
// registers and spilled.
template <int NJ>
__global__ void __launch_bounds__(32 * kBf16Warps, 1)
fa_bf16_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, int s_len, int t_len,
               int heads, int kv_heads, int causal, int window,
               float scale) {
  constexpr int HD = 16 * NJ;
  constexpr int BQ = kBf16Rows;
  constexpr int LD = HD + 8;           // padded row stride (elements)
  constexpr int THREADS = 32 * kBf16Warps;
  constexpr int CHUNKS = HD / 8;       // 16-byte chunks per row
  constexpr int TILE = kBlockK * LD;   // elements of one K or V tile
  extern __shared__ __align__(16) unsigned char fa_smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* sk = sq + BQ * LD;    // [2][kBlockK][LD]
  __nv_bfloat16* sv = sk + 2 * TILE;   // [2][kBlockK][LD]

  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int64_t q_stride = static_cast<int64_t>(heads) * HD;
  const int64_t kv_stride = static_cast<int64_t>(kv_heads) * HD;
  const __nv_bfloat16* qb =
      q + (static_cast<int64_t>(b) * s_len * heads + h) * HD;
  const __nv_bfloat16* kb =
      k + (static_cast<int64_t>(b) * t_len * kv_heads + kvh) * HD;
  const __nv_bfloat16* vb =
      v + (static_cast<int64_t>(b) * t_len * kv_heads + kvh) * HD;

  for (int i = tid; i < BQ * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i - r * CHUNKS;
    const bool ok = q0 + r < s_len;
    cp_async16(smem_addr(sq + r * LD + c * 8),
               qb + (ok ? q0 + r : 0) * q_stride + c * 8, ok);
  }
  auto load_kv = [&](int kt, int buf) {
    const int k0 = kt * kBlockK;
    __nv_bfloat16* dk = sk + buf * TILE;
    __nv_bfloat16* dv = sv + buf * TILE;
    for (int i = tid; i < kBlockK * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, c = i - r * CHUNKS;
      const bool ok = k0 + r < t_len;
      const int64_t off = (ok ? k0 + r : 0) * kv_stride + c * 8;
      cp_async16(smem_addr(dk + r * LD + c * 8), kb + off, ok);
      cp_async16(smem_addr(dv + r * LD + c * 8), vb + off, ok);
    }
  };

  // key tiles that can hold a visible key for some row of this tile
  const int last_row = min(q0 + BQ, s_len) - 1;
  int kt_end = (t_len + kBlockK - 1) / kBlockK;
  if (causal) kt_end = min(kt_end, last_row / kBlockK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBlockK;

  load_kv(kt_begin, 0);
  cp_async_commit();                   // group: q and the first K/V tile

  const int w0 = q0 + 16 * warp;       // the warp's first row
  const int r_lo = w0 + (lane >> 2);   // rows of fragment halves 0 and 1
  const int r_hi = r_lo + 8;
  uint32_t qf[NJ][4];
  float acc[2 * NJ][4];
#pragma unroll
  for (int n = 0; n < 2 * NJ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.0f, l_hi = 0.0f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      load_kv(kt + 1, buf ^ 1);        // in flight while this tile runs
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == kt_begin) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        ldsm_x4(qf[j], smem_addr(sq + (16 * warp + (lane & 15)) * LD +
                                 16 * j + (lane >> 4) * 8));
    }
    const __nv_bfloat16* kt_s = sk + buf * TILE;
    const __nv_bfloat16* vt_s = sv + buf * TILE;

    // S = Q·Kᵀ: 16 rows × 64 keys, eight 16×8 fragments
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t bk[4];
        ldsm_x4(bk, smem_addr(kt_s +
                              (16 * n2 + (lane >> 4) * 8 + (lane & 7)) * LD +
                              16 * j + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * n2], qf[j], bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], qf[j], bk[2], bk[3]);
      }
    }

    // scale the f32 scores, then mask where the tile needs it
    const int k0 = kt * kBlockK;
    const bool edge = k0 + kBlockK > t_len ||
                      (causal && k0 + kBlockK - 1 > w0) ||
                      (window > 0 && w0 + 15 - k0 >= window);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[n][e], scale);
        if (edge) {
          const int row = e < 2 ? r_lo : r_hi;
          const int col = k0 + 8 * n + 2 * (lane & 3) + (e & 1);
          bool ok = col < t_len;
          if (causal) ok = ok && col <= row;
          if (window > 0) ok = ok && row - col < window;
          x = ok ? x : kNegInf;
        }
        s[n][e] = x;
      }
    }

    // online softmax over the four threads that hold a row
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
    float ps_lo = 0.0f, ps_hi = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2_ftz((s[n][0] - mn_lo) * kLog2e);
      s[n][1] = exp2_ftz((s[n][1] - mn_lo) * kLog2e);
      s[n][2] = exp2_ftz((s[n][2] - mn_hi) * kLog2e);
      s[n][3] = exp2_ftz((s[n][3] - mn_hi) * kLog2e);
      ps_lo += s[n][0] + s[n][1];
      ps_hi += s[n][2] + s[n][3];
    }
    const float a_lo = exp2_ftz((m_lo - mn_lo) * kLog2e);
    const float a_hi = exp2_ftz((m_hi - mn_hi) * kLog2e);
    l_lo = __fmaf_rn(a_lo, l_lo, quad_sum(ps_lo));
    l_hi = __fmaf_rn(a_hi, l_hi, quad_sum(ps_hi));
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int n = 0; n < 2 * NJ; ++n) {
      acc[n][0] *= a_lo;
      acc[n][1] *= a_lo;
      acc[n][2] *= a_hi;
      acc[n][3] *= a_hi;
    }

    // acc += P·V, P = P_hi + P_lo from the score fragments in registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16x2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16x2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, smem_addr(vt_s +
                                    (16 * kk + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * LD +
                                    16 * j + (lane >> 4) * 8));
        mma_bf16(acc[2 * j], ph, bv[0], bv[1]);
        mma_bf16(acc[2 * j], pl, bv[0], bv[1]);
        mma_bf16(acc[2 * j + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[2 * j + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();   // this tile's readers are done before it refills
  }

  const float d_lo = fmaxf(l_lo, 1e-30f);
  const float d_hi = fmaxf(l_hi, 1e-30f);
  __nv_bfloat16* ob = out + (static_cast<int64_t>(b) * s_len * heads + h) * HD;
#pragma unroll
  for (int n = 0; n < 2 * NJ; ++n) {
    const int col = 8 * n + 2 * (lane & 3);
    if (r_lo < s_len)
      *reinterpret_cast<__nv_bfloat162*>(ob + r_lo * q_stride + col) =
          __floats2bfloat162_rn(acc[n][0] / d_lo, acc[n][1] / d_lo);
    if (r_hi < s_len)
      *reinterpret_cast<__nv_bfloat162*>(ob + r_hi * q_stride + col) =
          __floats2bfloat162_rn(acc[n][2] / d_hi, acc[n][3] / d_hi);
  }
}

// --------------------------------------------------------------- launch

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int batch, s_len, t_len, heads, kv_heads, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int NJ, int MI>
int launch_f32(const Args& a) {
  auto kernel = fa_f32_kernel<NJ, MI>;
  const size_t smem = f32_smem_floats<NJ, MI>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.heads, a.batch, (a.s_len + 16 * MI - 1) / (16 * MI));
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.s_len,
      a.t_len, a.heads, a.kv_heads, a.causal, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NJ>
int launch_bf16(const Args& a) {
  auto kernel = fa_bf16_kernel<NJ>;
  const size_t smem = bf16_smem_bytes<NJ>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.heads, a.batch, (a.s_len + kBf16Rows - 1) / kBf16Rows);
  kernel<<<grid, 32 * kBf16Warps, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<__nv_bfloat16*>(a.out), a.s_len, a.t_len, a.heads,
      a.kv_heads, a.causal, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NJ>
int by_rows(const Args& a, int dtype, int rows) {
  if (dtype == 0) {
    if (rows == 64) return launch_f32<NJ, 4>(a);
    if (rows == 32) return launch_f32<NJ, 2>(a);
    if (rows == 16) return launch_f32<NJ, 1>(a);
  } else if (rows == kBf16Rows) {
    return launch_bf16<NJ>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The largest head dim the kernels are built for (a multiple of 16).
int fa_max_head_dim(void) { return kMaxHeadDim; }

// q: (B, S, H, hd), k/v: (B, T, KV, hd), out: (B, S, H, hd), all
// contiguous, f32 (dtype 0) or bf16 (dtype 1, 16-byte aligned).
// H % KV == 0, hd % 16 == 0, hd <= fa_max_head_dim(). window <= 0: no
// window. scale multiplies q·k (the wrapper passes 1/sqrt(hd) rounded to
// f32 once, as the reference's Python float is). block_q: rows of a q
// tile, 16, 32 or 64 for f32, 64 for bf16.
int fa_forward(const void* q, const void* k, const void* v, void* out,
               int dtype, int batch, int s_len, int t_len, int heads,
               int kv_heads, int head_dim, int causal, int window,
               float scale, int block_q, void* stream) {
  if (batch < 1 || s_len < 1 || t_len < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || head_dim % 16 != 0 || head_dim < 16 ||
      head_dim > kMaxHeadDim || batch > 65535 || block_q < 16 ||
      (s_len + block_q - 1) / block_q > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, batch, s_len, t_len, heads, kv_heads,
               causal, window, scale, static_cast<cudaStream_t>(stream)};
  switch (head_dim / 16) {
    case 1: return by_rows<1>(a, dtype, block_q);
    case 2: return by_rows<2>(a, dtype, block_q);
    case 3: return by_rows<3>(a, dtype, block_q);
    case 4: return by_rows<4>(a, dtype, block_q);
    case 5: return by_rows<5>(a, dtype, block_q);
    case 6: return by_rows<6>(a, dtype, block_q);
    case 7: return by_rows<7>(a, dtype, block_q);
    case 8: return by_rows<8>(a, dtype, block_q);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
