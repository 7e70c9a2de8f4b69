// Flash attention for Hopper (sm_90a), plain C interface.
//
// fa_forward replaces the TPU kernel _fa_kernel behind flash_attention
//   (repro/kernels/flash_attention/flash_attention.py): causal or
//   bidirectional GQA attention with an optional sliding window, softmax
//   computed online over key tiles with f32 running max m, sum l and
//   accumulator acc, output in q's dtype (f32 or bf16). It launches on
//   the caller's stream and allocates nothing: the wrapper in
//   ../flash_attention.py allocates the output, checks shapes, dtypes
//   and contiguity, and raises when the launch returns an error.
//
// Bound: at the prefill shapes of the LM zoo the kernel does about 4·hd
//   flops per visible (query, key) pair and reads each q, k, v and
//   output element once, so it is bound by operations, not bytes. It
//   keeps to f32 FMA on the CUDA cores: the port turns TF32 off to hold
//   the reference's f32 numerics, so tensor cores (wgmma) and TMA are
//   later work.
//
// Design: one block of 256 threads per (q tile of 64 rows, head,
//   batch). The q tile sits in shared memory for the whole sweep; each
//   key tile of 64 rows is staged in shared memory, K with a padded row
//   stride (hd + 1) so that 16 threads reading 16 different keys at one
//   dim hit 16 different banks. Thread (tr, tc) = (tid / 16, tid % 16)
//   owns rows tr + 16i (i < 4): the 4 × 4 scores at keys tc + 16j and
//   the output dims tc + 16j (j < hd / 16). hd is any multiple of 16 up
//   to 128 (64 for TinyLlama, 112 for Zamba2's shared block); it is a
//   template parameter so the accumulator stays in registers. Row max
//   and row sum reduce over the 16 threads of a row with warp shuffles,
//   so m and l need no shared memory. Query head h reads KV head
//   h / (H / KV): no copy of K/V per query head.
//
// Masked scores are −1e30, not −inf, and m starts at −1e30, as on the
//   TPU: a wholly masked tile adds exp(0) terms that the next real tile
//   wipes out through alpha = exp(−1e30 − m) = 0, and no NaN can appear.
//   Key tiles wholly above the diagonal (causal) or wholly before the
//   window of the tile's first row are skipped: the first add exact
//   zeros, the second are wiped out, so skipping them changes no bit.
//   The final division uses max(l, 1e−30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kMaxHeadDim = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <int NJ>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kBlockQ) * (16 * NJ + 1) +   // q
         static_cast<size_t>(kBlockK) * (16 * NJ + 1) +   // k
         static_cast<size_t>(kBlockK) * (16 * NJ) +       // v
         static_cast<size_t>(kBlockQ) * (kBlockK + 1);    // p
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int s_len,
          int t_len, int heads, int kv_heads, int causal, int window,
          float scale) {
  constexpr int HD = 16 * NJ;
  constexpr int QS = HD + 1;           // padded row stride of q and k
  constexpr int PS = kBlockK + 1;      // padded row stride of p
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kBlockQ * QS;
  float* sv = sk + kBlockK * QS;
  float* sp = sv + kBlockK * HD;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    const int s = q0 + r;
    sq[r * QS + d] =
        s < s_len ? to_f32(q[((static_cast<int64_t>(b) * s_len + s) * heads +
                              h) * HD + d])
                  : 0.0f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  // key tiles that can hold a visible key for some row of this tile
  const int last_row = min(q0 + kBlockQ, s_len) - 1;
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
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      sk[r * QS + d] = kv;
      sv[r * HD + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sq[(tr + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = sk[(tc + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc + 16 * j;
        bool ok = col < t_len;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && row - col < window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
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
      l[i] = alpha * l[i] + row_sum16(ps);
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sp[(tr + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sv[c * HD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<int64_t>(b) * s_len + row) * heads + h) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[tc + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int s_len, int t_len, int heads, int kv_heads, int causal,
           int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<NJ>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s_len + kBlockQ - 1) / kBlockQ, heads, batch);
  fa_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s_len, t_len, heads,
      kv_heads, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             int batch, int s_len, int t_len, int heads, int kv_heads,
             int head_dim, int causal, int window, float scale,
             cudaStream_t stream) {
  switch (head_dim / 16) {
#define FA_CASE(NJ)                                                        \
  case NJ:                                                                 \
    return launch<T, NJ>(q, k, v, out, batch, s_len, t_len, heads,        \
                         kv_heads, causal, window, scale, stream);
    FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4)
    FA_CASE(5) FA_CASE(6) FA_CASE(7) FA_CASE(8)
#undef FA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The largest head dim the kernel is built for (a multiple of 16).
int fa_max_head_dim(void) { return kMaxHeadDim; }

// q: (B, S, H, hd), k/v: (B, T, KV, hd), out: (B, S, H, hd), all
// contiguous, f32 (dtype 0) or bf16 (dtype 1). H % KV == 0,
// hd % 16 == 0, hd <= fa_max_head_dim(). window <= 0: no window. scale
// multiplies q·k (the wrapper passes 1/sqrt(hd) rounded to f32 once, as
// the reference's Python float is).
int fa_forward(const void* q, const void* k, const void* v, void* out,
               int dtype, int batch, int s_len, int t_len, int heads,
               int kv_heads, int head_dim, int causal, int window,
               float scale, void* stream) {
  if (batch < 1 || s_len < 1 || t_len < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || head_dim % 16 != 0 || head_dim < 16 ||
      head_dim > kMaxHeadDim || heads > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, batch, s_len, t_len, heads,
                           kv_heads, head_dim, causal, window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, batch, s_len, t_len, heads,
                                   kv_heads, head_dim, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
