// Mamba2 SSD chunk kernel for Hopper (sm_90a), plain C interface.
//
// ssd_chunks_forward replaces the TPU kernel _ssd_chunk_kernel behind
//   ssd_chunks (repro/kernels/mamba2_scan/mamba2_scan.py). For one
//   (batch, head, chunk) of L <= 64 steps it computes, all in f32:
//     cs      = cumsum(dA)                                   (L,)
//     M[q,k]  = (C_q·B_k) · exp(cs_q − cs_k) · dt_k for k <= q, else 0
//     y       = M x                                          (L, P)
//     w       = exp(cs_{L−1} − cs) · dt,  S_c = (x ⊙ w)ᵀ B    (P, N)
//     cd      = exp(cs_{L−1}),  ecs = exp(cs)
//   The inter-chunk combine stays in plain PyTorch (../ops.py), as it
//   stayed in jnp. It launches on the caller's stream and allocates
//   nothing: the wrapper in ../mamba2_scan.py allocates the outputs,
//   checks shapes, dtypes and contiguity, and raises when the launch
//   returns an error.
//
// Bound: per (chunk, head) the work needs L(L+1)/2·(N + P) + L·P·N
//   multiply-adds (the lower triangle of M and of M x, then S_c) against
//   2·L·P + P·N f32 read or written (B and C are shared by the heads of
//   a group), about 22 flops per byte at L = P = N = 64: close to the
//   card's 20 flops per byte of f32 FMA against HBM, so the bound is
//   close to even, operations by a little. It keeps to f32 FMA (no
//   TF32).
//
// Design: one block of 256 threads per (chunk, head, batch), the TPU's
//   (B, H, nc) grid. x, B and C of the chunk are staged in dynamic
//   shared memory (B and C with a padded row stride N + 1), with the
//   L×L matrix M; that is 67 KB at L = P = N = 64, over the 48 KB that
//   static shared memory allows. B and C are read by group, g = h /
//   (H / G), so nothing is copied per head. The cumulative sum is taken
//   by one thread in order, in f32, as the plain version takes it, over
//   dA staged in shared memory first: summed straight from device
//   memory, each step waited on its own load.
//   Thread (tr, tc) = (tid / 16, tid % 16) computes M at rows tr + 16i
//   and columns tc + 16j (i, j < 4), then y at rows tr + 16i and dims
//   tc + 16j (j < 8), then S_c at dims tr + 16i (i < 8) and states
//   tc + 16j (j < 8); guards take any L <= 64 (ops.ssd_scan picks L
//   from 1 to 64 so that it divides S) and any P, N <= 128, and a
//   warp-uniform branch skips the column groups past P and N (at
//   P = N = 64 half of the y sums and three quarters of the S_c sums).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 64;
constexpr int kMaxDim = 128;     // largest P and N
constexpr int kThreads = 256;
constexpr int kMS = kMaxChunk + 1;   // padded row stride of M

size_t smem_bytes(int chunk, int p_dim, int n_dim) {
  return sizeof(float) *
         (static_cast<size_t>(chunk) * p_dim +              // x
          2 * static_cast<size_t>(chunk) * (n_dim + 1) +    // B, C
          static_cast<size_t>(kMaxChunk) * kMS +            // M
          4 * kMaxChunk);                                   // dA, cs, dt, w
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ dA, const float* __restrict__ bm,
                 const float* __restrict__ cm, float* __restrict__ y,
                 float* __restrict__ s_c, float* __restrict__ cd,
                 float* __restrict__ ecs, int s_len, int heads, int groups,
                 int p_dim, int n_dim, int chunk) {
  extern __shared__ float smem[];
  const int NS = n_dim + 1;
  float* sx = smem;
  float* sb = sx + chunk * p_dim;
  float* sc = sb + chunk * NS;
  float* sm = sc + chunk * NS;
  float* sda = sm + kMaxChunk * kMS;
  float* scs = sda + kMaxChunk;
  float* sdt = scs + kMaxChunk;
  float* sw = sdt + kMaxChunk;

  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = s_len / chunk;
  const int g = h / (heads / groups);
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int pj = (p_dim + 15) / 16;    // 16-wide column groups in use
  const int nj = (n_dim + 15) / 16;
  const int64_t row0 = static_cast<int64_t>(b) * s_len +
                       static_cast<int64_t>(c) * chunk;   // first (b, s)

  for (int i = tid; i < chunk * p_dim; i += kThreads) {
    const int q = i / p_dim, p = i - q * p_dim;
    sx[i] = x[((row0 + q) * heads + h) * p_dim + p];
  }
  for (int i = tid; i < chunk * n_dim; i += kThreads) {
    const int q = i / n_dim, n = i - q * n_dim;
    const int64_t off = ((row0 + q) * groups + g) * n_dim + n;
    sb[q * NS + n] = bm[off];
    sc[q * NS + n] = cm[off];
  }
  if (tid < chunk) {
    sdt[tid] = dt[(row0 + tid) * heads + h];
    sda[tid] = dA[(row0 + tid) * heads + h];
  }
  __syncthreads();
  if (tid == 0) {      // in order, from shared memory
    float acc = 0.0f;
    for (int q = 0; q < chunk; ++q) {
      acc += sda[q];
      scs[q] = acc;
    }
  }
  __syncthreads();

  const float cs_last = scs[chunk - 1];
  if (tid < chunk) {
    const float e = expf(scs[tid]);
    ecs[(row0 + tid) * heads + h] = e;
    sw[tid] = expf(cs_last - scs[tid]) * sdt[tid];
  }
  if (tid == 0)
    cd[(static_cast<int64_t>(b) * nc + c) * heads + h] = expf(cs_last);

  // M = (C Bᵀ) ⊙ decay ⊙ dt_k, zero above the diagonal
  {
    float cb[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cb[i][j] = 0.0f;
    for (int n = 0; n < n_dim; ++n) {
      float a[4], e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = tr + 16 * i;
        a[i] = q < chunk ? sc[q * NS + n] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = tc + 16 * j;
        e[j] = k < chunk ? sb[k * NS + n] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cb[i][j] = fmaf(a[i], e[j], cb[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = tc + 16 * j;
        float mv = 0.0f;
        if (q < chunk && k <= q) mv = cb[i][j] * expf(scs[q] - scs[k]) * sdt[k];
        sm[q * kMS + k] = mv;
      }
    }
  }
  __syncthreads();

  // y = M x
  {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < chunk; ++k) {
      float a[4], e[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm[(tr + 16 * i) * kMS + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = tc + 16 * j;
        e[j] = p < p_dim ? sx[k * p_dim + p] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < pj) acc[i][j] = fmaf(a[i], e[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = tr + 16 * i;
      if (q >= chunk) continue;
      float* yr = y + ((row0 + q) * heads + h) * p_dim;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = tc + 16 * j;
        if (p < p_dim) yr[p] = acc[i][j];
      }
    }
  }

  // S_c = (x ⊙ w)ᵀ B: rows p, columns n
  {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < chunk; ++k) {
      const float wk = sw[k];
      float a[8], e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = tr + 16 * i;
        a[i] = p < p_dim ? sx[k * p_dim + p] * wk : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tc + 16 * j;
        e[j] = n < n_dim ? sb[k * NS + n] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (i < pj && j < nj) acc[i][j] = fmaf(a[i], e[j], acc[i][j]);
    }
    float* out = s_c + ((static_cast<int64_t>(b) * nc + c) * heads + h) *
                           static_cast<int64_t>(p_dim) * n_dim;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = tr + 16 * i;
      if (p >= p_dim) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tc + 16 * j;
        if (n < n_dim) out[p * n_dim + n] = acc[i][j];
      }
    }
  }
}

}  // namespace

extern "C" {

// The largest chunk length and the largest P and N the kernel takes.
int ssd_max_chunk(void) { return kMaxChunk; }
int ssd_max_dim(void) { return kMaxDim; }

// x: (B, S, H, P), dt/dA: (B, S, H), bm/cm: (B, S, G, N), all f32 and
// contiguous; H % G == 0, S % chunk == 0, 1 <= chunk <= 64, P, N <= 128.
// Outputs y: (B, S, H, P), s_c: (B, S/chunk, H, P, N), cd: (B, S/chunk,
// H), ecs: (B, S, H), f32.
int ssd_chunks_forward(const float* x, const float* dt, const float* dA,
                       const float* bm, const float* cm, float* y,
                       float* s_c, float* cd, float* ecs, int batch,
                       int s_len, int heads, int groups, int p_dim,
                       int n_dim, int chunk, void* stream) {
  if (batch < 1 || batch > 65535 || s_len < 1 || heads < 1 ||
      heads > 65535 || groups < 1 || heads % groups != 0 || chunk < 1 ||
      chunk > kMaxChunk || s_len % chunk != 0 || p_dim < 1 ||
      p_dim > kMaxDim || n_dim < 1 || n_dim > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(chunk, p_dim, n_dim);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(s_len / chunk, heads, batch);
  ssd_chunk_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      x, dt, dA, bm, cm, y, s_c, cd, ecs, s_len, heads, groups, p_dim, n_dim,
      chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
