// Mamba2 SSD chunk kernel for Hopper (sm_90a), plain C interface.
//
// ssd_chunks_forward replaces the TPU kernel _ssd_chunk_kernel behind
//   ssd_chunks (repro/kernels/mamba2_scan/mamba2_scan.py). For one
//   (batch, head, chunk) of L <= 64 steps it computes, all at f32
//   accuracy:
//     cs      = cumsum(dA)                                   (L,)
//     M[q,k]  = (C_q·B_k) · exp(cs_q − cs_k) · dt_k for k <= q, else 0
//     y       = M x                                          (L, P)
//     w       = exp(cs_{L−1} − cs) · dt,  S_c = (x ⊙ w)ᵀ B    (P, N)
//     cd      = exp(cs_{L−1}),  ecs = exp(cs)
//   The inter-chunk combine stays in plain PyTorch (../ops.py), as it
//   stayed in jnp. It launches on the caller's stream and allocates
//   nothing: the wrapper in ../mamba2_scan.py allocates the outputs,
//   checks shapes, dtypes and contiguity, picks the grid and raises
//   when the launch returns an error.
//
// Bound: per (chunk, head) the work needs L(L+1)/2·(N + P) + L·P·N
//   multiply-adds (the lower triangle of M and of M x, then S_c) against
//   2·L·P + P·N f32 read or written (B and C are shared by the heads of
//   a group), about 22 flops per byte at L = P = N = 64: on f32 FMA the
//   bound is close to even. On the tensor cores (three TF32 products per
//   f32 product) it is the bytes; at L = 1 it is the bytes whatever the
//   route, the (B, S, H, P, N) chunk states. What holds the kernel back
//   is neither: a block's time is its chain of dependent steps. An
//   mma.sync on the H100 takes ~166 cycles to complete and one warp
//   keeps ~8 in flight (scripts/hmma_probe.py), and the short prefills
//   run one block per SM.
//
// Design.
//   - Grid: one block per (batch, group of chunks, head, slice of P).
//     Chunks shorter than 32 steps are packed: a block takes 32 / L of
//     them in its rows (at L = 1, 32 chunks), so that the chunk states
//     stream out of few blocks. P is cut into the fewest slices of at
//     most 64 columns (two at P = 128); each slice's block recomputes M
//     and owns its columns of y and its rows of S_c. A grid in which
//     every block has an SM of its own (the short prefills) takes blocks
//     of two groups of 8 warps: one takes C Bᵀ, M and y while the other
//     takes the cumulative sum, w and S_c, each with its own named
//     barrier. A larger grid takes blocks of one group that does both in
//     turn, two blocks to an SM, so that one block's staging and stores
//     overlap the other's products. mamba2_scan.ssd_grid picks all three.
//     Every element of every output is summed over the same k, in the
//     same order, by the same instructions whatever the slicing of P and
//     the warp groups, so these give the same bits. Packing keeps them
//     where every chunk starts on an 8-row k tile (L = 1, or L a
//     multiple of 8); at other L it regroups a chunk's steps into the
//     mma's 8-step k tiles, which may move the last bits (within the
//     plain version's tolerance). The packing is a rule of L alone, so
//     a shape gets the same bits on any card.
//   - Staging: B and C (rows × N, read by group g = h / (H/G), never
//     copied per head), dt and dA, then x (rows × its P slice) go to
//     padded shared tiles by cp.async (16-byte copies where the rows
//     allow it, 4-byte ones otherwise and for the strided dt and dA), in
//     two commit groups: C Bᵀ starts as soon as the first has landed.
//     Rows and columns past the data are zero-filled by the copy. Shared
//     memory is sized to the block's rows, P slice and N, and the
//     attribute that allows more than 48 KB is set once per device and
//     size, not on every launch.
//   - The cumulative sum runs serially, in order, in f32, as the plain
//     version takes it, by one thread over registers loaded from shared
//     memory in 16-byte pieces, while the warps take C Bᵀ; packed chunks
//     restart it at each chunk.
//   - The three products run on the tensor cores at f32 accuracy:
//     mma.sync m16n8k8 TF32 with each f32 operand split into hi =
//     cvt.rna.tf32(a) and lo = a − hi (read by the tensor core as TF32),
//     the products hi·hi, lo·hi and hi·lo in three accumulators, summed
//     hi·hi + (lo·hi + hi·lo) at the end (3xTF32). A k step adds one mma
//     to each of up to 12 independent chains of a warp. The loops are
//     bound by the latency of their integer and float work more than by
//     the tensor cores, so the split is as short as it can be. Warp w of
//     the C Bᵀ group owns row tile w % 4 of M and of y and half w / 4 of
//     its columns. M = C Bᵀ is computed only over the 8-column tiles that
//     a row tile of y reads (none wholly above the diagonal or before the
//     row tile's chunk), decayed and masked in the epilogue and kept in
//     shared memory for y = M x. S_c = (x ⊙ w)ᵀ B is taken chunk by chunk
//     in 16-row units of up to 32 columns, narrowed until each warp of
//     its group has one.
//   - Stores: y and each chunk's S_c go through shared staging tiles
//     (double-buffered for packed chunks) and out as 16-byte stores,
//     neighbouring threads on neighbouring addresses.
//   - Shared row strides are padded so that the fragment reads hit 32
//     banks: 4 (mod 8) floats for tiles read as [group][thread], 8 or 24
//     (mod 32) for tiles read as [thread][group].

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxChunk = 64;    // largest L, and the most rows of a block
constexpr int kMaxDim = 128;     // largest P and N
constexpr int kMaxSlice = 64;    // most columns of P one block owns
// A block is one group of 8 warps that takes every product in turn, or,
// where every block of the grid has an SM of its own, two: one takes
// C Bᵀ, M and y while the other takes w and S_c.
constexpr int kGroupWarps = 8;
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kTiles = 4;        // most 8-column tiles of one warp's product
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Stride of a tile read as [group][thread] (a = row g, k = col t)
__host__ __device__ constexpr int stride_gt(int cols) {
  return round_up(cols, 8) + 4;
}

// Stride of a tile read as [thread][group], or written as float2 pairs
__host__ __device__ constexpr int stride_tg(int cols) {
  return round_up(cols, 8) % 16 ? round_up(cols, 8) : round_up(cols, 8) + 8;
}

// Shared memory of a block, in floats from the (16-byte aligned) base:
// x, B, a region that holds C and M until y is computed and y's staging
// tile after, the S_c staging tiles, then dt, dA, cs and w (64 each).
struct Layout {
  int rows;                 // rows of the tiles: the block's rows to 16
  int xs, bs, ms, ys, ss;   // row strides of x, B/C, M, y and S_c tiles
  int off_b, off_c, off_m, off_s, stage, off_misc, total;
};

__host__ __device__ inline Layout make_layout(int rows, int ps, int n_dim,
                                              int nbuf) {
  Layout l;
  l.rows = round_up(rows, 16);
  l.xs = stride_tg(ps);
  l.bs = stride_gt(n_dim);
  l.ms = stride_gt(l.rows);
  l.ys = stride_tg(ps);
  l.ss = stride_tg(n_dim);
  l.off_b = l.rows * l.xs;
  l.off_c = l.off_b + l.rows * l.bs;
  l.off_m = l.off_c + l.rows * l.bs;
  const int cm_end = l.off_m + l.rows * l.ms;
  const int y_end = l.off_c + l.rows * l.ys;
  l.off_s = cm_end > y_end ? cm_end : y_end;
  l.stage = round_up(ps, 16) * l.ss;
  l.off_misc = l.off_s + nbuf * l.stage;
  l.total = l.off_misc + 4 * kMaxChunk;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; !valid zero-fills the destination
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; !valid zero-fills the destination
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Barrier of one group: the block's in a one-group block, else named
// barrier `id` (1 or 2; 0 is __syncthreads) of the group's threads
template <int G>
__device__ __forceinline__ void group_sync(int id) {
  if (G == 1)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kGroupThreads)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies a rows × cols tile from shared memory (row stride ss) to device
// memory (row stride ld) with the threads of one group (gtid its thread),
// 16 bytes a copy when vec (cols a multiple of 4, both ends 16-byte
// aligned). Each thread keeps one column piece and walks the rows.
__device__ __forceinline__ void store_tile(float* dst, int64_t ld,
                                           const float* src, int ss,
                                           int rows, int cols, bool vec,
                                           int gtid) {
  const int width = vec ? 4 : 1;
  const int pieces = (cols + width - 1) / width;    // <= kGroupThreads
  const int step = kGroupThreads / pieces;
  const int r0 = gtid / pieces;
  const int c = (gtid - r0 * pieces) * width;
  if (r0 >= step) return;
  for (int r = r0; r < rows; r += step) {
    if (vec)
      *reinterpret_cast<float4*>(dst + r * ld + c) =
          *reinterpret_cast<const float4*>(src + r * ss + c);
    else
      dst[r * ld + c] = src[r * ss + c];
  }
}

// Copies a rows × cols f32 tile whose row r starts at src + r·ld into
// shared memory at dst with row stride ds, zero-filling rows past
// `valid_rows` and columns past `valid_cols` up to `rows` × `cols`.
// vec: src, ld and valid_cols allow 16-byte pieces (cols a multiple of 4).
// Each thread keeps one column piece and walks the rows.
__device__ __forceinline__ void stage_tile(float* dst, int ds,
                                           const float* src, int64_t ld,
                                           int rows, int cols,
                                           int valid_rows, int valid_cols,
                                           bool vec) {
  const int width = vec ? 4 : 1;
  const int pieces = cols / width;          // per row, <= blockDim.x
  const int step = blockDim.x / pieces;     // rows per pass
  const int r0 = threadIdx.x / pieces;
  const int c = (threadIdx.x - r0 * pieces) * width;
  if (r0 >= step) return;
  for (int r = r0; r < rows; r += step) {
    const bool ok = r < valid_rows && c < valid_cols;
    const float* from = ok ? src + r * ld + c : src;
    if (vec)
      cp_async16(dst + r * ds + c, from, ok);
    else
      cp_async4(dst + r * ds + c, from, ok);
  }
}

// v = hi + lo to about 2^-21 relative. hi = cvt.rna.tf32(v) for every
// finite v, by two integer operations (the magnitude bits up at half,
// the low 13 cleared; the instruction adds a NaN test). lo = v − hi is
// exact and goes to the tensor core as f32 bits, which reads its TF32
// part (the low 13 bits dropped), one rounding fewer than cvt.rna(lo)
// at the same accuracy (test_torch_mamba2_scan.py). A NaN v reaches the
// products through lo, the canonical NaN.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));
}

// d += a · b, a 16×8 TF32 (row), b 8×8 TF32 (col), d 16×8 f32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] += a · b[j] for the 8-column tiles j < nt, at f32 accuracy from
// split operands, the three products in three accumulators: acc[j][0]
// takes hi·hi, acc[j][1] lo·hi and acc[j][2] hi·lo (sum3 adds them), so
// that no mma of a k step waits on another.
template <int NT>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[NT][3][4],
                                           const float (&a)[4],
                                           const float (&b)[NT][2], int nt) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
      split_tf32(b[j][0], bh[j][0], bl[j][0]);
      split_tf32(b[j][1], bh[j][1], bl[j][1]);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nt) mma_tf32(acc[j][1], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nt) mma_tf32(acc[j][2], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nt) mma_tf32(acc[j][0], ah, bh[j][0], bh[j][1]);
}

// element e of a tile's product: hi·hi + (lo·hi + hi·lo)
__device__ __forceinline__ float sum3(const float (&acc)[3][4], int e) {
  return acc[0][e] + (acc[1][e] + acc[2][e]);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][3][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][m][e] = 0.0f;
}

template <int G>
__global__ void __launch_bounds__(G * kGroupThreads, 2 / G)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ dA, const float* __restrict__ bm,
                 const float* __restrict__ cm, float* __restrict__ y,
                 float* __restrict__ s_c, float* __restrict__ cd,
                 float* __restrict__ ecs, int s_len, int heads, int groups,
                 int p_dim, int n_dim, int chunk, int cpb, int slices,
                 int ps, int vec_x, int vec_bc, int vec_y, int vec_s) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nbuf = cpb > 1 ? 2 : 1;
  const Layout l = make_layout(cpb * chunk, ps, n_dim, nbuf);
  float* sx = smem;
  float* sb = smem + l.off_b;
  float* sc = smem + l.off_c;
  float* sm = smem + l.off_m;
  float* sy = smem + l.off_c;      // y's staging tile, once C and M are dead
  float* ss = smem + l.off_s;
  float* sdt = smem + l.off_misc;
  float* sda = sdt + kMaxChunk;
  float* scs = sda + kMaxChunk;
  float* sw = scs + kMaxChunk;

  const int nc = s_len / chunk;
  const int ncb = (nc + cpb - 1) / cpb;
  int idx = blockIdx.x;
  const int sp = idx % slices;
  idx /= slices;
  const int h = idx % heads;
  idx /= heads;
  const int c0 = (idx % ncb) * cpb;          // first chunk of the block
  const int b = idx / ncb;
  const int nch = min(cpb, nc - c0);         // chunks of the block
  const int R = nch * chunk;                 // rows of the block
  const int R16 = round_up(R, 16);
  const int p0 = sp * ps;
  const int pv = min(ps, p_dim - p0);        // columns of P owned
  const int n8 = round_up(n_dim, 8);
  const int gi = h / (heads / groups);
  const int tid = threadIdx.x;
  const bool in_m = G == 1 || tid < kGroupThreads;   // C Bᵀ, M and y
  const bool in_s = G == 1 || tid >= kGroupThreads;  // w and S_c
  const int gtid = tid % kGroupThreads;
  const int gwarp = gtid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t row0 = static_cast<int64_t>(b) * s_len +
                       static_cast<int64_t>(c0) * chunk;   // first (b, s)

  // ---- staging in two commit groups: what M needs, then x
  const int64_t bc_off = (row0 * groups + gi) * n_dim;
  const int64_t bc_ld = static_cast<int64_t>(groups) * n_dim;
  stage_tile(sb, l.bs, bm + bc_off, bc_ld, R16, n8, R, n_dim, vec_bc);
  stage_tile(sc, l.bs, cm + bc_off, bc_ld, R16, n8, R, n_dim, vec_bc);
  if (tid < kMaxChunk) {
    const int64_t off = (row0 + tid) * heads + h;
    cp_async4(sdt + tid, tid < R ? dt + off : dt, tid < R);
    cp_async4(sda + tid, tid < R ? dA + off : dA, tid < R);
  }
  cp_async_commit();
  stage_tile(sx, l.xs, x + (row0 * heads + h) * p_dim + p0,
             static_cast<int64_t>(heads) * p_dim, R16, ps, R, pv, vec_x);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // ---- raw C Bᵀ while one thread of the w and S_c group takes the
  // cumulative sum. Warp w of the C Bᵀ group owns row tile rt = w % 4
  // (rows 16·rt..16·rt+15) of M and of y, and half w / 4 of that row
  // tile's columns. The 8-column tiles of M a row tile of y reads run
  // from its first row's chunk start (down to 8) to its last row (up to
  // 8): none lies wholly above the diagonal.
  const int rt = gwarp % 4, half = gwarp / 4;
  const int i0 = 16 * rt;
  const bool has_rows = in_m && i0 < R;
  const int kb = has_rows ? (i0 - i0 % chunk) / 8 : 0;
  const int ke = has_rows ? round_up(min(i0 + 16, R), 8) / 8 : 0;
  const int mh = (ke - kb + 1) / 2;                 // M tiles per half
  const int m0 = kb + half * mh;                    // this warp's first
  const int mt = max(0, min(mh, ke - m0));          // and its count
  float acc[kTiles][3][4];
  zero(acc);
  if (tid == (G - 1) * kGroupThreads) {
    // in order, in f32, restarted at each chunk, over registers (rows
    // past R add the zero-filled tail and are never read)
    float v[kMaxChunk];
#pragma unroll
    for (int i = 0; i < kMaxChunk; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(sda + i);
      v[i] = f.x;
      v[i + 1] = f.y;
      v[i + 2] = f.z;
      v[i + 3] = f.w;
    }
    float run = 0.0f;
    int left = 0;
#pragma unroll
    for (int q = 0; q < kMaxChunk; ++q) {
      const bool first = left == 0;
      run = (first ? 0.0f : run) + v[q];
      left = (first ? chunk : left) - 1;
      scs[q] = run;
    }
  }
  if (mt > 0) {
    for (int k = 0; k < n8; k += 8) {
      float a[4];
      a[0] = sc[(i0 + g) * l.bs + k + t];
      a[1] = sc[(i0 + g + 8) * l.bs + k + t];
      a[2] = sc[(i0 + g) * l.bs + k + t + 4];
      a[3] = sc[(i0 + g + 8) * l.bs + k + t + 4];
      float bv[kTiles][2];
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        if (j < mt) {
          const float* br = sb + (8 * (m0 + j) + g) * l.bs + k + t;
          bv[j][0] = br[0];
          bv[j][1] = br[4];
        }
      }
      mma_3xtf32(acc, a, bv, mt);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // cs complete, x staged

  // ---- w and the decays, by threads 0..R16−1 of the w and S_c group
  const auto compute_w = [&](int q) {
    if (q >= R16) return;
    float wq = 0.0f;
    if (q < R) {
      const int last = q - q % chunk + chunk - 1;
      const float e = expf(scs[q]);
      wq = expf(scs[last] - scs[q]) * sdt[q];
      if (sp == 0) {
        ecs[(row0 + q) * heads + h] = e;
        if (q == last)
          cd[(static_cast<int64_t>(b) * nc + c0 + q / chunk) * heads + h] =
              e;
      }
    }
    sw[q] = wq;
  };
  if (G == 1) compute_w(tid);   // published by the barrier after M

  if (in_m) {
    // ---- M = (C Bᵀ) ⊙ decay ⊙ dt_k to shared memory: decay, dt_k, the
    // causal and chunk mask. Every load first, every exp taken (the
    // masked ones are discarded by the select).
    if (mt > 0) {
      const int qa = i0 + g, qb = qa + 8;
      const int sa = qa - qa % chunk, sb_ = qb - qb % chunk;
      const float csa = scs[qa], csb = scs[qb];
      float csk[kTiles][2], dtk[kTiles][2];
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        if (j < mt) {
          const int k = 8 * (m0 + j) + 2 * t;
          const float2 c2 = *reinterpret_cast<const float2*>(scs + k);
          const float2 d2 = *reinterpret_cast<const float2*>(sdt + k);
          csk[j][0] = c2.x;
          csk[j][1] = c2.y;
          dtk[j][0] = d2.x;
          dtk[j][1] = d2.y;
        }
      }
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        if (j < mt) {
          const int k = 8 * (m0 + j) + 2 * t;
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = e < 2 ? qa : qb;
            const int kk = k + (e & 1);
            const bool keep = q < R && kk >= (e < 2 ? sa : sb_) && kk <= q;
            const float m = sum3(acc[j], e) *
                            expf((e < 2 ? csa : csb) - csk[j][e & 1]) *
                            dtk[j][e & 1];
            v[e] = keep ? m : 0.0f;
          }
          *reinterpret_cast<float2*>(sm + qa * l.ms + k) =
              make_float2(v[0], v[1]);
          *reinterpret_cast<float2*>(sm + qb * l.ms + k) =
              make_float2(v[2], v[3]);
        }
      }
    }
    group_sync<G>(1);   // M (each row tile written by two warps), and w
                        // in a one-group block, complete

    // ---- y = M x: rows of row tile rt, half of the slice's 8-column
    // tiles, k over M's tiles of that row tile
    const int yh = (ps / 8 + 1) / 2;                // y tiles per half
    const int y0 = half * yh;
    const int yt = has_rows ? max(0, min(yh, ps / 8 - y0)) : 0;
    float yacc[kTiles][3][4];
    zero(yacc);
    if (yt > 0) {
      for (int kk = kb; kk < ke; ++kk) {
        const int k = 8 * kk;
        float a[4];
        a[0] = sm[(i0 + g) * l.ms + k + t];
        a[1] = sm[(i0 + g + 8) * l.ms + k + t];
        a[2] = sm[(i0 + g) * l.ms + k + t + 4];
        a[3] = sm[(i0 + g + 8) * l.ms + k + t + 4];
        float bv[kTiles][2];
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
          if (j < yt) {
            const float* xr = sx + (k + t) * l.xs + 8 * (y0 + j) + g;
            bv[j][0] = xr[0];
            bv[j][1] = xr[4 * l.xs];
          }
        }
        mma_3xtf32(yacc, a, bv, yt);
      }
    }
    group_sync<G>(1);   // C and M are dead: the region takes y's tile

    // ---- y through the staging tile, out in 16-byte pieces
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      if (j < yt) {
        const int col = 8 * (y0 + j) + 2 * t;
        *reinterpret_cast<float2*>(sy + (i0 + g) * l.ys + col) =
            make_float2(sum3(yacc[j], 0), sum3(yacc[j], 1));
        *reinterpret_cast<float2*>(sy + (i0 + g + 8) * l.ys + col) =
            make_float2(sum3(yacc[j], 2), sum3(yacc[j], 3));
      }
    }
    group_sync<G>(1);
    store_tile(y + (row0 * heads + h) * p_dim + p0,
               static_cast<int64_t>(heads) * p_dim, sy, l.ys, R, pv, vec_y,
               gtid);
  }
  if (!in_s) return;

  if (G == 2) {
    compute_w(gtid);
    group_sync<G>(2);
  }

  // ---- S_c = (x ⊙ w)ᵀ B per chunk, rows p of the slice and columns
  // n, in units of 16 rows × (8·tpu) columns, tpu <= kTiles tiles,
  // halved until every warp has one where the state allows
  const int ptiles = round_up(ps, 16) / 16;
  int tpu = kTiles;
  while (tpu > 1 && ptiles * ((n8 / 8 + tpu - 1) / tpu) < kGroupWarps)
    tpu /= 2;
  const int ngroups = (n8 / 8 + tpu - 1) / tpu;
  const int units = ptiles * ngroups;
  for (int cc = 0; cc < nch; ++cc) {
    float* stage = ss + (cc % nbuf) * l.stage;
    const int kc0 = cc * chunk, kc1 = kc0 + chunk;   // the chunk's rows
    for (int u = gwarp; u < units; u += kGroupWarps) {
      const int pb = 16 * (u / ngroups);
      const int nb = 8 * tpu * (u % ngroups);
      const int ntn = min(tpu, (n8 - nb) / 8);  // 8-column tiles of S_c
      float sacc[kTiles][3][4];
      zero(sacc);
      for (int k = kc0 - kc0 % 8; k < kc1; k += 8) {
        const int ka = k + t, kb4 = k + t + 4;
        const bool ina = ka >= kc0 && ka < kc1;
        const bool inb = kb4 >= kc0 && kb4 < kc1;
        const bool ra = pb + g < pv, rb = pb + g + 8 < pv;
        float a[4];
        a[0] = ina && ra ? __fmul_rn(sx[ka * l.xs + pb + g], sw[ka]) : 0.0f;
        a[1] = ina && rb ? __fmul_rn(sx[ka * l.xs + pb + g + 8], sw[ka])
                         : 0.0f;
        a[2] = inb && ra ? __fmul_rn(sx[kb4 * l.xs + pb + g], sw[kb4])
                         : 0.0f;
        a[3] = inb && rb ? __fmul_rn(sx[kb4 * l.xs + pb + g + 8], sw[kb4])
                         : 0.0f;
        float bv[kTiles][2];
#pragma unroll
        for (int j = 0; j < kTiles; ++j) {
          if (j < ntn) {
            const float* br = sb + ka * l.bs + nb + 8 * j + g;
            bv[j][0] = br[0];
            bv[j][1] = br[4 * l.bs];
          }
        }
        mma_3xtf32(sacc, a, bv, ntn);
      }
#pragma unroll
      for (int j = 0; j < kTiles; ++j) {
        if (j < ntn) {
          const int col = nb + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(stage + (pb + g) * l.ss + col) =
              make_float2(sum3(sacc[j], 0), sum3(sacc[j], 1));
          *reinterpret_cast<float2*>(stage + (pb + g + 8) * l.ss + col) =
              make_float2(sum3(sacc[j], 2), sum3(sacc[j], 3));
        }
      }
    }
    group_sync<G>(2);
    // the slice's rows of this chunk's state are pv·N contiguous floats;
    // the other staging buffer takes the next chunk, so no second barrier
    store_tile(s_c + ((static_cast<int64_t>(b) * nc + c0 + cc) * heads + h) *
                         static_cast<int64_t>(p_dim) * n_dim +
                   static_cast<int64_t>(p0) * n_dim,
               n_dim, stage, l.ss, pv, n_dim, vec_s, gtid);
  }
}

// Bytes of dynamic shared memory already allowed on each device, per
// instantiation
int g_allowed[2][kMaxDevices];
std::mutex g_allowed_mu;

template <int G>
cudaError_t allow_smem(size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& allowed = g_allowed[G - 1][dev];
  std::lock_guard<std::mutex> lock(g_allowed_mu);
  if (static_cast<size_t>(allowed) >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(ssd_chunk_kernel<G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = static_cast<int>(bytes);
  return err;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int G>
int launch(const float* x, const float* dt, const float* dA, const float* bm,
           const float* cm, float* y, float* s_c, float* cd, float* ecs,
           int64_t blocks, size_t smem, int s_len, int heads, int groups,
           int p_dim, int n_dim, int chunk, int cpb, int slices, int ps,
           cudaStream_t stream) {
  const cudaError_t err = allow_smem<G>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool p4 = p_dim % 4 == 0, n4 = n_dim % 4 == 0;
  ssd_chunk_kernel<G><<<static_cast<unsigned int>(blocks),
                        G * kGroupThreads, smem, stream>>>(
      x, dt, dA, bm, cm, y, s_c, cd, ecs, s_len, heads, groups, p_dim, n_dim,
      chunk, cpb, slices, ps, p4 && aligned16(x),
      n4 && aligned16(bm) && aligned16(cm), p4 && aligned16(y),
      n4 && aligned16(s_c));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest chunk length, the largest P and N, and the most columns
// of P one block owns.
int ssd_max_chunk(void) { return kMaxChunk; }
int ssd_max_dim(void) { return kMaxDim; }
int ssd_max_slice(void) { return kMaxSlice; }

// x: (B, S, H, P), dt/dA: (B, S, H), bm/cm: (B, S, G, N), all f32 and
// contiguous; H % G == 0, S % chunk == 0, 1 <= chunk <= 64, P, N <= 128.
// Outputs y: (B, S, H, P), s_c: (B, S/chunk, H, P, N), cd: (B, S/chunk,
// H), ecs: (B, S, H), f32. chunks_per_block (cpb) chunks share a block
// (cpb·chunk <= 64); p_split cuts P into slices of ceil(P / p_split)
// columns rounded up to 8, at most 64; two_groups: blocks of two groups.
int ssd_chunks_forward(const float* x, const float* dt, const float* dA,
                       const float* bm, const float* cm, float* y,
                       float* s_c, float* cd, float* ecs, int batch,
                       int s_len, int heads, int groups, int p_dim,
                       int n_dim, int chunk, int chunks_per_block,
                       int p_split, int two_groups, void* stream) {
  if (batch < 1 || s_len < 1 || heads < 1 || groups < 1 ||
      heads % groups != 0 || chunk < 1 || chunk > kMaxChunk ||
      s_len % chunk != 0 || p_dim < 1 || p_dim > kMaxDim || n_dim < 1 ||
      n_dim > kMaxDim || chunks_per_block < 1 ||
      chunks_per_block * chunk > kMaxChunk || p_split < 1 ||
      p_split > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ps = round_up((p_dim + p_split - 1) / p_split, 8);
  if (ps > kMaxSlice) return static_cast<int>(cudaErrorInvalidValue);
  const int slices = (p_dim + ps - 1) / ps;
  const int64_t nc = s_len / chunk;
  const int64_t blocks = static_cast<int64_t>(batch) *
                         ((nc + chunks_per_block - 1) / chunks_per_block) *
                         heads * slices;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = make_layout(chunks_per_block * chunk, ps, n_dim,
                               chunks_per_block > 1 ? 2 : 1);
  const size_t smem = sizeof(float) * static_cast<size_t>(l.total);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (two_groups)
    return launch<2>(x, dt, dA, bm, cm, y, s_c, cd, ecs, blocks, smem, s_len,
                     heads, groups, p_dim, n_dim, chunk, chunks_per_block,
                     slices, ps, s);
  return launch<1>(x, dt, dA, bm, cm, y, s_c, cd, ecs, blocks, smem, s_len,
                   heads, groups, p_dim, n_dim, chunk, chunks_per_block,
                   slices, ps, s);
}

}  // extern "C"
