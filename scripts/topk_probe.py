#!/usr/bin/env python3
"""Times the top-k select designs of ``topk_mask`` on the card.

    python3 scripts/topk_probe.py

``topk_mask`` keeps exactly k slots of each 128-element chunk by |x|
(one warp a chunk, 4 elements a lane) and finds the k-th largest |x| by
a binary search on its bit pattern (``csrc/compress.cu``). This script
holds the kernel, through its C entry point, against the designs it was
chosen over, each in SELECT_SOURCE below, one warp a chunk but the
last:

  radix 32 (the parent's kernel)
                   32 radix passes from bit 31, each an and, a compare
                   and an add per element and a warp sum, and the tie
                   scan on every chunk;
  radix early      the same passes from bit 30, stopping once the
                   candidates that share the prefix number exactly the
                   slots left (their least is then the threshold);
  search, ballot counts
                   the kernel's search (float compare against the probe,
                   NaN counted apart, a start below the bits the chunk's
                   largest and smallest |x| share, the early stop), its
                   counts taken by one ballot and popcount per element
                   slot instead of a warp sum;
  search, two bits a step
                   three probes a step, their counts packed 8 bits apart
                   into one warp sum;
  search, set.ge counts
                   each compare by set.ge.u32.f32 (0 or all ones in a
                   register) in place of the compiler's compare and
                   select;
  search, integer counts
                   each count taken on the bits as the sign of probe − 1
                   − bits (NaN, whose bits lie above every probe the
                   search takes, counts itself);
  search, tie scan always run
                   the warp prefix sum over the elements equal to the
                   threshold on every chunk, as the parent ran it (the
                   kernel runs it only when they exceed the slots left);
  search, resident warps walking
                   a grid of at most the warps the card holds at once,
                   each walking many chunks and loading the next before
                   it selects in the current one.

All but the first and the last but one skip the tie scan as the kernel
does. Each runs at each (C, N) of SHAPES with k = K on round-delta-like
data (normals with a scale per chunk, one zero chunk a row, as
chip_smoke.py makes them), is held bitwise to the plain version, and is
timed in ROUNDS interleaved rounds (chip_smoke.py's device_ms, median
device time of 60 launches). One JSON line per shape lists each
variant's times in µs, the bytes' bound and the kernel's mean search
steps a chunk (the rule of tests/test_torch_select.py's emulation,
counted here with torch on the card's data).
Builds the kernel library and SELECT_SOURCE with nvcc; needs a GPU.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SHAPES = ((10, 71808), (10, 2 ** 20), (10, 2 ** 24))
K = 32
ROUNDS = 3
VARIANTS = {"radix 32 (the parent's kernel)": 0, "radix early": 1,
            "search, ballot counts": 2, "search, two bits a step": 3,
            "search, set.ge counts": 6, "search, integer counts": 9,
            "search, tie scan always run": 4,
            "search, resident warps walking": 5}

SELECT_SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kChunksPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// one chunk (lane holds elements 4 lane .. 4 lane + 3 in v) to dst.
// MODE: 0 the parent's 32 radix passes, 1 radix passes stopping early,
// 2 the search with ballot counts, 3 two bits a step, 4 the kernel's
// search, 6 set.ge counts, 9 integer counts. SKIP: the tie scan runs
// only when more elements equal the threshold than slots are left.
template <int MODE, bool SKIP>
__device__ __forceinline__ void select_chunk(const float4 v, float* dst,
                                             int k, int lane) {
  const float xs[4] = {v.x, v.y, v.z, v.w};
  float a[4];
  unsigned bits[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = fabsf(xs[i]);
    bits[i] = __float_as_uint(a[i]);
  }
  float thr;
  if (MODE <= 1) {
    // radix select on the bits (NaN's bits sort above +inf)
    unsigned prefix = 0u, mask = 0u;
    int remaining = k, candidates = kLanes;
    for (int bit = MODE == 0 ? 31 : 30; bit >= 0; --bit) {
      if (MODE == 1 && candidates == remaining) break;
      const unsigned probe = 1u << bit;
      const unsigned want = prefix | probe;
      const unsigned m = mask | probe;
      unsigned c = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) c += (bits[i] & m) == want;
      c = __reduce_add_sync(kFull, c);
      if (static_cast<int>(c) >= remaining) {
        prefix = want;
        candidates = static_cast<int>(c);
      } else {
        remaining -= static_cast<int>(c);
        candidates -= static_cast<int>(c);
      }
      mask = m;
    }
    // the least bit pattern among the candidates (all of them when the
    // passes ran out: they are then equal)
    unsigned least = 0xffffffffu;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if ((bits[i] & mask) == prefix) least = min(least, bits[i]);
    thr = __uint_as_float(__reduce_min_sync(kFull, least));
  } else {
    int nan = 0;
    float top = 0.0f, bottom = INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      nan += a[i] != a[i];
      top = fmaxf(top, a[i]);
      bottom = fminf(bottom, a[i]);
    }
    nan = __reduce_add_sync(kFull, nan);
    thr = __uint_as_float(0x7fc00000u);
    if (nan < k) {
      const unsigned hi = __reduce_max_sync(kFull, __float_as_uint(top));
      const unsigned lo = __reduce_min_sync(kFull, __float_as_uint(bottom));
      int bit = 31 - __clz(hi ^ lo);
      unsigned prefix = bit < 0 ? hi : hi & ~((2u << bit) - 1u);
      int at_or_above = kLanes;
      if (MODE != 3) {
        for (; bit >= 0 && at_or_above != k; --bit) {
          const unsigned probe = prefix | (1u << bit);
          const float p = __uint_as_float(probe);
          int c = 0;
          if (MODE == 2) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              c += __popc(__ballot_sync(kFull, a[i] >= p));
          } else if (MODE == 9) {
            // bits >= probe as the sign of probe - 1 - bits (NaN's bits
            // lie above every probe the search takes, so NaN counts)
            const unsigned below = probe - 1u;
            unsigned n = 0u;
#pragma unroll
            for (int i = 0; i < 4; ++i) n += (below - bits[i]) >> 31;
            c = __reduce_add_sync(kFull, static_cast<int>(n)) - nan;
          } else if (MODE == 6) {
            // set.ge writes 0xffffffff (true) or 0 into a register
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              unsigned ge;
              asm("set.ge.u32.f32 %0, %1, %2;" : "=r"(ge) : "f"(a[i]), "f"(p));
              c -= static_cast<int>(ge);
            }
            c = __reduce_add_sync(kFull, c);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) c += a[i] >= p;
            c = __reduce_add_sync(kFull, c);
          }
          c += nan;
          if (c >= k) {
            prefix = probe;
            at_or_above = c;
          }
        }
      } else {
        // two bits a step (one when a single bit is left)
        for (; bit >= 0 && at_or_above != k; bit -= 2) {
          const int low = bit > 0 ? bit - 1 : 0;
          const unsigned q1 = prefix | (1u << low);
          const unsigned q2 = bit > 0 ? prefix | (2u << low) : 0xffffffffu;
          const unsigned q3 = bit > 0 ? prefix | (3u << low) : 0xffffffffu;
          const float p1 = __uint_as_float(q1), p2 = __uint_as_float(q2),
                      p3 = __uint_as_float(q3);
          unsigned c = 0u;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            c += (a[i] >= p1 ? 1u : 0u) + (a[i] >= p2 ? 256u : 0u) +
                 (a[i] >= p3 ? 65536u : 0u);
          c = __reduce_add_sync(kFull, c);
          const int c1 = static_cast<int>(c & 255u) + nan;
          const int c2 = static_cast<int>((c >> 8) & 255u) + nan;
          const int c3 = static_cast<int>(c >> 16) + nan;
          if (c3 >= k) {
            prefix = q3;
            at_or_above = c3;
          } else if (c2 >= k) {
            prefix = q2;
            at_or_above = c2;
          } else if (c1 >= k) {
            prefix = q1;
            at_or_above = c1;
          }
        }
      }
      const float p = __uint_as_float(prefix);
      float least = INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (a[i] >= p) least = fminf(least, a[i]);
      thr = __uint_as_float(__reduce_min_sync(kFull, __float_as_uint(least)));
    }
  }

  unsigned n_greater = 0u, n_eq = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    n_greater += a[i] > thr;
    n_eq += a[i] == thr;
  }
  if (SKIP) {
    // both counts in one warp sum; no rank is needed when every element
    // equal to the threshold is kept
    const unsigned both = __reduce_add_sync(kFull, n_greater | (n_eq << 16));
    n_greater = both & 0xffffu;
    if (static_cast<int>(n_greater + (both >> 16)) <= k) {
      float r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = a[i] >= thr ? xs[i] : 0.0f;
      reinterpret_cast<float4*>(dst)[lane] =
          make_float4(r[0], r[1], r[2], r[3]);
      return;
    }
  } else {
    n_greater = __reduce_add_sync(kFull, n_greater);
  }
  unsigned scan = n_eq;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, scan, off);
    if (lane >= off) scan += y;
  }
  int rank = static_cast<int>(scan - n_eq);
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
  reinterpret_cast<float4*>(dst)[lane] = make_float4(r[0], r[1], r[2], r[3]);
}

template <int MODE, bool SKIP>
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ x, float* __restrict__ out,
              int64_t chunks, int k) {
  const int64_t chunk =
      static_cast<int64_t>(blockIdx.x) * kChunksPerBlock + (threadIdx.x >> 5);
  if (chunk >= chunks) return;
  const int lane = threadIdx.x & 31;
  const float4 v =
      __ldcs(reinterpret_cast<const float4*>(x + chunk * kLanes) + lane);
  select_chunk<MODE, SKIP>(v, out + chunk * kLanes, k, lane);
}

// the kernel's select in a grid of resident warps, each walking the
// chunks chunk, chunk + warps, ... and loading the next chunk before it
// selects in the current one
__global__ void __launch_bounds__(kThreads)
walk_kernel(const float* __restrict__ x, float* __restrict__ out,
            int64_t chunks, int k) {
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kChunksPerBlock;
  int64_t chunk =
      static_cast<int64_t>(blockIdx.x) * kChunksPerBlock + (threadIdx.x >> 5);
  if (chunk >= chunks) return;
  const int lane = threadIdx.x & 31;
  float4 v = __ldcs(reinterpret_cast<const float4*>(x + chunk * kLanes) +
                    lane);
  for (;;) {
    const int64_t next = chunk + warps;
    float4 ahead = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (next < chunks)
      ahead = __ldcs(reinterpret_cast<const float4*>(x + next * kLanes) +
                     lane);
    select_chunk<4, true>(v, out + chunk * kLanes, k, lane);
    if (next >= chunks) break;
    chunk = next;
    v = ahead;
  }
}

}  // namespace

extern "C" int select_launch(const float* x, float* out, int64_t chunks,
                             int k, int mode, int sms, void* stream) {
  if (k < 1 || k > kLanes) return static_cast<int>(cudaErrorInvalidValue);
  unsigned int blocks = static_cast<unsigned int>(
      (chunks + kChunksPerBlock - 1) / kChunksPerBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
#define SELECT_CASE(m, M, SKIP)                                          \
    case m:                                                              \
      select_kernel<M, SKIP><<<blocks, kThreads, 0, s>>>(x, out, chunks, k); \
      break;
    SELECT_CASE(0, 0, false)
    SELECT_CASE(1, 1, true)
    SELECT_CASE(2, 2, true)
    SELECT_CASE(3, 3, true)
    SELECT_CASE(4, 4, false)
    SELECT_CASE(6, 6, true)
    SELECT_CASE(9, 9, true)
#undef SELECT_CASE
    case 5: {
      int resident = 0;
      const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &resident, walk_kernel, kThreads, 0);
      if (err != cudaSuccess) return static_cast<int>(err);
      const unsigned int cap = static_cast<unsigned int>(sms * resident);
      if (blocks > cap) blocks = cap;
      walk_kernel<<<blocks, kThreads, 0, s>>>(x, out, chunks, k);
      break;
    }
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def select_library():
    from repro_torch.kernels import build
    src = build.BUILD_DIR.parent / "probe" / "topk_select.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(SELECT_SOURCE)
    lib = build.load_library("topk_select", [src])
    vp = ctypes.c_void_p
    lib.select_launch.argtypes = [vp, vp, ctypes.c_int64, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, vp]
    lib.select_launch.restype = ctypes.c_int
    return lib, build.library_path("topk_select", [src]).with_suffix(".log")


def search_steps(torch, x, k):
    """Mean search steps a chunk of the kernel's select (the rule of
    tests/test_torch_select.py's emulation) on x."""
    a = x.reshape(-1, 128).abs()
    nan = torch.isnan(a)
    n_nan = nan.sum(-1)
    bits = a.view(torch.int32)
    top = torch.where(nan, 0, bits).amax(-1)
    bottom = torch.where(nan, 0x7F800000, bits).amin(-1)
    diff = top ^ bottom
    start = torch.full_like(diff, -1)
    for b in range(31):
        start = torch.where((diff >> b) & 1 == 1, b, start)
    low = torch.where(start >= 0, (2 << start.clamp(min=0)) - 1, 0)
    prefix = top & ~low
    at_or_above = torch.full_like(n_nan, 128)
    steps = torch.zeros_like(n_nan)
    for b in range(30, -1, -1):
        active = (b <= start) & (at_or_above != k) & (n_nan < k)
        probe = prefix | (1 << b)
        c = (a >= probe.view(torch.float32)[:, None]).sum(-1) + n_nan
        take = active & (c >= k)
        prefix = torch.where(take, probe, prefix)
        at_or_above = torch.where(take, c, at_or_above)
        steps += active.long()
    return float(steps.float().mean())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("topk_probe: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import device_ms, peaks
    from repro_torch.kernels import build, common
    from repro_torch.kernels.compress import compress as tcomp
    from repro_torch.kernels.compress import ref as tcref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    bw = peaks(torch.cuda.get_device_name(0))[0]
    lib = tcomp.library()
    slib, slog = select_library()
    for log in (build.library_path("compress", tcomp.SOURCES)
                .with_suffix(".log"), slog):
        print("\n".join(line for line in log.read_text().splitlines()
                        if "Used" in line or "spill" in line
                        or "error" in line))
    stream = torch.cuda.current_stream().cuda_stream
    sms = common.sm_count(0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for C, N in SHAPES:
        M = N // 128
        scale = torch.exp(3 * torch.randn((C, M, 1), generator=gen,
                                          device="cuda"))
        x = (torch.randn((C, M, 128), generator=gen, device="cuda")
             * scale).view(C, N)
        x[:, :128] = 0.0
        want = tcref.topk_mask_ref(x, K)
        out = torch.empty_like(x)
        chunks = C * M

        def variant(mode):
            common.raise_on(slib.select_launch(
                x.data_ptr(), out.data_ptr(), chunks, K, mode, sms,
                stream), "select_launch")
            return out

        def kernel():
            common.raise_on(lib.cmp_topk_mask(
                x.data_ptr(), out.data_ptr(), chunks, K, stream),
                "cmp_topk_mask")
            return out

        timed = {"search (the kernel)": kernel}
        timed.update({name: (lambda m=mode: variant(m))
                      for name, mode in VARIANTS.items()})
        for name, fn in timed.items():
            got = fn().clone()
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32),
                               want.view(torch.int32)):
                raise AssertionError(f"{name} at {(C, N)}: not bitwise "
                                     "equal to the plain version")
        us = {name: [] for name in timed}
        for _ in range(ROUNDS):
            for name, fn in timed.items():
                us[name].append(round(device_ms(fn, torch) * 1e3, 3))
        print(json.dumps({
            "shape": [C, N], "k": K, "us": us,
            "bound_us": round(8 * C * N / bw * 1e6, 3),
            "mean_search_steps": round(search_steps(torch, x, K), 3)}),
            flush=True)
        del x, out, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
