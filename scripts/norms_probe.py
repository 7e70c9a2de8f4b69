#!/usr/bin/env python3
"""Times the Δ-SGD batched pair's kernel and grid choices on the card.

    python3 scripts/norms_probe.py

``batched_norms`` runs one kernel: a block per 8,192 elements of a row,
the last block of each row summing the blocks' pairs, its workspace
kept per stream (``norms_grid``). This script holds it against the
design it was chosen over, one thread-block cluster per client row
(CLUSTER_SOURCE below: k blocks deal the row's trips among them, stage
them in shared memory with cp.async and gather their pairs in rank 0
over distributed shared memory; no workspace), for each k in CLUSTERS
(8 is the portable cluster limit), and against the kernel with its
tickets zeroed before every call, as a wrapper without a kept
workspace must, at each (C, N) in NORMS_SHAPES, from the paper's CNN
width (10, 71,808) to (10, 2**24). Each is checked against the plain
version (rtol 1e-5) and two calls of it for equal bits.

``batched_apply`` gives each thread one 16-byte column of a group of
clients; ``apply_grid`` picks the group and the block. At each shape of
APPLY_SHAPES the script runs the wrapper's grid and each group size of
APPLY_GROUPS on apply_grid's block rule, masked and not, each bitwise
equal to the plain version.

Every variant, the wrappers' own choices and torch.addcmul are then
timed in ROUNDS interleaved rounds (chip_smoke.py's device_ms, median
device time of 60 launches); one JSON line per shape lists each
variant's times in µs. Builds the kernel libraries with nvcc as the
port does; needs a GPU.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

NORMS_SHAPES = ((10, 71808), (10, 2 ** 18), (10, 2 ** 20), (10, 2 ** 24))
APPLY_SHAPES = ((10, 71808), (50, 71808), (100, 71808), (10, 2 ** 24))
CLUSTERS = (4, 8)
APPLY_GROUPS = (1, 5, 8)
ROUNDS = 3

# The cluster design: grid (k, C), cluster (k, 1, 1), 512 threads a
# block. Trips of 1,024 float4s a row are dealt round the k blocks
# (block r takes trips r, r + k, ...); each thread stages its own pieces
# of a trip with cp.async three trips ahead of the one it sums; the
# block tree, then each block's pair into rank 0's shared memory, and
# rank 0 sums the k pairs in rank order.
CLUSTER_SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;
constexpr int kT = 512;
constexpr int kWarps = kT / 32;
constexpr int kTrip = 1024;
constexpr int kStages = 4;
constexpr int kRing = kStages * 2 * kTrip * 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned int>(__cvta_generic_to_shared(smem))),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__global__ void __launch_bounds__(kT)
cluster_norms(const float* __restrict__ g, const float* __restrict__ gp,
              int64_t n, float* __restrict__ dg_out,
              float* __restrict__ gg_out) {
  constexpr int kV = kTrip / kT;
  extern __shared__ float4 ring[];   // [stage][g, g_prev][kV][kT]
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t c = blockIdx.y;
  const int64_t n4 = n / 4;
  const float4* g4 = reinterpret_cast<const float4*>(g + c * n);
  const float4* gp4 = reinterpret_cast<const float4*>(gp + c * n);
  const int k = static_cast<int>(cluster.num_blocks());
  const int64_t row_trips = (n4 + kTrip - 1) / kTrip;
  const int64_t trips = row_trips > rank ? (row_trips - rank + k - 1) / k : 0;
  auto issue = [&](int64_t q) {
    if (q < trips) {
      float4* slot = ring + (q % kStages) * 2 * kTrip + threadIdx.x;
      const int64_t base = (rank + q * k) * kTrip + threadIdx.x;
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int64_t j = base + i * kT;
        const int64_t at = j < n4 ? j : 0;
        const int bytes = j < n4 ? 16 : 0;
        cp_async16(slot + i * kT, g4 + at, bytes);
        cp_async16(slot + (kV + i) * kT, gp4 + at, bytes);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  float dg = 0.0f;
  float gg = 0.0f;
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) issue(q);
  for (int64_t q = 0; q < trips; ++q) {
    issue(q + kStages - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    const float4* slot = ring + (q % kStages) * 2 * kTrip + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const float4 a = slot[i * kT];
      const float4 b = slot[(kV + i) * kT];
      const float dx = a.x - b.x, dy = a.y - b.y;
      const float dz = a.z - b.z, dw = a.w - b.w;
      dg += dx * dx + dy * dy + dz * dz + dw * dw;
      gg += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
    }
  }
  block_sum2(dg, gg);
  __shared__ float2 pairs[kMaxCluster];
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (threadIdx.x == 0)
    *cluster.map_shared_rank(&pairs[rank], 0) = make_float2(dg, gg);
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (rank != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (threadIdx.x == 0) {
    float sdg = 0.0f;
    float sgg = 0.0f;
    for (int r = 0; r < k; ++r) {
      sdg += pairs[r].x;
      sgg += pairs[r].y;
    }
    dg_out[c] = sdg;
    gg_out[c] = sgg;
  }
}

}  // namespace

extern "C" {

// Sets the ring's shared memory limit; once, before any launch.
int cluster_norms_init(void) {
  return static_cast<int>(cudaFuncSetAttribute(
      cluster_norms, cudaFuncAttributeMaxDynamicSharedMemorySize, kRing));
}

int cluster_norms_launch(const float* g, const float* gp, int64_t C,
                         int64_t n, int k, float* dg, float* gg,
                         void* stream) {
  if (k < 1 || k > kMaxCluster || n < 4 || C < 1 || C > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t trips = ((n / 4 + kTrip - 1) / kTrip + k - 1) / k;
  const int64_t stages = trips < kStages ? trips : kStages;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(k),
                     static_cast<unsigned int>(C));
  cfg.blockDim = dim3(kT);
  cfg.dynamicSmemBytes = static_cast<size_t>(stages * 2 * kTrip * 16);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(k);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, cluster_norms, g, gp, n, dg, gg));
}

}  // extern "C"
"""


def cluster_library():
    from repro_torch.kernels import build, common
    src = build.BUILD_DIR.parent / "probe" / "norms_cluster.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(CLUSTER_SOURCE)
    lib = build.load_library("norms_cluster", [src])
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.cluster_norms_launch.argtypes = [vp, vp, i64, i64, ctypes.c_int, vp,
                                         vp, vp]
    common.raise_on(lib.cluster_norms_init(), "cluster_norms_init")
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("norms_probe: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import device_ms
    from repro_torch.kernels import build, common
    from repro_torch.kernels.delta_sgd import delta_sgd as tk
    from repro_torch.kernels.delta_sgd import ref as tref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    lib = tk.library()
    clib = cluster_library()
    log = build.library_path("delta_sgd", tk.SOURCES).with_suffix(".log")
    print("\n".join(line for line in log.read_text().splitlines()
                    if "Used" in line or "spill" in line or "error" in line))
    stream = torch.cuda.current_stream().cuda_stream
    sms = common.sm_count(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for C, N in sorted(set(NORMS_SHAPES) | set(APPLY_SHAPES)):
        g = torch.randn((C, N), generator=gen, device="cuda")
        gp = torch.randn((C, N), generator=gen, device="cuda")
        p = torch.randn((C, N), generator=gen, device="cuda")
        eta = torch.rand((C,), generator=gen, device="cuda") + 0.01
        mask = (torch.rand((N,), generator=gen, device="cuda") < 0.5).float()
        dg = torch.empty((C,), device="cuda")
        gg = torch.empty((C,), device="cuda")
        work = p.clone()
        timed = {}

        if (C, N) in NORMS_SHAPES:
            want = torch.stack(tref.batched_norms_ref(g, gp))
            chunks = tk.norms_grid(C, N)
            partial, tickets = tk._norms_workspace(g.device, stream, C,
                                                   chunks)

            def cluster(k):
                common.raise_on(clib.cluster_norms_launch(
                    g.data_ptr(), gp.data_ptr(), C, N, k, dg.data_ptr(),
                    gg.data_ptr(), stream), "cluster_norms")
                return dg, gg

            def zeroed():
                tickets.zero_()
                common.raise_on(lib.dsgd_batched_norms(
                    g.data_ptr(), gp.data_ptr(), C, N, chunks,
                    partial.data_ptr(), tickets.data_ptr(), dg.data_ptr(),
                    gg.data_ptr(), stream), "batched_norms")
                return dg, gg

            variants = {f"norms cluster k {k}": (lambda k=k: cluster(k))
                        for k in CLUSTERS}
            variants["norms tickets zeroed a call"] = zeroed
            variants["norms wrapper"] = lambda: tk.batched_norms(g, gp)
            for name, fn in variants.items():
                a = torch.stack(fn())
                b = torch.stack(fn())
                torch.cuda.synchronize()
                if not torch.equal(a, b):
                    raise AssertionError(f"{name}: two calls differ")
                torch.testing.assert_close(a, want, rtol=1e-5, atol=0.0)
                timed[name] = fn

        for masked in (False, True) if (C, N) in APPLY_SHAPES else ():
            m = mask if masked else None
            ref = tref.batched_apply_ref(p, g, eta, m)
            for group in APPLY_GROUPS:
                # apply_grid's block rule for another group size
                units = -(-C // group) * (N // 4)
                streamed = units >= sms * tk.APPLY_THREADS * 4
                threads = tk.APPLY_THREADS
                while (not streamed and threads > 32
                       and -(-units // threads) < sms):
                    threads //= 2
                cap = sms * tk.APPLY_WAVES if streamed else units
                grid = tk.ApplyGrid(group, threads,
                                    min(-(-units // threads), cap), streamed)

                def apply(out, grid=grid, m=m):
                    common.raise_on(lib.dsgd_batched_apply(
                        out.data_ptr(), g.data_ptr(), eta.data_ptr(),
                        None if m is None else m.data_ptr(), C, N,
                        grid.group, grid.threads, grid.blocks,
                        int(grid.stream), stream), "batched_apply")
                    return out
                got = apply(p.clone())
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise AssertionError(f"{grid}: not bitwise plain")
                timed[f"apply masked {masked}, {tuple(grid)}"] = (
                    lambda apply=apply: apply(work))
            timed[f"apply masked {masked}, wrapper "
                  f"{tuple(tk.apply_grid(C, N, sms))}"] = (
                lambda m=m: tk.batched_apply(work, g, eta, mask=m))
        if (C, N) in APPLY_SHAPES:
            timed["torch.addcmul"] = (
                lambda: torch.addcmul(work, eta[:, None], g, value=-1))

        us = {name: [] for name in timed}
        for _ in range(ROUNDS):
            for name, fn in timed.items():
                us[name].append(round(device_ms(fn, torch) * 1e3, 3))
        print(json.dumps({"shape": [C, N], "us": us}), flush=True)
        del g, gp, p, work
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
