#!/usr/bin/env python3
"""Latency and issue rate of mma.sync TF32 (m16n8k8) on one NVIDIA GPU.

    python3 scripts/hmma_probe.py

One block of 1, 4 or 16 warps runs a loop of `mma.sync.m16n8k8 TF32`
on 1, 4 or 8 independent accumulators and reads `clock64` around it;
f32 FMA on 8 chains is the yardstick. Each line gives the SM cycles per
mma (or FMA) a warp spends: with one accumulator that is the latency of
one mma, with 8 the most a warp issues. The SSD chunk kernel
(src/repro_torch/kernels/mamba2_scan/csrc/mamba2_scan.cu) is shaped by
these numbers. Builds with nvcc into build/probe/; needs a GPU.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "probe"
ITERS = 2000

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void hmma(float* out, long long* cyc, int iters, int chains) {
  float acc[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, 2u, 3u, 4u};
  const uint32_t b0 = 5u, b1 = 6u;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < chains)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
              "+f"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  const long long t1 = clock64();
  float s = 0.0f;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][3];
  out[threadIdx.x] = s;
  if (threadIdx.x % 32 == 0) cyc[threadIdx.x / 32] = t1 - t0;
}

__global__ void ffma(float* out, long long* cyc, int iters, int chains) {
  float acc[8] = {1, 2, 3, 4, 5, 6, 7, 8};
  const float x = threadIdx.x * 1e-3f, y = 0.999f;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fmaf(acc[j], y, x);
  const long long t1 = clock64();
  float s = 0.0f;
  for (int j = 0; j < 8; ++j) s += acc[j];
  out[threadIdx.x] = s;
  if (threadIdx.x % 32 == 0) cyc[threadIdx.x / 32] = t1 - t0;
}

// cycles per instruction of the slowest warp, the second launch's
extern "C" int probe(int fma, int warps, int iters, int chains,
                     double* per) {
  float* out;
  long long* cyc;
  if (cudaMalloc(&out, 1024 * sizeof(float)) != cudaSuccess) return 1;
  if (cudaMalloc(&cyc, 32 * sizeof(long long)) != cudaSuccess) return 1;
  for (int rep = 0; rep < 2; ++rep) {
    if (fma)
      ffma<<<1, 32 * warps>>>(out, cyc, iters, chains);
    else
      hmma<<<1, 32 * warps>>>(out, cyc, iters, chains);
  }
  long long h[32];
  const int err = static_cast<int>(cudaDeviceSynchronize()) |
                  static_cast<int>(cudaMemcpy(h, cyc, sizeof(h),
                                              cudaMemcpyDeviceToHost));
  long long most = 0;
  for (int w = 0; w < warps; ++w) most = h[w] > most ? h[w] : most;
  *per = static_cast<double>(most) / (static_cast<double>(iters) * chains);
  cudaFree(out);
  cudaFree(cyc);
  return err;
}
"""


def main() -> int:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        print("hmma_probe: nvcc not found", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib_path = OUT / "hmma_probe.cu", OUT / "libhmma_probe.so"
    src.write_text(SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.probe.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_double)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    per = ctypes.c_double()
    rows = []
    for fma, chain_set in ((0, (1, 4, 8)), (1, (8,))):
        for warps in (1, 4, 16):
            for chains in chain_set:
                if lib.probe(fma, warps, ITERS, chains, ctypes.byref(per)):
                    print("hmma_probe: a CUDA call failed", file=sys.stderr)
                    return 1
                rows.append({"op": "ffma" if fma else "mma.m16n8k8.tf32",
                             "warps": warps, "chains": chains,
                             "cycles_per_op_per_warp": per.value})
                print(json.dumps(rows[-1]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
