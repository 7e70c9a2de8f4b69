#!/usr/bin/env python3
"""Times the SSD chunk kernel with P cut into more slices than it needs.

    python3 scripts/ssd_slice_probe.py

At the Zamba2 prefill shape (B, S, H, P, G, N) = (1, 64, 112, 64, 1, 64),
L = 64, the port's grid is one block per (chunk, head): 112 blocks on
132 SMs. Cutting P into 2 or 4 slices fills the card (224 or 448
blocks), each block recomputing M for its columns of y and its rows of
S_c. This script calls the kernel's C entry point with 1, 2 and 4
slices, each in blocks of one and of two warp groups, checks that every
variant gives the same bits, and prints each one's median device time
(chip_smoke.py's device_ms). ``ssd_grid`` keeps the fewest slices,
because these times show slicing lose. Builds the kernel library as the
port does; needs a GPU.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SHAPE = (1, 64, 112, 64, 1, 64)
SLICES = (1, 2, 4)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ssd_slice_probe: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import device_ms
    from repro_torch.kernels.mamba2_scan import mamba2_scan as m2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    B, S, H, P, G, N = SHAPE
    r = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    x = t(r.normal(size=(B, S, H, P)))
    dt = t(r.uniform(0.001, 0.1, (B, S, H)))
    dA = (dt * -torch.exp(t(np.log(r.uniform(1, 16, (H,)))))).contiguous()
    Bm, Cm = t(r.normal(size=(B, S, G, N))), t(r.normal(size=(B, S, G, N)))
    lib = m2.library()
    stream = torch.cuda.current_stream().cuda_stream

    def run(split, two):
        y = torch.empty_like(x)
        s_c = torch.empty((B, 1, H, P, N), device="cuda")
        cd = torch.empty((B, 1, H), device="cuda")
        ecs = torch.empty((B, S, H), device="cuda")
        err = lib.ssd_chunks_forward(
            x.data_ptr(), dt.data_ptr(), dA.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), s_c.data_ptr(), cd.data_ptr(),
            ecs.data_ptr(), B, S, H, G, P, N, S, 1, split, int(two), stream)
        if err:
            raise RuntimeError(f"ssd_chunks_forward returned {err}")
        return y, s_c, cd, ecs

    want = run(1, True)
    us = {}
    for split in SLICES:
        for two in (False, True):
            got = run(split, two)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{split} slices, two groups {two}: "
                                     "the bits differ")
            name = f"{split} slices, {'two groups' if two else 'one group'}"
            us[name] = device_ms(lambda: run(split, two), torch) * 1e3
    print(json.dumps({"shape": list(SHAPE), "chunk": S,
                      "us_by_variant": us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
