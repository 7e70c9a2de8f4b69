#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without its final line:

  1. header   the card's name and power limit (nvidia-smi), torch/CUDA.
  2. build    the CUDA kernels from the repository's sources (set-up).
  3. kernels  each kernel at the main-path shape (C=10, N=71,808) and at
              a large shape (C=10, N=2**24), held against its plain
              PyTorch version on the card (norms: rtol 1e-5 and two calls
              bitwise equal; apply: bitwise equal, masked lanes exactly
              bf16), timed with CUDA events (median of 60 launches queued
              behind a device sleep, so the times are device times) beside
              the plain version, a library call where one exists, and the
              bound from the bytes moved and the card's peak rates. One
              JSON line per kernel and shape.
  4. path     the paper's CNN federation through the training entry point
              (100 clients, alpha 0.1, batch 64, 4 rounds, 2 rounds per
              call) on cuda: 2*K*rounds kernel launches, all on CUDA,
              finite losses; the host loop (--flat) on cuda is bitwise
              equal; the same run on the CPU agrees on round 0 within rtol
              1e-4 (cuDNN/cuBLAS and kernel sum order differ).
  5. the summary line {"kernels": [...]} and, last, the device line.

It imports nothing of ``jax`` or of the reference package ``repro``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
KERNEL_SOURCE = "src/repro_torch/kernels/delta_sgd/csrc/delta_sgd.cu"
TPU_KERNELS = {"batched_norms": "src/repro/kernels/delta_sgd/delta_sgd.py:111",
               "batched_apply": "src/repro/kernels/delta_sgd/delta_sgd.py:137"}
MAIN_SHAPE = (10, 71808)          # C = 10 clients, N of the paper's CNN
LARGE_SHAPE = (10, 2 ** 24)       # 671 MB per buffer, far past the L2
SAMPLES = 60

# (name fragment, HBM bytes/s, f32 non-tensor-core flop/s): NVIDIA data
# sheets, dense rates; the first fragment found in the card's name wins
CARDS = (("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12))

TRAIN_ARGS = ["--task", "image", "--model", "cnn", "--num-clients", "100",
              "--alpha", "0.1", "--participation", "0.1", "--batch", "64",
              "--rounds", "4", "--seed", "0"]


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def peaks(name: str):
    for frag, bw, f32 in CARDS:
        if frag in name:
            return bw, f32
    raise RuntimeError(f"no peak rates known for {name!r}")


def device_ms(fn, torch):
    """Median device time of ``fn`` over SAMPLES launches. The launches
    are queued behind a device sleep, so each start/end event pair
    brackets device work, not the host's enqueue."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(SAMPLES)]
    torch.cuda._sleep(20_000_000)
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def check_kernels(torch, tk, tref, bw, f32):
    """Phase 3. Returns {(name, shape): row}."""
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for C, N in (MAIN_SHAPE, LARGE_SHAPE):
        def rand(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        g, gp, p = rand(C, N), rand(C, N), rand(C, N)
        eta = torch.rand((C,), generator=gen, device="cuda") * 0.99 + 0.01
        mask = (torch.rand((N,), generator=gen, device="cuda") < 0.5).float()

        # batched_norms: rtol 1e-5 (sum order), bitwise across calls
        got = torch.stack(tk.batched_norms(g, gp))
        again = torch.stack(tk.batched_norms(g, gp))
        want = torch.stack(tref.batched_norms_ref(g, gp))
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("batched_norms: two calls differ")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
        row = dict(
            name="batched_norms", shape=[C, N],
            max_abs_err=float((got - want).abs().max()),
            ms=device_ms(lambda: tk.batched_norms(g, gp), torch),
            plain_ms=device_ms(lambda: tref.batched_norms_ref(g, gp), torch),
            library_ms=None,
            bound_ms=max((2 * C * N + 2 * C) * 4 / bw, 5 * C * N / f32) * 1e3,
            bound_by="bytes")
        rows[("batched_norms", (C, N))] = row

        # batched_apply, unmasked and masked: bitwise equal to the plain
        # version (no FMA contraction), masked lanes exactly bf16
        for masked in (False, True):
            m = mask if masked else None
            want = tref.batched_apply_ref(p, g, eta, m)
            got = tk.batched_apply(p.clone(), g, eta, mask=m)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"batched_apply(masked={masked}) is "
                                     "not bitwise equal to the plain "
                                     "version")
            if masked:
                sel = got[:, mask > 0]
                if not torch.equal(sel, sel.bfloat16().float()):
                    raise AssertionError("masked lanes are not bf16")
            work = p.clone()
            name = "batched_apply" + ("[masked]" if masked else "")
            moved = 3 * C * N * 4 + C * 4 + (N * 4 if masked else 0)
            row = dict(
                name=name, shape=[C, N],
                max_abs_err=float((got - want).abs().max()),
                ms=device_ms(lambda: tk.batched_apply(work, g, eta, mask=m),
                             torch),
                plain_ms=device_ms(
                    lambda: tref.batched_apply_ref(work, g, eta, m), torch),
                library_ms=(None if masked else device_ms(
                    lambda: torch.addcmul(work, eta[:, None], g, value=-1),
                    torch)),
                bound_ms=max(moved / bw, 2 * C * N / f32) * 1e3,
                bound_by="bytes")
            rows[(name, (C, N))] = row
        for key, row in rows.items():
            if key[1] == (C, N):
                row["gbps_achieved"] = (row["bound_ms"] / row["ms"]) * bw / 1e9
                print(json.dumps(row), flush=True)
    return rows


def run_path(torch, tk, train):
    """Phase 4. Returns the main-path launch counts."""
    tk.reset_launch_count()
    fused = train.main(TRAIN_ARGS + ["--rounds-per-call", "2",
                                     "--device", "cuda"])
    torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    K = 500 // 64      # one local epoch: 500 examples per client
    want = 2 * K * 4
    if tk.launch_count() != want or tk.launch_count("cuda") != want:
        raise AssertionError(f"main path launched {launches}, expected "
                             f"{want} kernel launches, all on cuda")
    for t, row in enumerate(fused.history):
        if not all(math.isfinite(float(v)) for v in row.values()):
            raise AssertionError(f"round {t}: non-finite metrics {row}")
        print("path round", t, json.dumps({k: float(v)
                                           for k, v in row.items()}))

    host = train.main(TRAIN_ARGS + ["--flat", "--device", "cuda"])
    for t, (a, b) in enumerate(zip(fused.history, host.history)):
        for k in a:
            if a[k].tobytes() != b[k].tobytes():
                raise AssertionError(f"round {t} {k}: fused {a[k]!r} != "
                                     f"host loop {b[k]!r}")
    for k, layer in fused.state.params.items():
        for leaf, v in layer.items():
            if not torch.equal(v, host.state.params[k][leaf]):
                raise AssertionError(f"param {k}.{leaf}: fused != host")
    print("path: fused == host loop, bitwise (params and metrics)")

    cpu = train.main(TRAIN_ARGS + ["--rounds-per-call", "2",
                                   "--device", "cpu"])
    for t, (a, b) in enumerate(zip(fused.history, cpu.history)):
        print("path round", t, "cuda vs cpu", json.dumps(
            {k: [float(a[k]), float(b[k])] for k in ("loss", "eta_mean")}))
    for k in ("loss", "eta_mean"):
        a, b = float(fused.history[0][k]), float(cpu.history[0][k])
        if not math.isclose(a, b, rel_tol=1e-4):
            raise AssertionError(f"round 0 {k}: cuda {a} vs cpu {b}")
    print("path: round 0 loss/eta_mean agree with the CPU within 1e-4")

    return launches


def main() -> int:
    if not (SRC / "repro_torch" / "kernels").is_dir():
        return fail(f"{SRC / 'repro_torch'} not found: run from a checkout "
                    "of the repository")
    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this smoke run "
                    "needs an NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels.delta_sgd import delta_sgd as tk
    from repro_torch.kernels.delta_sgd import ref as tref
    from repro_torch.launch import train

    # 1. header
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {name}", flush=True)
    resolve_device("cuda")
    bw, f32 = peaks(name)

    # 2. build
    t0 = time.perf_counter()
    tk.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (set-up)")
    log = build.library_path("delta_sgd", tk.SOURCES).with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())

    # 3. kernels
    rows = check_kernels(torch, tk, tref, bw, f32)

    # 4. path
    launches = run_path(torch, tk, train)

    # 5. summary
    kernels = []
    for kname in ("batched_norms", "batched_apply"):
        row = rows[(kname, MAIN_SHAPE)]
        kernels.append(dict(
            name=kname, route="cuda", source=KERNEL_SOURCE,
            replaces=TPU_KERNELS[kname],
            launches=launches.get((kname, "cuda"), 0),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
