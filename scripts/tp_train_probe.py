#!/usr/bin/env python3
"""Phase 4g of chip_smoke.py alone: tensor-parallel training on 4 gloo
ranks on the one card, every gate, and the train_4k dry run beside it.

    python3 scripts/tp_train_probe.py [--layers N]

Builds the Δ-SGD library, then runs ``run_tp_train_path``. With
``--layers N`` every run is cut to N layers (TinyLlama's whole runs
included): a quick first check of the phase. Prints the phase's lines
and the seconds it took. Needs the card.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    t0 = time.perf_counter()
    from repro_torch.device import resolve_device
    from repro_torch.kernels.delta_sgd import delta_sgd as tk
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    resolve_device("cuda")
    bw, f32 = cs.peaks(torch.cuda.get_device_name(0))
    tk.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    if args.layers:
        cs.TPT_RUNS = tuple(r[:2] + (args.layers,) + r[3:]
                            for r in cs.TPT_RUNS)
    launches, rows = cs.run_tp_train_path(torch, smi, bw, f32)
    print("launches", launches, "rows", sorted(rows))
    print(f"probe total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
