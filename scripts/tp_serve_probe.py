#!/usr/bin/env python3
"""Phase 6c of chip_smoke.py alone, with phase 5's flash rows at the
ranks' local-head shapes.

    python3 scripts/tp_serve_probe.py [--sharded]

Builds the flash-attention library (and, with ``--sharded``, the Δ-SGD
one), times flash at chip_smoke.py's last three FA_CASES (the heads a
rank of (data 2, model 2) holds of TinyLlama, Qwen2.5 and Granite)
against its plain version and SDPA, then runs the tensor-parallel
serving phase (``run_tp_serve_path``: 4 gloo ranks on the one card,
every gate) and, with ``--sharded``, phase 4f (``run_sharded_path``).
Prints those phases' lines and the seconds each took. Needs the card.
"""
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    t0 = time.perf_counter()
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as faref
    from repro_torch.kernels.mamba2_scan import mamba2_scan as m2
    from repro_torch.kernels.mamba2_scan import ref as m2ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    bw, f32 = cs.peaks(torch.cuda.get_device_name(0))
    fa.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    cs.FA_CASES = cs.FA_CASES[-3:]
    cs.SSD_CASES = ()
    cs.check_lm_kernels(torch, fa, faref, m2, m2ref, bw, f32)
    print("launches", cs.run_tp_serve_path(torch, smi))
    if "--sharded" in sys.argv:
        from repro_torch.kernels.delta_sgd import delta_sgd as tk
        from repro_torch.kernels.delta_sgd import ref as tref
        tk.library()
        cs.run_sharded_path(torch, tk, tref, bw, f32, smi)
    print(f"probe total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
