#!/usr/bin/env python3
"""One tensor-parallel phase of chip_smoke.py alone, with every gate of
that phase: 4 gloo ranks on the one card.

    python3 scripts/tp_probe.py --phase serve [--sharded] [--only ARCH,...]
                                              [--only one_row]
    python3 scripts/tp_probe.py --phase train [--layers N] [--only RUN,...]
    python3 scripts/tp_probe.py --phase moe [--quick] [--only RUN,...]

``serve``: phase 5's flash and SSD rows at the heads a rank holds (the
FA_CASES and SSD_CASES of two rows, and the one row's flash case), then
phase 6c's dense part (``run_tp_serve_path``: the dense decoders,
Zamba2, InternVL2, Whisper, xLSTM, and the one-row run on (data 1,
model 4)), ``--only`` the named archs of TP_PATHS and ``one_row``;
``--sharded`` adds phase 4f (``run_sharded_path``). ``train``: phase 4g
(``run_tp_train_path``), every run of TPT_RUNS (``--only``: the named
ones; the remat gate needs its pair), each cut to N layers with
``--layers N``. ``moe``: the MoE and MLA part of phase 6c
(``run_tp_moe_serve_path``) and the MoE dry runs beside it;
``--quick`` runs every model at its reduced config (a first check that
compiles and passes the gates in about a minute), ``--only`` the named
runs of TPM_RUNS and no dry run. Builds the libraries the phase
launches, prints the phase's lines and the seconds it took. Needs the
card.
"""
import argparse
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("serve", "train", "moe"),
                    required=True)
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    t0 = time.perf_counter()
    from repro_torch.device import resolve_device
    from repro_torch.kernels.delta_sgd import delta_sgd as tk
    from repro_torch.kernels.delta_sgd import ref as tref
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as faref
    from repro_torch.kernels.mamba2_scan import mamba2_scan as m2
    from repro_torch.kernels.mamba2_scan import ref as m2ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    resolve_device("cuda")
    bw, f32 = cs.peaks(torch.cuda.get_device_name(0))
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda m: m.library(), (tk, fa, m2)))
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    if args.phase == "serve":
        cs.check_lm_kernels(torch, fa, faref, m2, m2ref, bw, f32,
                            fa_cases=[c for c in cs.FA_CASES if c[0] == 2
                                      or c[2:4] == (8, 1)],
                            ssd_cases=[c for c in cs.SSD_CASES
                                       if c[0] == 2])
        only = args.only.split(",") if args.only else None
        archs = tuple(a for a in cs.TP_PATHS if not only or a in only)
        print("launches", cs.run_tp_serve_path(
            torch, smi, archs, one_row=not only or "one_row" in only))
        if args.sharded:
            cs.run_sharded_path(torch, tk, tref, bw, f32, smi)
    elif args.phase == "train":
        runs = cs.TPT_RUNS
        if args.only:
            runs = tuple(r for r in runs if r[0] in args.only.split(","))
        if args.layers:
            runs = tuple(r[:2] + (args.layers,) + r[3:] for r in runs)
        launches, rows = cs.run_tp_train_path(torch, smi, bw, f32, runs)
        print("launches", launches, "rows", sorted(rows))
    else:
        runs = cs.TPM_RUNS
        if args.only:
            runs = tuple(r for r in runs if r[0] in args.only.split(","))
        if args.quick:
            runs = tuple(r[:2] + ("reduced",) + r[3:] for r in runs)
        if args.only:
            print("launches", cs.run_tp_moe_serve_path(torch, smi, runs))
        else:
            dry_dir = tempfile.TemporaryDirectory()
            dry = cs.start_tp_dry_runs(dry_dir.name)
            print("launches", cs.run_tp_moe_serve_path(torch, smi, runs))
            t2 = time.perf_counter()
            cs.report_tp_dry_runs(dry, dry_dir.name)
            dry_dir.cleanup()
            print(f"dry runs waited {time.perf_counter() - t2:.1f} s")
    print(f"phase {args.phase} {time.perf_counter() - t1:.1f} s; probe "
          f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
