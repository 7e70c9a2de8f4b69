#!/usr/bin/env python3
"""A rank's round seconds and peak allocation in phase 4f's
``cross_device`` LM round of chip_smoke.py (``SHARD_LM``'s first run:
TinyLlama at full width cut to 2 layers, C = 4, dirichlet_dropouts +
trimmed + int8/EF21) on 4 gloo ranks on the one card, with the package
of a given tree:

    python3 scripts/flat_tp_probe.py [--src OTHER/src]

The round is built by ``chip_smoke._shard_lm_run``, through the entry
points a caller uses (``make_train_step(flat=True, mesh=)``,
``train_rules``, ``place_train_for_rank``), so the same code measures a
``git archive`` copy of another commit (``--src``): there the round runs
as that tree's flat round runs it. Prints the card and one ``flat tp``
line: each rank's round seconds and peak bytes, and the round's loss.
Needs the card.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _paths(src):
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))


def _rank(rank, world, out_dir):
    import torch
    import chip_smoke as cs
    from repro_torch.sharding import dist
    mesh = dist.make_mesh(*cs.SHARD_MESH)
    kind, C, guarded = cs.SHARD_LM[0]
    out = cs._shard_lm_run(torch, mesh, dist.runtime().device, kind, C,
                           guarded)
    m, secs, peak = out[6:9]
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump({"round_s": secs, "peak_bytes": peak,
                   "loss": float(m["loss"])}, f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import chip_smoke as cs
    from repro_torch.kernels.compress import compress as tcomp
    from repro_torch.kernels.delta_sgd import delta_sgd as tk
    from repro_torch.kernels.robust_agg import robust_agg as tra
    from repro_torch.sharding import dist
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    # every library the round launches, built before the ranks start
    for mod in (tk, tcomp, tra):
        mod.library()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.spawn(_rank, cs.SHARD_WORLD, (tmp,), device="cuda")
        ranks = []
        for r in range(cs.SHARD_WORLD):
            with open(Path(tmp) / f"rank{r}.json") as f:
                ranks.append(json.load(f))
    print("flat tp", json.dumps({
        "card": smi, "src": args.src, "federation": cs.SHARD_LM[0][0],
        "round_s_by_rank": [r["round_s"] for r in ranks],
        "peak_bytes_by_rank": [r["peak_bytes"] for r in ranks],
        "loss": ranks[0]["loss"],
        "total_s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    _src = next((sys.argv[i + 1] for i, a in enumerate(sys.argv)
                 if a == "--src"), str(ROOT / "src"))
    os.environ["FLAT_TP_PROBE_SRC"] = str(Path(_src).resolve())
    _paths(_src)
    main()
else:
    # a spawned rank re-imports this module: the same tree as its parent
    _paths(os.environ.get("FLAT_TP_PROBE_SRC", str(ROOT / "src")))
