#!/usr/bin/env python3
"""Host syncs and wall per local step of the vmap engine on the card.

    python3 scripts/vmap_step_probe.py [--src DIR] [--label NAME]

Runs chip_smoke.py's phase-4 configuration (the paper's CNN, 100
clients, α 0.1, participation 0.1 so C = 10, batch 64, K = 7, seed 0)
on cuda through ``make_fl_round(flat=False)``, for each client
optimizer of OPTS: Adam and SGDM (per-leaf scalars at every local
step), Δ-SGD's plain per-leaf route and its kernel route
(``use_pallas``). For each it counts the host syncs torch reports in
one round (``torch.cuda.set_sync_debug_mode("warn")``, after a round
that takes the reports torch makes once a process), then times ROUNDS
rounds on the host clock, the optimizers in turns and the first round
of each a warm-up. Prints one JSON line: the card's name and power
limit, and for each optimizer its syncs a round and its wall per local
step (each round's, and the median).

``--src`` names the ``src`` directory of the tree to measure (this
checkout's by default), so that two trees can be held side by side in
one call: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# optimizer -> get_client_opt's name and overrides (--lr the middle of
# the paper grids, as chip_smoke.py's baselines)
OPTS = {"adam": ("adam", dict(lr=0.01)),
        "sgdm": ("sgdm", dict(lr=0.05)),
        "delta_sgd": ("delta_sgd", {}),
        "delta_sgd_kernel_route": ("delta_sgd", dict(use_pallas=True))}
ROUNDS = 12


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    sys.path[:0] = [args.src, str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this probe needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import get_client_opt
    from repro_torch.launch import train

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.VMAP_TIMED_ROUNDS = ROUNDS
    runs = {name: cs._vmap_setup(torch, train, dict(flat=False),
                                 get_client_opt(opt, **kw))
            for name, (opt, kw) in OPTS.items()}
    syncs = {}
    for name, (pt, rnd, batches) in runs.items():
        one_round = functools.partial(rnd, train.init_state(pt),
                                      batches[0])
        one_round()
        torch.cuda.synchronize()
        syncs[name] = cs._block_syncs(torch, one_round)[0]

    states = {name: train.init_state(runs[name][0]) for name in runs}
    walls = {name: [] for name in runs}
    order = list(runs)
    for t in range(ROUNDS + 1):
        s = t % len(order)
        for name in order[s:] + order[:s]:
            _, rnd, batches = runs[name]
            t0 = time.perf_counter()
            states[name], _, _ = rnd(states[name], batches[t])
            torch.cuda.synchronize()
            if t > 0:
                walls[name].append((time.perf_counter() - t0) / cs.K * 1e3)
    print(json.dumps({
        "label": args.label, "src": args.src, "card": smi,
        "host_syncs_per_round": syncs,
        "median_wall_ms_per_step": {n: statistics.median(w)
                                    for n, w in walls.items()},
        "wall_ms_per_step": walls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
