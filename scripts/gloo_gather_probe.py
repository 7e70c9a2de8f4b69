#!/usr/bin/env python3
"""Three ways to stage a gloo all-gather of CUDA tensors, timed on the
card.

    python3 scripts/gloo_gather_probe.py

gloo has no all-gather of CUDA tensors, so
``repro_torch.sharding.dist.all_gather`` stages it through the host.
Four ranks on the one card (gloo, a (data 2, model 2) mesh) gather over
``model`` (groups of 2) a KV block (2, 2, 1, 2, 64), an activation (2,
64, 2048), an fsdp-sharded weight (2560, 6912) and a vocab table's
block (76032, 2560), all f32, each way in turns (old, pinned, pageable,
old, pinned): ``old`` copies the block to pinned memory, gathers into
per-rank host tensors, concatenates on the host and copies the result
to the card; ``pinned`` gathers into one pinned (ranks, *block) buffer,
copies it to the card at once and concatenates there (what
``dist.all_gather`` does); ``pageable`` is the same with a pageable
buffer. Rank 0 prints the median ms of each (10 repetitions, 3 for the
table, after one warm-up). Needs the card.
"""
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as tdist  # noqa: E402

SIZES = {"kv (2,2,1,2,64)": (2, 2, 1, 2, 64),
         "act (2,64,2048)": (2, 64, 2048),
         "w_gate (2560,6912)": (2560, 6912),
         "table (76032,2560)": (76032, 2560)}


def v_old(x, group, n):
    src = torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
    parts = [torch.empty_like(src) for _ in range(n)]
    tdist.all_gather(parts, src, group=group)
    return torch.cat(parts, 0).to(x.device, non_blocking=True)


def v_pinned(x, group, n):
    src = torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
    buf = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, pin_memory=True)
    tdist.all_gather(list(buf.unbind(0)), src, group=group)
    return torch.cat(buf.to(x.device, non_blocking=True).unbind(0), 0)


def v_pageable(x, group, n):
    src = torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
    buf = torch.empty((n,) + tuple(x.shape), dtype=x.dtype)
    tdist.all_gather(list(buf.unbind(0)), src, group=group)
    return torch.cat(buf.to(x.device).unbind(0), 0)


def rank_fn(rank, world):
    from repro_torch.sharding import dist
    mesh = dist.make_mesh((2, 2), ("data", "model"))
    group, ranks = dist._group(mesh, ("model",))
    res = {}
    for name, shape in SIZES.items():
        x = torch.full(shape, float(rank), device="cuda")
        reps = 3 if "table" in name else 10
        for vname, fn in (("old", v_old), ("pinned", v_pinned),
                          ("pageable", v_pageable), ("old2", v_old),
                          ("pinned2", v_pinned)):
            ms = []
            for _ in range(reps + 1):
                torch.cuda.synchronize()
                tdist.barrier()
                t0 = time.perf_counter()
                y = fn(x, group, len(ranks))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            res[f"{name} {vname}"] = statistics.median(ms[1:])
            del y
    if rank == 0:
        print(json.dumps(res, indent=1), flush=True)


if __name__ == "__main__":
    from repro_torch.sharding import dist
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dist.spawn(rank_fn, 4, (), device="cuda")
