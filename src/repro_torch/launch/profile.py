"""Where the time of a training step goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile --task image \\
        --model cnn --rounds-per-call 2 [--scenario dirichlet_dropouts \\
        --robust-agg trimmed --compression int8 --error-feedback]

Builds the paper-task run of ``repro_torch.launch.train`` with the same
flags (scenario, compression and EF21 state included; the async presets'
buffer, and a fleet preset's or ``--num-registered`` client arena beside
the state), runs one
round-fused block to warm up, then

  * times ``--repeat`` further blocks on the host clock (each ends in a
    device synchronise): the steady-state wall time per local step;
  * runs one more block under ``torch.profiler`` (CPU + CUDA activity):
    the device-busy time (union of kernel and copy intervals), the idle
    share of the block's span, device operations per local step, the
    kernel launches of each namespace (Δ-SGD per local step; compression,
    robust aggregation and, with ``--telemetry``, telemetry per round), the device time by kernel name,
    and the host-side operators by their own CPU time.

Prints one JSON object per line. Fails when the profiler records no
device activity.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import flatten_fl_state
from repro_torch.kernels.compress import compress as tcomp
from repro_torch.kernels.delta_sgd import delta_sgd as tk
from repro_torch.kernels.robust_agg import robust_agg as tra
from repro_torch.kernels.telemetry import telemetry as tt
from repro_torch.launch import train


def busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None):
    ap = train.build_parser()
    ap.add_argument("--repeat", type=int, default=5,
                    help="timed blocks after the warm-up block")
    ap.add_argument("--top", type=int, default=12,
                    help="kernels listed by device time")
    args = ap.parse_args(argv)
    if args.rounds_per_call < 2 or not args.task:
        ap.error("pass --task and --rounds-per-call R >= 2")
    pt = train.setup_paper_task(args)
    R, K = args.rounds_per_call, pt.local_steps
    run = train.BlockRunner(pt, args)
    fstate = flatten_fl_state(train.init_state(pt), run.layout)

    def block(fs):
        fs, _ = run(fs, run.stage(fs.round, R))
        if pt.device.type == "cuda":
            torch.cuda.synchronize(pt.device)
        return fs

    fstate = block(fstate)                       # warm-up
    walls = []
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        fstate = block(fstate)
        walls.append(time.perf_counter() - t0)
    for mod in (tk, tcomp, tra, tt):
        mod.reset_launch_count()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fstate = block(fstate)
        wall_prof = time.perf_counter() - t0
    launches = tk.launch_count("cuda")
    per_round = {name: n / R for (name, dev), n in
                 (tcomp.LAUNCHES + tra.LAUNCHES + tt.LAUNCHES).items()
                 if dev == "cuda"}

    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise SystemExit("the profiler recorded no device activity")
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    span_us = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = busy_us(spans)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    steps = R * K
    print(json.dumps({
        "device": (torch.cuda.get_device_name(pt.device)
                   if pt.device.type == "cuda" else "cpu"),
        "rounds_per_call": R, "local_steps": K,
        "scenario": pt.scenario.name if pt.scenario else None,
        "compression": pt.compression.kind,
        "error_feedback": pt.compression.error_feedback,
        "clients": pt.cohort,
        "batch": args.batch,
        "wall_ms_per_step": [w / steps * 1e3 for w in walls],
        "wall_ms_per_step_median": sorted(walls)[len(walls) // 2]
        / steps * 1e3}))
    print(json.dumps({
        "profiled_wall_ms_per_step": wall_prof / steps * 1e3,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "device_span_ms_per_step": span_us / steps / 1e3,
        "idle_share_of_span": 1.0 - busy / span_us,
        "idle_share_of_wall": 1.0 - busy / (wall_prof * 1e6),
        "device_ops_per_step": len(dev) / steps,
        "delta_sgd_kernel_launches_per_step": launches / steps,
        "other_kernel_launches_per_round": per_round}))
    for name, (us, n) in top:
        print(json.dumps({"kernel": name[:120], "ms_per_step":
                          us / steps / 1e3, "calls_per_step": n / steps}))
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    for a in host[:args.top]:
        print(json.dumps({"host_op": a.key[:120], "self_cpu_ms_per_step":
                          a.self_cpu_time_total / steps / 1e3,
                          "calls_per_step": a.count / steps}))


if __name__ == "__main__":
    main()
