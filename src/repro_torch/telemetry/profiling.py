"""Profiler hooks: kernel-launch telemetry and one-block traces.

Port of ``repro/telemetry/profiling.py``. ``kernel_launch_snapshot``
merges the ``LAUNCHES`` books of the port's six kernel namespaces;
``static_telemetry`` turns a snapshot taken around a block into the
``"static"`` event row the launch drivers emit for ``--profile``
(launches in all and per round), so a change in the launch schedule
shows up in the JSONL artifact even when the run is too short to time.
The reference also reads collective counts and payload bytes from the
compiled HLO there; under a mesh the port reads them from the collective
recorder (``repro_torch.sharding.hlo``): pass the block's
``hlo.snapshot()`` as ``collectives=``. Without a mesh the row stays as
it was.

``trace_block`` runs one block under ``torch.profiler`` and writes a
Chrome trace.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import torch


def _namespaces():
    """(namespace, kernel wrapper module) of every kernel namespace."""
    from repro_torch.kernels.compress import compress
    from repro_torch.kernels.delta_sgd import delta_sgd
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba2_scan import mamba2_scan
    from repro_torch.kernels.robust_agg import robust_agg
    from repro_torch.kernels.telemetry import telemetry
    return (("delta_sgd", delta_sgd), ("compress", compress),
            ("robust_agg", robust_agg), ("telemetry", telemetry),
            ("flash_attention", flash_attention),
            ("mamba2_scan", mamba2_scan))


def kernel_launch_snapshot(device_type: Optional[str] = None
                           ) -> Dict[str, int]:
    """Every namespace's launch count as ``{"<ns>/<function>": n}``,
    counting the calls on ``device_type`` ("cuda": the kernel launches,
    "cpu": the plain-version runs) or, with None, on every device."""
    out: Dict[str, int] = {}
    for ns, mod in _namespaces():
        for (fn, dev), n in mod.LAUNCHES.items():
            if device_type is None or dev == device_type:
                key = f"{ns}/{fn}"
                out[key] = out.get(key, 0) + int(n)
    return out


def reset_kernel_launches() -> None:
    for _, mod in _namespaces():
        mod.reset_launch_count()


def static_telemetry(*, rounds: int = 1,
                     launches: Optional[Dict[str, int]] = None,
                     collectives=None) -> Dict:
    """The ``"static"`` telemetry row of a block of ``rounds`` rounds:
    its kernel launches per namespace and function, in all and per
    round; with ``collectives`` (the recorder's ``CollectiveOp`` list of
    a meshed block) also ``collective_count``,
    ``collectives_per_round``, ``collective_bytes(_per_round)``,
    ``collective_wire_bytes`` and ``collective_kinds``."""
    rounds = max(rounds, 1)
    launches = dict(launches or {})
    row = {"rounds": rounds,
           "kernel_launches": launches,
           "kernel_launches_per_round": {k: v / rounds
                                         for k, v in launches.items()}}
    if collectives is not None:
        from repro_torch.sharding.hlo import summary
        row.update(summary(collectives, rounds))
    return row


def trace_block(fn: Callable, logdir: str):
    """Run ``fn()`` under ``torch.profiler`` (CPU activity, and CUDA
    activity where there is a card), synchronise the card, and write the
    Chrome trace to ``<logdir>/trace.json``; returns fn's result."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    return out
