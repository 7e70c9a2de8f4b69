"""Telemetry plane: observe without perturbing.

Port of ``repro/telemetry``:

  * :mod:`repro_torch.telemetry.schema`: the typed metric registry every
    producer registers into.
  * :mod:`repro_torch.telemetry.spec`: :class:`TelemetrySpec` and
    :func:`round_telemetry`, the per-round distribution block (η
    histogram, loss deciles, guard hit counts) that stacks over a fused
    block. Read-only over round-end values: trajectories are bitwise
    equal with telemetry on and off.
  * :mod:`repro_torch.telemetry.events`: buffered JSONL sink with a run
    metadata header, flushed with one device-to-host copy per block.
  * :mod:`repro_torch.telemetry.spans` /
    :mod:`repro_torch.telemetry.profiling`: span wall-clock accounting,
    kernel-launch telemetry and ``torch.profiler`` traces for
    ``--profile``.
"""
from repro_torch.telemetry import schema
from repro_torch.telemetry.events import (EventLog, config_hash, load_events,
                                          run_metadata)
from repro_torch.telemetry.profiling import (kernel_launch_snapshot,
                                             reset_kernel_launches,
                                             static_telemetry, trace_block)
from repro_torch.telemetry.spans import SpanTimer
from repro_torch.telemetry.spec import (TelemetrySpec, resolve_telemetry,
                                        round_telemetry)

__all__ = [
    "schema", "EventLog", "config_hash", "load_events", "run_metadata",
    "kernel_launch_snapshot", "reset_kernel_launches", "static_telemetry",
    "trace_block", "SpanTimer", "TelemetrySpec", "resolve_telemetry",
    "round_telemetry",
]
