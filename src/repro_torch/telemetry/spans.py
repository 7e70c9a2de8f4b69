"""Lightweight span timing for the launch drivers.

Port of ``repro/telemetry/spans.py``. Wall-clock accounting over named
phases (pack / stage / block_execute / convert / eval) with near-zero
overhead: one ``perf_counter`` pair per span, accumulated in a dict. The
summary lands in the event log's ``spans`` event and the end-of-run
print, the coarse picture a ``--profile`` trace then drills into. A span
around device work measures the host's time, which includes the
device's only where the span ends in a host sync.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict


class SpanTimer:
    """Accumulating span timer: ``with spans.span("block_execute"): ...``."""

    def __init__(self):
        self._acc: Dict[str, list] = {}

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            cell = self._acc.setdefault(name, [0.0, 0])
            cell[0] += dt
            cell[1] += 1

    def add(self, name: str, seconds: float) -> None:
        """Manual accumulation for spans not expressible as a with
        block."""
        cell = self._acc.setdefault(name, [0.0, 0])
        cell[0] += seconds
        cell[1] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"s": round(v[0], 6), "n": v[1]}
                for k, v in self._acc.items()}

    def __str__(self) -> str:
        return " ".join(f"{k} {v[0]:.2f}s/{v[1]}"
                        for k, v in sorted(self._acc.items()))
