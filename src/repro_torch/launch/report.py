"""The federation scenario report: per-run cohort composition and every
registered round metric folded per its schema summaries.

Port of the scenario half of ``repro/launch/report.py``
(``cohort_histogram``, ``scenario_summary``, ``eta_hist_render``);
``launch/train.py`` prints the summary as its ``scenario report:``. The
dry-run and roofline tables come with the mesh tooling (ROADMAP A17,
second half).
"""
from __future__ import annotations

import numpy as np

from repro_torch.telemetry import schema
from repro_torch.telemetry.spec import TelemetrySpec


def cohort_histogram(ids_per_round, num_clients: int) -> np.ndarray:
    """(m,) counts: how many cohort slots each client filled across the
    run. ``ids_per_round`` is a list of per-round id arrays."""
    h = np.zeros(num_clients, np.int64)
    for ids in ids_per_round:
        np.add.at(h, np.asarray(ids, np.int64), 1)
    return h


def scenario_summary(name: str, ids_per_round, num_clients: int,
                     metrics_per_round) -> dict:
    """Aggregate one run's scenario telemetry into a report dict:
    participation histogram stats and every registered metric's per-run
    summaries (``schema.MetricSpec.summaries``); distribution vectors
    fold elementwise across rounds, and a run-summed η histogram comes
    with its bin edges."""
    out = {"scenario": name, "rounds": len(metrics_per_round),
           "num_clients": num_clients}
    if ids_per_round:
        h = cohort_histogram(ids_per_round, num_clients)
        slots = max(1, int(h.sum()))
        top = np.sort(h)[::-1]
        out.update(
            clients_seen=int((h > 0).sum()),
            cohort_top1_share=float(top[0] / slots),
            cohort_top5_share=float(top[:5].sum() / slots))
        if num_clients <= 10_000:
            out["cohort_histogram"] = h.tolist()

    reds = {"mean": np.mean, "sum": np.sum, "min": np.min, "max": np.max}
    for spec in schema.specs():
        vals = [m[spec.name] for m in metrics_per_round if spec.name in m]
        if not vals:
            continue
        for out_name, red in spec.summaries:
            if spec.shape == "()":
                out[out_name] = float(reds[red](vals))
            else:
                out[out_name] = reds[red](
                    np.asarray(vals, np.float64), axis=0).tolist()
    if "eta_hist" in out and len(out["eta_hist"]) >= 3:
        out["eta_hist_edges"] = [
            float(e) for e in
            TelemetrySpec(eta_bins=len(out["eta_hist"])).eta_edges()]
    return out


def eta_hist_render(hist, edges, width: int = 40) -> str:
    """ASCII bar rendering of a run-summed η histogram. The first bin is
    the underflow η < edges[1], the last the overflow."""
    hist = np.asarray(hist, np.float64)
    total = hist.sum()
    if total <= 0:
        return "(empty η histogram)"
    peak = hist.max()
    lines = [f"η distribution ({total:.0f} client-rounds)"]
    for i, n in enumerate(hist):
        lo = edges[i] if i < len(edges) - 1 else edges[-2]
        hi = edges[i + 1] if i + 1 < len(edges) else float("inf")
        label = (f"<{hi:8.1e}" if i == 0
                 else f">{lo:8.1e}" if not np.isfinite(hi)
                 else f" {lo:8.1e}")
        bar = "#" * int(round(width * n / peak)) if peak else ""
        lines.append(f"  {label} |{bar} {n:.0f}")
    return "\n".join(lines)
