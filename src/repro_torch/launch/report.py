"""Render the dry run's and ``perf.py``'s tables from their JSON
artifacts, plus the federation scenario report (per-run cohort
composition and every registered round metric folded per its schema
summaries).

Port of ``repro/launch/report.py``: ``fmt_t``, ``fmt_b``, ``load``,
``dryrun_table``, ``roofline_table``, ``scenario_table``,
``cohort_histogram``, ``scenario_summary``, ``eta_hist_render`` and the
CLI. ``roofline_table`` keeps the rows of the single-pod production
mesh, which on the H100 is (data 32, model 8): ``"32x8"``
(``launch/mesh.py``), where the reference's TPU pod is ``"16x16"``.
``perf_table`` renders ``launch/perf.py``'s artifacts (one file a pair,
one row a variant); the reference prints those as they are written.
``launch/train.py`` prints the scenario summary as its ``scenario
report:``.

  PYTHONPATH=src python -m repro_torch.launch.report --dir experiments/dryrun
  PYTHONPATH=src python -m repro_torch.launch.report --dir experiments/dryrun \
      --perf experiments/perf
"""
from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

# the single-pod production mesh's rows (``launch/mesh.py``)
SINGLE_POD = "32x8"


def fmt_t(x):
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}µs"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def fmt_b(x):
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


def load(dirname):
    rows = []
    for p in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(p) as f:
            rows.append(json.load(f))
    return rows


def dryrun_table(rows):
    # .get() guards throughout: an artifact of an older run (or a partial
    # write) may miss columns; the table shows "-" for them
    out = ["| arch | shape | mesh | fed | clients | compile | temp/dev "
           "(no-remat UB) | analytic/dev (remat) |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        am = r.get("analytic_memory") or {}
        mem = r.get("memory") or {}
        compile_s = r.get("compile_s")
        out.append(
            f"| {r.get('arch', '-')} | {r.get('shape', '-')} | "
            f"{r.get('mesh', '-')} | "
            f"{r.get('federation', '-')} | {r.get('clients', '-')} | "
            f"{'-' if compile_s is None else f'{compile_s}s'} | "
            f"{fmt_b(mem.get('temp_size_in_bytes', 0))} | "
            f"{fmt_b(am.get('total', 0))} |")
    return "\n".join(out)


def roofline_table(rows, mesh: str = SINGLE_POD):
    """The roofline rows of the single-pod mesh (``mesh``)."""
    out = ["| arch | shape | t_compute | t_memory | t_collective | "
           "bottleneck | MODEL/HLO flops | dominant collective |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("mesh") != mesh:
            continue
        rl = r.get("roofline") or {}
        if "note" in rl or "t_compute_s" not in rl:
            continue
        by = rl.get("coll_by_kind") or {}
        dom = max(by, key=by.get) if by else "-"
        out.append(
            f"| {r.get('arch', '-')} | {r.get('shape', '-')} | "
            f"{fmt_t(rl['t_compute_s'])} | "
            f"{fmt_t(rl['t_memory_s'])} | {fmt_t(rl['t_collective_s'])} | "
            f"**{rl.get('bottleneck', '-')}** | "
            f"{r.get('useful_flops_ratio', 0.0):.2f} | "
            f"{dom} ({fmt_b(by.get(dom, 0))}) |")
    return "\n".join(out)


def perf_table(pairs):
    """One row a variant of ``launch/perf.py``'s artifacts: ``pairs``
    maps "arch/shape" to {variant: its roofline summary, or a refusal
    (``refused``)}."""
    out = ["| pair | variant | t_compute | t_memory | t_collective | "
           "bottleneck | wire/round | lower |",
           "|---|---|---|---|---|---|---|---|"]
    for pair, variants in sorted(pairs.items()):
        for v, r in variants.items():
            if "refused" in r:
                out.append(f"| {pair} | {v} | refused: {r['refused']} "
                           "| | | | | |")
                continue
            wire = r.get("wire") or {}
            out.append(
                f"| {pair} | {v} | {fmt_t(r['t_compute_s'])} | "
                f"{fmt_t(r['t_memory_s'])} | "
                f"{fmt_t(r['t_collective_s'])} | "
                f"**{r.get('bottleneck', '-')}** | "
                f"{fmt_b(wire['wire_bytes_round']) if wire else '-'} | "
                f"{r.get('wall_s', '-')}s |")
    return "\n".join(out)


def load_perf(dirname):
    """{"arch/shape": {variant: summary}} of a ``perf.py`` out dir."""
    out = {}
    for p in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(p) as f:
            rows = json.load(f)
        pair = rows.pop("_pair", os.path.basename(p)[:-5])
        out[pair] = rows
    return out


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

    # the telemetry package imports the round (its kernels' namespace):
    # a report that only renders tables reads it only here
    from repro_torch.telemetry import schema
    from repro_torch.telemetry.spec import TelemetrySpec
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


def scenario_table(rows):
    """Markdown table over artifacts that carry a scenario report
    (launch/train.py --scenario --out)."""
    rows = [r for r in rows if "scenario" in r]
    if not rows:
        return "(no scenario artifacts)"
    out = ["| scenario | rounds | clients seen | top-1/top-5 cohort share "
           "| stale mean/max | K_eff mean (min..max) | flush rate "
           "| wire/round | comp ratio | valid mean | skips | η clip/NaN |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        seen = r.get("clients_seen", "-")
        share = (f"{r['cohort_top1_share']:.2f}/{r['cohort_top5_share']:.2f}"
                 if "cohort_top1_share" in r else "-")
        stale = (f"{r['stale_mean']:.2f}/{r['stale_max']:.0f}"
                 if "stale_mean" in r else "-")
        keff = (f"{r['k_eff_mean']:.2f} "
                f"({r['k_eff_min']:.0f}..{r['k_eff_max']:.0f})"
                if "k_eff_mean" in r else "-")
        flush = (f"{r['flush_rate']:.2f}" if "flush_rate" in r else "-")
        wire = (fmt_b(r["wire_bytes_round"])
                if "wire_bytes_round" in r else "-")
        ratio = (f"{r['comp_ratio']:.2f}x" if "comp_ratio" in r else "-")
        vmean = (f"{r['valid_mean']:.2f}" if "valid_mean" in r else "-")
        skips = (f"{r['skipped_rounds']:.0f}"
                 if "skipped_rounds" in r else "-")
        guard = (f"{r['eta_clip_rate']:.3f}/{r['nan_guard_rate']:.3f}"
                 if "eta_clip_rate" in r and "nan_guard_rate" in r else "-")
        out.append(f"| {r.get('scenario', '-')} | {r.get('rounds', '-')} "
                   f"| {seen} | {share} "
                   f"| {stale} | {keff} | {flush} | {wire} | {ratio} "
                   f"| {vmean} | {skips} | {guard} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--perf", default=None,
                    help="launch/perf.py's out dir: its variants' table")
    args = ap.parse_args(argv)
    rows = load(args.dir)
    scen = [r for r in rows if "scenario" in r]
    dry = [r for r in rows if "scenario" not in r]
    if dry:
        print(f"## Dry-run ({len(dry)} artifacts)\n")
        print(dryrun_table(dry))
        print(f"\n## Roofline (single-pod {SINGLE_POD}, calibrated)\n")
        print(roofline_table(dry))
    if scen:
        print(f"\n## Federation scenarios ({len(scen)} runs)\n")
        print(scenario_table(scen))
        for r in scen:
            if "eta_hist" in r and "eta_hist_edges" in r:
                print(f"\n### {r.get('scenario', '-')}\n")
                print(eta_hist_render(r["eta_hist"], r["eta_hist_edges"]))
    if args.perf:
        pairs = load_perf(args.perf)
        if pairs:
            print(f"\n## Perf variants ({len(pairs)} pairs, "
                  "two-depth extrapolation)\n")
            print(perf_table(pairs))


if __name__ == "__main__":
    main()
