"""Typed metric schema registry: the single source of truth for every
metric name the round engines emit.

Port of ``repro/telemetry/schema.py``, with the reference's 39
registrations copied as data (their producer strings name the
reference's modules, so ``markdown_table`` renders the reference's
table); the async tail's keys (``stale_mean``, ``stale_max``,
``buffer_fill``, ``flushed``, ``overstale_frac``) and the fleet loop's
(``revisit_frac``, ``realized_stale_mean``, ``eta_carry_mean``) among
them, so the scenario report has the reference's columns. Consumers
stop hardcoding key lists:

  * ``launch/train._ScenarioStats`` collects every registered metric
    and warns ONCE per unregistered producer name instead of dropping
    it;
  * ``launch/report.scenario_summary`` derives its per-run aggregation
    from each spec's ``summaries``.

Shapes are symbolic: ``"()"`` scalar, ``"(C,)"`` per-cohort-client,
``"(B,)"`` η-histogram bins, ``"(Q,)"`` quantile points. Only scalars
and the fixed-shape distribution vectors stack over a fused block
(every leaf gains a leading R axis there).
"""
from __future__ import annotations

import warnings
from typing import Dict, NamedTuple, Optional, Tuple


class MetricSpec(NamedTuple):
    """One registered metric. ``summaries`` maps the per-round stream
    to per-run report fields: ``(out_name, reduction)`` pairs with
    reduction in {mean, sum, min, max}; empty = reported elsewhere
    (the round log / eval path) or not aggregated."""
    name: str
    dtype: str = "f32"
    shape: str = "()"
    unit: str = ""
    doc: str = ""
    producer: str = ""
    summaries: Tuple[Tuple[str, str], ...] = ()


REGISTRY: Dict[str, MetricSpec] = {}

_REDUCTIONS = ("mean", "sum", "min", "max")


def register(name: str, **kw) -> MetricSpec:
    """Register (or re-register, idempotently) one metric name."""
    spec = MetricSpec(name=name, **kw)
    for _, red in spec.summaries:
        if red not in _REDUCTIONS:
            raise ValueError(f"{name}: unknown reduction {red!r} "
                             f"(expected one of {_REDUCTIONS})")
    REGISTRY[name] = spec
    return spec


def get(name: str) -> Optional[MetricSpec]:
    return REGISTRY.get(name)


def specs() -> Tuple[MetricSpec, ...]:
    return tuple(REGISTRY.values())


def is_scalar(name: str) -> bool:
    spec = REGISTRY.get(name)
    return spec is not None and spec.shape == "()"


_warned: set = set()


def warn_unregistered(name: str, producer: str = "") -> None:
    """Warn ONCE per unregistered metric name (a producer emitting a
    key the registry does not know about — register it in
    repro_torch.telemetry.schema instead of silently dropping it)."""
    if name in _warned:
        return
    _warned.add(name)
    src = f" (from {producer})" if producer else ""
    warnings.warn(f"metric {name!r}{src} is not registered in "
                  f"repro_torch.telemetry.schema — add a MetricSpec so "
                  f"reports and docs can carry it", stacklevel=2)


def markdown_table() -> str:
    """The metric table, one row per registered metric (the
    reference renders docs/TELEMETRY.md from the same table)."""
    lines = ["| metric | shape | dtype | unit | per-run summary | "
             "producer | description |",
             "|---|---|---|---|---|---|---|"]
    for s in REGISTRY.values():
        summ = ("; ".join(f"{red} → `{out}`" for out, red in s.summaries)
                if s.summaries else "—")
        lines.append(f"| `{s.name}` | `{s.shape}` | {s.dtype} | "
                     f"{s.unit or '—'} | {summ} | `{s.producer}` | "
                     f"{s.doc} |")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# registrations, grouped by producer
# ---------------------------------------------------------------------------

_CORE = "core.fed_round._round_metrics"
register("loss", unit="nats", producer=_CORE,
         doc="mean per-step training loss over the cohort's active "
             "local steps")
register("loss_last_step", unit="nats", producer=_CORE,
         doc="mean loss at each client's last (K_c-th) local step")
register("eta_mean", unit="step size", producer=_CORE,
         doc="cohort mean of the round-end Δ-SGD step size")
register("eta_min", unit="step size", producer=_CORE,
         doc="cohort minimum round-end η")
register("eta_max", unit="step size", producer=_CORE,
         doc="cohort maximum round-end η")

_SCN = "core.fed_round._scenario_extras"
register("cohort_ids", dtype="i32", shape="(C,)", producer=_SCN,
         doc="the scheduler's cohort draw for the round (the SAME "
             "(seed, round)-keyed draw the data pipeline gathered)")
register("k_eff_mean", producer=_SCN, unit="steps",
         summaries=(("k_eff_mean", "mean"),),
         doc="mean drawn per-client step budget K_c")
register("k_eff_min", producer=_SCN, unit="steps",
         summaries=(("k_eff_min", "min"),),
         doc="min drawn K_c")
register("k_eff_max", producer=_SCN, unit="steps",
         summaries=(("k_eff_max", "max"),),
         doc="max drawn K_c")

_ASYNC = "core.fed_round (async tail)"
register("stale_mean", producer=_ASYNC, unit="rounds",
         summaries=(("stale_mean", "mean"),),
         doc="mean drawn staleness of the round's buffered updates")
register("stale_max", producer=_ASYNC, unit="rounds",
         summaries=(("stale_max", "max"),),
         doc="max drawn staleness")
register("buffer_fill", producer=_ASYNC, unit="updates",
         summaries=(("buffer_fill_mean", "mean"),),
         doc="FedBuff buffer occupancy after the round's merge")
register("flushed", producer=_ASYNC,
         summaries=(("flush_rate", "mean"),),
         doc="1.0 when the buffer reached M updates and the server "
             "stepped this round")

_COMP = "core.fed_round (compression)"
register("wire_bytes", producer=_COMP, unit="bytes",
         summaries=(("wire_bytes_round", "mean"),
                    ("wire_bytes_total", "sum")),
         doc="cohort-total compressed delta payload for the round")
register("comp_ratio", producer=_COMP, unit="x",
         summaries=(("comp_ratio", "mean"),),
         doc="full-precision f32 delta bytes / wire bytes")
register("comp_level_mean", producer=_COMP,
         summaries=(("comp_level_mean", "mean"),),
         doc="mean drawn per-client compression level "
             "(bandwidth-heterogeneous scenarios)")

_FAULT = "federation.faults round health"
register("eta_clip_rate", producer=_FAULT,
         summaries=(("eta_clip_rate", "mean"),),
         doc="fraction of (client, step) lanes whose η hit the "
             "ETA_CLAMP guard ceiling")
register("nan_guard_rate", producer=_FAULT,
         summaries=(("nan_guard_rate", "mean"),),
         doc="fraction of clients whose NaN guard latched this round")
register("valid_count", producer=_FAULT, unit="clients",
         summaries=(("valid_mean", "mean"),),
         doc="clients surviving the round's faults (guard tail only)")
register("round_skipped", producer=_FAULT,
         summaries=(("skipped_rounds", "sum"),),
         doc="1.0 when the quorum check skipped the server update")
register("drop_frac", producer=_FAULT,
         summaries=(("drop_frac", "mean"),),
         doc="fraction of clients that dropped mid-round")
register("byz_frac", producer=_FAULT,
         summaries=(("byz_frac", "mean"),),
         doc="fraction of byzantine clients this round")
register("overstale_frac", producer=_FAULT,
         summaries=(("overstale_frac", "mean"),),
         doc="fraction of updates forced over the staleness ceiling")
register("agg_clip_rate", producer="federation.faults.robust_aggregate",
         summaries=(("agg_clip_rate", "mean"),),
         doc="fraction of client deltas clipped by the robust "
             "aggregator's norm ceiling")

_FLEET = "core.fed_loop.make_fleet_loop"
register("revisit_frac", producer=_FLEET,
         summaries=(("revisit_frac", "mean"),),
         doc="fraction of the cohort that participated before")
register("realized_stale_mean", producer=_FLEET, unit="rounds",
         summaries=(("realized_stale_mean", "mean"),),
         doc="mean rounds since a returning client's last "
             "participation")
register("eta_carry_mean", producer=_FLEET, unit="step size",
         summaries=(("eta_carry_mean", "mean"),),
         doc="mean arena-carried η entering the round")

_TELE = "telemetry.spec.round_telemetry"
register("eta_hist", shape="(B,)", producer=_TELE, unit="clients",
         summaries=(("eta_hist", "sum"),),
         doc="per-round η distribution over client lanes: counts in "
             "log-spaced bins (TelemetrySpec.eta_edges; first bin = "
             "underflow, last = overflow)")
register("loss_deciles", shape="(Q,)", producer=_TELE, unit="nats",
         summaries=(("loss_deciles", "mean"),),
         doc="per-client mean-loss order statistics: min, deciles, "
             "max (Q=11)")
register("eta_clip_count", producer=_TELE, unit="lanes",
         summaries=(("eta_clip_count", "sum"),),
         doc="absolute count of η-clamp guard hits this round")
register("nan_guard_count", producer=_TELE, unit="clients",
         summaries=(("nan_guard_count", "sum"),),
         doc="absolute count of NaN-guard latches this round")

_SERVE = "serving.engine"
register("serve_tokens", dtype="i32", producer=_SERVE, unit="tokens",
         summaries=(("serve_tokens_total", "sum"),),
         doc="decode tokens emitted this flush interval (all slots, "
             "after per-request budget truncation)")
register("serve_occupancy", producer=_SERVE,
         summaries=(("serve_occupancy_mean", "mean"),),
         doc="active slots / pool slots at this flush (continuous-"
             "batching utilization)")
register("serve_version", dtype="i32", producer=_SERVE, unit="round",
         summaries=(("serve_version_last", "max"),),
         doc="training round of the params that produced every token "
             "of this flush (hot-swaps land only at flush boundaries)")
register("serve_swapped", dtype="i32", producer=_SERVE,
         summaries=(("serve_swaps_total", "sum"),),
         doc="1 when a staged checkpoint version hot-swapped in at "
             "this flush boundary")
register("serve_swap_stall_s", producer=_SERVE, unit="s",
         summaries=(("serve_swap_stall_mean", "mean"),
                    ("serve_swap_stall_max", "max")),
         doc="registry-notice to traffic-serving delay of the swap "
             "applied at this flush (restore + wait-to-boundary)")

_LOADGEN = "serving.loadgen.run_load"
register("serve_tok_per_s", producer=_LOADGEN, unit="tokens/s",
         summaries=(("serve_tok_per_s", "max"),),
         doc="load-generator end-to-end decode throughput")
register("serve_latency_p50_s", producer=_LOADGEN, unit="s",
         summaries=(("serve_latency_p50_s", "max"),),
         doc="median request latency (submit to last token, queueing "
             "included under poisson arrivals)")
register("serve_latency_p99_s", producer=_LOADGEN, unit="s",
         summaries=(("serve_latency_p99_s", "max"),),
         doc="99th-percentile request latency")
