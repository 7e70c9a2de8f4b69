"""Federated training driver: a decoder LM (``--arch``) on synthetic
tokens, or a paper-task model (MLP / shallow CNN, ``--task``) on the
synthetic classification suite.

Port of ``repro/launch/train.py`` (``train_lm`` and ``train_paper_task``)
with the reference's flags, plus ``--device`` (default ``cuda``;
``--device cpu`` runs the plain versions of the kernels on the CPU).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --rounds 50 --client-opt delta_sgd
  PYTHONPATH=src python -m repro_torch.launch.train --task image \\
      --model cnn --rounds 4 --rounds-per-call 2

``--arch`` trains an arch of the LM zoo (any of the reference's 10;
full width, ``--reduced`` with ``--layers`` and ``--d-model`` for a
small one) with ``--clients-per-round`` clients of ``--local-steps``
steps on ``--batch`` sequences of ``--seq`` tokens a step, drawn each
round from ``(seed, round)`` (``data.pipeline.lm_round_batches``; with
Whisper's stub frames or InternVL2's stub image embeddings beside
each sequence, ``models.model.batch_extras``), so a
``--resume`` replays the batches of an uninterrupted run. The model
trains on its plain route (``attention._sdpa``, ``ssm._ssd_chunked``),
as the reference's does; ``--use-pallas`` reaches only the client
optimizer (the vmap engine's Δ-SGD kernel route). The engines, the
scenarios, compression, telemetry, ``--events``, ``--profile`` and the
checkpoint flags behave as on the paper task below, but for the fleet
(``--num-registered``), which needs per-client data partitions and
exits. A run on the card prints its peak device memory.

The engine is chosen as the reference chooses it. ``--rounds-per-call
R`` (R > 1) runs the round-fused loop on the flat Δ-SGD engine
(``repro_torch.core.fed_loop``): the example arena is staged on the
device once and each R-round block ships only (R, C, K, b) gather
indices; a client optimizer other than Δ-SGD fails there, as in the
reference. Otherwise rounds run one at a time in a host loop: on the
flat engine with ``--flat`` or active compression (bitwise equal to the
fused loop), else on the vmap engine, which runs every client optimizer
(``--client-opt``, with ``--lr``) and server optimizer
(``--server-opt``). A faulty or robust scenario then needs ``--flat``
or compression, and fails without them as the reference's does.
``--use-pallas`` changes nothing, as in the reference's paper task; the
flat engines always run the kernels.

  PYTHONPATH=src python -m repro_torch.launch.train --task image \\
      --model cnn --client-opt adam --lr 0.01 --rounds 2

``--scenario`` picks a synchronous federation preset
(``repro_torch.federation.scenarios``: participation scheduler,
per-client step counts, bandwidth levels, fault lanes, robust
aggregation, quorum), seeded with ``--seed``; ``--robust-agg`` and
``--quorum`` fold onto it (a bare run becomes ``sync_iid``).
``--compression {int8,topk}`` (with ``--k-frac``) and
``--error-feedback`` compress the client deltas
(``repro_torch.compression``); the round log then shows the wire bytes,
and under a guarded tail the survivor count and skipped rounds.

  PYTHONPATH=src python -m repro_torch.launch.train --task image \\
      --model cnn --rounds 4 --rounds-per-call 2 \\
      --scenario dirichlet_dropouts --robust-agg trimmed \\
      --compression int8 --error-feedback

``--telemetry`` adds the round's telemetry block (η histogram, loss
deciles, guard counts: ``repro_torch.telemetry``) to the metrics without
changing a trained bit. ``--events PATH`` writes a JSONL event log (a
header, one ``round`` event per round, a ``spans`` event, and with
``--profile N`` a ``static`` event of the kernel launches of the block
that holds round N, which runs under ``torch.profiler`` with its trace
in ``--profile-dir``). With a scenario, compression or ``--telemetry``
the run ends with a ``scenario report:`` (``launch/report.py``), also
written to ``--out``. Metrics reach the host with one device-to-host
copy per fused block, or per ``--log-every`` rounds in the host loop.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --task easy --rounds 4 --rounds-per-call 2 --telemetry \\
      --events /tmp/e.jsonl --profile 1

Async presets (``zipf_async``, ``byzantine_async``) aggregate through
the FedBuff buffer and take the flat engine by themselves.

``--num-registered M`` switches on the FLEET regime
(``core.fed_loop.make_fleet_loop`` and ``federation.arena``): M
registered clients, cohorts of ``--participation``·M drawn over all of
them each round, per-client state (round-end η, participation counters,
the EF21 slab under ``--error-feedback``) in a ``ClientArena`` on the
device, indexed by registered id. Registered client i trains on data
partition ``i % num_clients``. The ``fleet_uniform`` and ``fleet_zipf``
presets carry M = 100,000 and p = 0.0005 (C = 50), which apply when the
flags are not given; ``--eta-carry`` warm-starts a returning client's
η₀ from its arena row. The fleet always runs the fused loop.

  PYTHONPATH=src python -m repro_torch.launch.train --task image \\
      --model cnn --rounds 8 --rounds-per-call 4 --scenario fleet_zipf \\
      --eta-carry --telemetry

``--ckpt-dir DIR`` saves the FLState (``repro_torch.checkpoint``, the
reference's on-disk format) every ``--ckpt-every`` rounds and always
after the last one, keyed on the round counter; a fused run saves at the
first block boundary at or after each hit, and a fleet run saves its
arena beside it in ``DIR/arena``. ``--resume`` restores the newest
checkpoint (and the arena saved at the same round) and runs
``--rounds`` more rounds; the data draws are keyed on the round, so the
resumed run equals an uninterrupted one bitwise.

Flags of features not ported yet would exit with an error naming their
ROADMAP item; every flag of the reference is ported now.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import warnings
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.compression import CompressionSpec
from repro_torch.configs import (ARCH_IDS, CNN_PAPER, MLP_SMALL, MLP_WIDE,
                                 FLConfig, get_config)
from repro_torch.core import (CLIENT_OPTS, SERVER_OPTS, arena_gather,
                              flatten_fl_state, get_client_opt,
                              get_server_opt, init_fl_state, make_fl_loop,
                              make_fl_round, make_fleet_loop, make_loss,
                              unflatten_fl_state)
from repro_torch.data.pipeline import FederatedDataset, lm_round_batches
from repro_torch.data.synthetic import get_task
from repro_torch.device import resolve_device
from repro_torch.federation import (ClientArena, arena_init, cohort_size,
                                    get_scenario)
from repro_torch.launch.report import scenario_summary
from repro_torch.models.model import Model, batch_extras, build_model
from repro_torch.models.small import accuracy, make_small_model, softmax_ce
from repro_torch.telemetry import (EventLog, SpanTimer,
                                   kernel_launch_snapshot, schema,
                                   static_telemetry, trace_block)
from repro_torch.telemetry.events import to_host
from repro_torch.utils.tree import tree_map

MODELS = {"mlp": MLP_SMALL, "mlp-wide": MLP_WIDE, "cnn": CNN_PAPER}

class TrainResult(NamedTuple):
    state: object              # final FLState
    history: List[dict]        # per-round metric rows, numpy f32 scalars
    test_acc: Optional[float]  # None for an LM, which has no eval
    arena: object = None       # the fleet's final ClientArena, else None


def resolve_scenario(args):
    """The preset with the run's --seed threaded in; --robust-agg and
    --quorum fold onto it (and promote a bare run to sync_iid)."""
    overrides = {}
    if args.robust_agg != "mean":
        overrides["robust_agg"] = args.robust_agg
    if args.quorum:
        overrides["quorum"] = args.quorum
    if not args.scenario and not overrides:
        return None
    return get_scenario(args.scenario or "sync_iid", seed=args.seed,
                        **overrides)


def resolve_fleet(args, scn):
    """(num_registered, participation) of the run. --num-registered and
    --participation win; otherwise a fleet preset's ``registered_hint``
    and ``participation_hint`` apply (so ``--scenario fleet_uniform``
    alone turns the fleet regime on); otherwise no fleet (None) and
    participation 0.1."""
    m = args.num_registered
    if m is None and scn is not None:
        m = scn.registered_hint
    p = args.participation
    if p is None and scn is not None and scn.participation_hint:
        p = scn.participation_hint
    return m, (0.1 if p is None else p)


def resolve_compression(args) -> CompressionSpec:
    """The run's CompressionSpec; an inert kind="none" spec leaves the
    round on its uncompressed path."""
    return CompressionSpec(kind=args.compression, k_frac=args.k_frac,
                           error_feedback=args.error_feedback)


def _health_str(row) -> str:
    """Round-health suffix of the round log: survivors, NaN-guard share
    and quorum skips under a guarded tail, wire bytes under compression.
    Empty for a plain round."""
    s = ""
    if "valid_count" in row:
        s += f" valid {int(float(row['valid_count']))}"
        ng = float(row.get("nan_guard_rate", 0.0))
        if ng > 0:
            s += f" nan {ng:.2f}"
        if float(row.get("round_skipped", 0.0)) > 0:
            s += " SKIPPED(quorum)"
    if "wire_bytes" in row:
        s += f" wire {float(row['wire_bytes']):.0f}B"
    return s


def _rows(metrics) -> List[dict]:
    """Stacked (R, ...) device metrics -> R rows of numpy values (f32
    scalars, and the telemetry vectors), with ONE device-to-host copy for
    the whole block (``telemetry.events.to_host``)."""
    keys = list(metrics)
    host = dict(zip(keys, to_host([metrics[k] for k in keys])))
    n = len(host[keys[0]])
    return [{k: v[r] for k, v in host.items()} for r in range(n)]


class _ScenarioStats:
    """Per-run accumulator for the scenario report (``launch/report.py``):
    cohort ids per round and every metric the round emits, routed through
    the ``repro_torch.telemetry.schema`` registry. An unregistered key
    warns once and is still kept."""

    def __init__(self, scenario, num_clients):
        self.scenario, self.num_clients = scenario, num_clients
        self.ids, self.metrics = [], []

    def update(self, ids, metrics):
        if ids is not None:
            self.ids.append(np.asarray(ids))
        elif "cohort_ids" in metrics:
            self.ids.append(np.asarray(metrics["cohort_ids"]))
        row = {}
        for k, v in metrics.items():
            if k == "cohort_ids":
                continue        # carried in the ids stream above
            spec = schema.get(k)
            if spec is None:
                schema.warn_unregistered(k, producer="round metrics")
            if spec is not None and spec.shape != "()":
                row[k] = np.asarray(v, np.float64)
            else:
                row[k] = float(v)
        self.metrics.append(row)

    def summary(self):
        name = self.scenario.name if self.scenario else "none"
        return scenario_summary(name, self.ids, self.num_clients,
                                self.metrics)

    def report(self, out_path=None, extra=None):
        s = self.summary()
        if extra:
            s.update(extra)
        print("scenario report:", json.dumps(s, indent=2, default=float))
        if out_path:
            os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
            with open(out_path, "w") as f:
                json.dump(s, f, indent=2, default=float)
        return s


class _RoundLog:
    """Buffered round log of the HOST loop: per-round metric dicts stay
    on the device and are converted with ONE device-to-host copy per
    ``--log-every`` interval; the converted rows then go to ``on_round``
    and the event log."""

    def __init__(self, log_every, on_round, events, spans):
        self.log_every = max(1, int(log_every))
        self.on_round, self.events, self.spans = on_round, events, spans
        self._buf = []

    def push(self, t, rnd, metrics, ids=None):
        self._buf.append((t, rnd, ids, metrics))
        if len(self._buf) >= self.log_every:
            self.flush()

    def flush(self):
        if not self._buf:
            return
        with self.spans.span("convert"):
            keys = [(i, k) for i, (_, _, _, m) in enumerate(self._buf)
                    for k in m]
            host = to_host([self._buf[i][3][k] for i, k in keys])
            rows = [{} for _ in self._buf]
            for (i, k), v in zip(keys, host):
                rows[i][k] = v
        for (t, rnd, ids, _), row in zip(self._buf, rows):
            self.on_round(t, row, ids)
            if self.events is not None:
                self.events.emit("round", t=t, round=rnd, **row)
        if self.events is not None:
            self.events.flush()
        self._buf.clear()


def _log_every(args) -> int:
    """--log-every N; 0 = ~10 conversions per run."""
    return args.log_every if args.log_every > 0 else max(1, args.rounds // 10)


def _finish_run(events, spans, show_spans: bool) -> None:
    """Common tail: the span summary into the event log, and to stdout
    when telemetry output was asked for."""
    if show_spans and spans.summary():
        print(f"spans: {spans}", flush=True)
    if events is not None:
        events.emit("spans", **spans.summary())
        events.close()
        print(f"event log: {events.path} "
              f"({events.events_written} events)", flush=True)


class PaperTask(NamedTuple):
    """Everything a paper-task run is built from (``setup_paper_task``)."""
    device: torch.device
    fed: FederatedDataset
    logits_fn: object
    loss_fn: object
    client_opt: object
    server_opt: object
    params: dict               # initial params, on ``device``
    local_steps: int           # K: one local epoch
    participation: float
    scenario: object           # resolved Scenario, or None
    compression: CompressionSpec
    cohort: int                # C, clients per round
    num_registered: Optional[int]  # the fleet's C_registered, or None


def setup_paper_task(args) -> PaperTask:
    scn = resolve_scenario(args)
    device = resolve_device(args.device)
    num_reg, participation = resolve_fleet(args, scn)
    task = get_task(args.task, seed=args.seed)
    fed = FederatedDataset.build(task, num_clients=args.num_clients,
                                 alpha=args.alpha, seed=args.seed,
                                 scenario=scn, num_registered=num_reg)
    init_fn, logits_fn = make_small_model(MODELS[args.model])
    fl = FLConfig(client_opt=args.client_opt, server_opt=args.server_opt,
                  lr=args.lr, fedprox_mu=args.fedprox_mu,
                  num_clients=args.num_clients, participation=participation)
    loss_fn = make_loss(
        lambda p, b: (softmax_ce(logits_fn(p, b["x"]), b["y"]), {}),
        fedprox_mu=fl.fedprox_mu)
    return PaperTask(device, fed, logits_fn, loss_fn,
                     get_client_opt(fl.client_opt, fl),
                     get_server_opt(fl.server_opt),
                     tree_map(lambda t: t.to(device), init_fn(args.seed)),
                     fed.epoch_steps(args.batch), participation, scn,
                     resolve_compression(args),
                     cohort_size(participation, fed.registered_clients),
                     num_reg)


def init_state(pt: PaperTask):
    """The run's initial FLState: with the async buffer under an async
    scenario, and with the cohort's EF21 tree under error feedback, but
    not in the fleet regime, whose EF21 rows live in the arena."""
    fleet = pt.num_registered is not None
    return init_fl_state(pt.params, pt.server_opt, pt.scenario,
                         compression=None if fleet else pt.compression,
                         cohort=pt.cohort)


def _round_kw(pt: PaperTask, args) -> dict:
    """The scenario and compression arguments of the run's round."""
    return dict(scenario=pt.scenario, num_clients=args.num_clients,
                client_sizes=(pt.fed.client_sizes() if pt.scenario
                              else None),
                compression=pt.compression, telemetry=args.telemetry)


class BlockRunner:
    """The round-fused loop of a run (the fleet loop in the fleet
    regime) with what it carries beside the FLState: the example arena,
    staged on the device once, and in the fleet regime the
    ``ClientArena`` (``clients``: per registered client the η carry,
    the participation counters and, under active error feedback, the
    (C_registered, N) EF21 slab), restored with --resume from the
    checkpoint of round ``round0``. ``stage(round0, R)`` makes a block's
    draws on the host (the data pipeline's cohort and example draws)
    and copies its (R, C, K, b) gather indices, and in the fleet its
    (R, C) cohort ids, to the device; ``runner(fstate, staged)`` runs
    the block -> (fstate, metrics stacked over its R rounds)."""

    def __init__(self, pt: PaperTask, args, round0: int = 0):
        self.pt, self.batch = pt, args.batch
        self.clients = None
        if pt.num_registered is not None:
            self.loop = make_fleet_loop(
                pt.loss_fn, pt.client_opt, pt.server_opt,
                params_like=pt.params, num_rounds=args.rounds,
                num_registered=pt.fed.registered_clients,
                rounds_per_call=max(1, args.rounds_per_call),
                scenario=pt.scenario, compression=pt.compression,
                gather=arena_gather, eta_carry=args.eta_carry,
                telemetry=args.telemetry)
            use_ef = (pt.compression.error_feedback
                      and pt.compression.active(pt.scenario))
            self.clients = _maybe_resume_arena(args, arena_init(
                pt.fed.registered_clients, eta0=self.loop.eta0,
                ef_width=self.loop.layout.padded_size if use_ef else None,
                device=pt.device), round0)
        else:
            self.loop = make_fl_loop(
                pt.loss_fn, pt.client_opt, pt.server_opt,
                params_like=pt.params, num_rounds=args.rounds,
                rounds_per_call=args.rounds_per_call, gather=arena_gather,
                **_round_kw(pt, args))
        self.layout = self.loop.layout
        self.examples = {k: torch.from_numpy(v).to(pt.device)
                         for k, v in pt.fed.arena().items()}

    def stage(self, round0: int, rounds: int):
        pt = self.pt
        idx, _, ids = pt.fed.sample_block(pt.participation, pt.local_steps,
                                          self.batch, round0=round0,
                                          rounds=rounds)
        idx = torch.from_numpy(idx).to(pt.device)
        if self.clients is None:
            return idx, None
        return idx, torch.from_numpy(ids.astype(np.int32)).to(pt.device)

    def __call__(self, fstate, staged):
        idx, ids = staged
        if self.clients is None:
            return self.loop(fstate, idx, arena=self.examples)
        (fstate, self.clients), mets = self.loop(
            (fstate, self.clients), idx, arena=self.examples,
            cohort_ids=ids)
        return fstate, mets


def _arena_dir(ckpt_dir: str) -> str:
    """Fleet-arena checkpoints live in a subdirectory of the FLState
    checkpoint dir: ``latest_step`` and the keep-newest GC see only
    ``step_*`` entries, so the two streams never see each other."""
    return os.path.join(ckpt_dir, "arena")


def _save(args, state, spans, arena=None) -> None:
    """Checkpoint ``state`` (and the fleet ``arena``) at step
    ``state.round``: saves are keyed on completed rounds, not on the
    loop index, so after a --resume the new saves sort above the old."""
    with spans.span("ckpt"):
        save(args.ckpt_dir, state, step=state.round)
        if arena is not None:
            save(_arena_dir(args.ckpt_dir), arena, step=state.round)


def _maybe_resume(args, state):
    """With --resume and a checkpoint under --ckpt-dir: the newest one,
    restored into ``state``'s structure (buffer and EF21 tree included)."""
    if args.ckpt_dir and args.resume and latest_step(args.ckpt_dir) \
            is not None:
        state, step = restore(args.ckpt_dir, like=state)
        print(f"resumed from checkpoint step {step} (round {state.round})",
              flush=True)
    return state


def _maybe_resume_arena(args, arena: ClientArena, round_: int):
    """The fleet arena saved beside the FLState checkpoint at round
    ``round_``. A cold arena, with a warning, when that checkpoint has
    none (saved before a fleet run); a different shape (another
    --num-registered or --error-feedback) raises."""
    if not (args.ckpt_dir and args.resume):
        return arena
    adir = _arena_dir(args.ckpt_dir)
    newest = latest_step(adir)
    if newest is None:
        return arena
    if not os.path.isdir(os.path.join(adir, f"step_{round_:08d}")):
        warnings.warn(f"no arena checkpoint at round {round_} under {adir} "
                      f"(latest is {newest}): resuming with a cold arena, "
                      "η warm starts and participation counters reset")
        return arena
    arena, step = restore(adir, like=arena, step=round_)
    print(f"resumed fleet arena from step {step}", flush=True)
    return arena


def _run_fused(run, device: torch.device, args, state, on_round, events,
               spans):
    """R-round blocks of the fused loop ``run`` (a ``BlockRunner`` or an
    ``LMBlockRunner``). The block boundary is the host sync point: one
    device-to-host copy for the block's metric rows, and the event log
    flushes there. It is also the checkpoint cadence: a save lands on
    the first boundary at or after each --ckpt-every hit, and after the
    last block. ``--profile r`` runs the block that holds (1-based)
    round r under ``torch.profiler`` and emits its kernel launches as a
    ``static`` event. Returns the final FLState and the fleet's
    ClientArena (None outside the fleet)."""
    with spans.span("pack"):
        fstate = flatten_fl_state(state, run.layout)
    R = max(1, args.rounds_per_call)
    base, t, profiled = state.round, 0, False
    while t < args.rounds:
        n = min(R, args.rounds - t)
        with spans.span("stage"):
            staged = run.stage(fstate.round, n)
        do_profile = (args.profile > 0 and not profiled
                      and t <= args.profile - 1 < t + n)
        with spans.span("block_execute"):
            if do_profile:
                before = kernel_launch_snapshot(device.type)
                fstate, mets = trace_block(
                    lambda fs=fstate: run(fs, staged), args.profile_dir)
                after = kernel_launch_snapshot(device.type)
                profiled = True
            else:
                fstate, mets = run(fstate, staged)
        if do_profile:
            static = static_telemetry(rounds=n, launches={
                k: v - before.get(k, 0) for k, v in after.items()
                if v != before.get(k, 0)})
            print("static telemetry:", json.dumps(static), flush=True)
            if events is not None:
                events.emit("static", **static)
        with spans.span("convert"):
            rows = _rows(mets)
        for r, row in enumerate(rows):
            on_round(t + r, row)
            if events is not None:
                events.emit("round", t=t + r, round=base + t + r, **row)
        if events is not None:
            events.flush()
        t += n
        hit = any(t0 % args.ckpt_every == 0 for t0 in range(t - n, t))
        if args.ckpt_dir and (hit or t >= args.rounds):
            _save(args, unflatten_fl_state(fstate, run.layout), spans,
                  run.clients)
    if args.profile > 0 and not profiled:
        print(f"--profile {args.profile}: no block contained that round "
              f"(run is {args.rounds} rounds); no trace captured",
              flush=True)
    with spans.span("unpack"):
        return unflatten_fl_state(fstate, run.layout), run.clients


def _host_flat(args, scenario, compression) -> bool:
    """The host loop's engine, by the reference's rule: flat with
    ``--flat``, active compression or an async scenario, else vmap."""
    return bool(args.flat or compression.active(scenario)
                or (scenario is not None and scenario.is_async))


def _run_host(round_fn, stage_round, args, state, on_round, events, spans):
    """Rounds one at a time through ``round_fn``; ``stage_round(r)``
    gives round r's batches on the device and its cohort ids (or None).
    Metric rows buffer on the device and reach the host once per
    ``--log-every`` rounds. With --ckpt-dir every --ckpt-every-th round
    and the last one are saved."""
    rlog = _RoundLog(_log_every(args), on_round, events, spans)
    for t in range(args.rounds):
        with spans.span("stage"):
            batches, ids = stage_round(state.round)
        with spans.span("block_execute"):
            state, mets, _ = round_fn(state, batches)
        rlog.push(t, state.round - 1, mets, ids)
        if args.ckpt_dir and (t % args.ckpt_every == 0
                              or t == args.rounds - 1):
            _save(args, state, spans)
    rlog.flush()
    return state


def _round_logger(args, history: List[dict], stats):
    """The per-round consumer: keeps the row, feeds the scenario report
    and prints about ten rounds a run."""
    t0 = time.time()

    def log_round(t, row, ids=None):
        history.append(row)
        if stats is not None:
            stats.update(ids, row)
        if t % max(1, args.rounds // 10) == 0 or t == args.rounds - 1:
            fleet = (f" revisit {float(row['revisit_frac']):.2f}"
                     if "revisit_frac" in row else "")
            print(f"round {t:4d} loss {float(row['loss']):.4f} "
                  f"eta {float(row['eta_mean']):.4f}{fleet}"
                  f"{_health_str(row)} ({time.time() - t0:.1f}s)",
                  flush=True)
    return log_round


def train_paper_task(args) -> TrainResult:
    pt = setup_paper_task(args)
    state = _maybe_resume(args, init_state(pt))
    history: List[dict] = []
    stats = (_ScenarioStats(pt.scenario, pt.fed.registered_clients)
             if (pt.scenario is not None or pt.num_registered is not None
                 or pt.compression.active(pt.scenario) or args.telemetry)
             else None)
    events = (EventLog(args.events, config=vars(args), device=pt.device)
              if args.events else None)
    spans = SpanTimer()
    log_round = _round_logger(args, history, stats)

    if args.rounds_per_call > 1 or pt.num_registered is not None:
        state, car = _run_fused(BlockRunner(pt, args, state.round),
                                pt.device, args, state, log_round, events,
                                spans)
    else:
        car = None
        round_fn = make_fl_round(
            pt.loss_fn, pt.client_opt, pt.server_opt,
            num_rounds=args.rounds,
            flat=_host_flat(args, pt.scenario, pt.compression),
            **_round_kw(pt, args))

        def stage_round(r):
            batches, _, ids = pt.fed.sample_round(
                pt.participation, pt.local_steps, args.batch, round_idx=r)
            return {k: torch.from_numpy(v).to(pt.device)
                    for k, v in batches.items()}, ids
        state = _run_host(round_fn, stage_round, args, state, log_round,
                          events, spans)

    with spans.span("eval"):
        xt, yt = pt.fed.test_batch(2000)
        with torch.no_grad():
            logits = pt.logits_fn(state.params,
                                  torch.from_numpy(xt).to(pt.device))
            acc = float(accuracy(logits,
                                 torch.from_numpy(yt).to(pt.device)))
    if stats is not None:
        stats.report(args.out, extra={"final_acc": acc})
    print(f"final test-acc {acc:.4f}", flush=True)
    _finish_run(events, spans, bool(args.telemetry or args.events
                                    or args.profile))
    return TrainResult(state, history, acc, car)


class LMTask(NamedTuple):
    """Everything an LM run is built from (``setup_lm``)."""
    device: torch.device
    model: Model
    loss_fn: object
    client_opt: object
    server_opt: object
    params: dict               # initial params, on ``device``
    local_steps: int           # K
    scenario: object           # resolved Scenario, or None
    compression: CompressionSpec
    cohort: int                # C, --clients-per-round


def setup_lm(args, cfg=None) -> LMTask:
    """The LM run's model (``--arch``, ``--reduced`` to ``--layers`` x
    ``--d-model``; or ``cfg``, such as a full-width config cut in
    depth), its random params from ``--seed`` on the device, its client
    loss on the plain route, optimizers, scenario and compression."""
    if args.num_registered:
        raise SystemExit("--num-registered (the fleet regime) is a "
                         "paper-task feature: synthetic LM batches have "
                         "no per-client partitions to map registered "
                         "ids onto — use --task, not --arch")
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced(num_layers=args.layers, d_model=args.d_model)
    model = build_model(cfg, torch.float32)
    scn = resolve_scenario(args)
    fl = FLConfig(local_steps=args.local_steps, client_opt=args.client_opt,
                  server_opt=args.server_opt, lr=args.lr,
                  fedprox_mu=args.fedprox_mu, num_clients=args.num_clients)
    # the plain route, as the reference's trainer takes it: --use-pallas
    # reaches the client optimizer only
    loss_fn = make_loss(lambda p, b: model.loss(p, b, use_pallas=False),
                        fedprox_mu=fl.fedprox_mu)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    return LMTask(device, model, loss_fn,
                  get_client_opt(fl.client_opt, fl,
                                 use_pallas=args.use_pallas),
                  get_server_opt(fl.server_opt), params, fl.local_steps,
                  scn, resolve_compression(args), args.clients_per_round)


def init_lm_state(lt: LMTask):
    """The LM run's initial FLState (with the async buffer and the
    cohort's EF21 tree where the run needs them)."""
    return init_fl_state(lt.params, lt.server_opt, lt.scenario,
                         compression=lt.compression, cohort=lt.cohort)


def lm_batches(lt: LMTask, args, round_idx: int) -> dict:
    """Round ``round_idx``'s (C, K, b, S) tokens and labels, with the
    config's (C, K, b, ...) frames or image embeddings, numpy, from the
    per-round stream ``default_rng((seed, round))``: a --resume at any
    round replays an uninterrupted run's batches."""
    cfg = lt.model.cfg
    return lm_round_batches(np.random.default_rng((args.seed,
                                                   int(round_idx))),
                            clients=lt.cohort, local_steps=lt.local_steps,
                            batch=args.batch, seq=args.seq,
                            vocab=cfg.vocab_size, extras=batch_extras(cfg))


class LMBlockRunner:
    """The LM run's round-fused loop: ``stage(round0, R)`` draws R
    rounds of batches on the host and copies them, stacked (R, C, K, b,
    ...) with the extras beside the tokens, to the device;
    ``runner(fstate, staged)`` runs the block -> (fstate, metrics
    stacked over its R rounds)."""
    clients = None             # no fleet arena

    def __init__(self, lt: LMTask, args):
        self.lt, self.args = lt, args
        self.loop = make_fl_loop(
            lt.loss_fn, lt.client_opt, lt.server_opt, params_like=lt.params,
            num_rounds=args.rounds, rounds_per_call=args.rounds_per_call,
            scenario=lt.scenario, num_clients=args.num_clients,
            compression=lt.compression, telemetry=args.telemetry)
        self.layout = self.loop.layout

    def stage(self, round0: int, rounds: int) -> dict:
        blocks = [lm_batches(self.lt, self.args, round0 + i)
                  for i in range(rounds)]
        return {k: torch.from_numpy(np.stack([b[k] for b in blocks])
                                    ).to(self.lt.device)
                for k in blocks[0]}

    def __call__(self, fstate, staged):
        return self.loop(fstate, staged)


def train_lm(args, lt: Optional[LMTask] = None) -> TrainResult:
    """Federated training of a decoder LM on synthetic tokens: the
    fused loop with ``--rounds-per-call`` > 1, else the host loop (flat
    or vmap engine by the reference's rule). ``lt`` is the run's
    ``setup_lm(args)``, made here when not given (a test passes one with
    the reference's params carried in)."""
    lt = setup_lm(args) if lt is None else lt
    if lt.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(lt.device)
    state = _maybe_resume(args, init_lm_state(lt))
    history: List[dict] = []
    stats = (_ScenarioStats(lt.scenario, args.num_clients)
             if (lt.scenario is not None
                 or lt.compression.active(lt.scenario) or args.telemetry)
             else None)
    events = (EventLog(args.events, config=vars(args), device=lt.device)
              if args.events else None)
    spans = SpanTimer()
    log_round = _round_logger(args, history, stats)
    if args.rounds_per_call > 1:
        state, _ = _run_fused(LMBlockRunner(lt, args), lt.device, args,
                              state, log_round, events, spans)
    else:
        round_fn = make_fl_round(
            lt.loss_fn, lt.client_opt, lt.server_opt,
            num_rounds=args.rounds,
            flat=_host_flat(args, lt.scenario, lt.compression),
            scenario=lt.scenario, num_clients=args.num_clients,
            compression=lt.compression, telemetry=args.telemetry)

        def stage_round(r):
            return {k: torch.from_numpy(v).to(lt.device)
                    for k, v in lm_batches(lt, args, r).items()}, None
        state = _run_host(round_fn, stage_round, args, state, log_round,
                          events, spans)
    if stats is not None:
        stats.report(args.out)
    if lt.device.type == "cuda":
        print(f"peak device memory "
              f"{torch.cuda.max_memory_allocated(lt.device) / 1e9:.2f} GB "
              f"({torch.cuda.get_device_name(lt.device)})", flush=True)
    _finish_run(events, spans, bool(args.telemetry or args.events
                                    or args.profile))
    return TrainResult(state, history, None)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no GPU without "
                         "--device cpu is an error")
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--task", default=None,
                    choices=["easy", "medium", "hard", "image", "lm"])
    ap.add_argument("--model", default="mlp", choices=sorted(MODELS))
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--num-clients", type=int, default=100)
    ap.add_argument("--num-registered", type=int, default=None,
                    help="fleet regime: C_registered clients the cohort "
                         "is drawn over; registered client i trains on "
                         "data partition i %% num_clients. Defaults to a "
                         "fleet preset's 100,000, else no fleet")
    ap.add_argument("--participation", type=float, default=None,
                    help="participation rate p (|S_t| = p*m); defaults to "
                         "a fleet preset's 0.0005, else 0.1")
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--client-opt", default="delta_sgd",
                    choices=CLIENT_OPTS)
    ap.add_argument("--server-opt", default="fedavg", choices=SERVER_OPTS)
    ap.add_argument("--scenario", default=None,
                    help="federation preset "
                         "(repro_torch.federation.scenarios)")
    ap.add_argument("--out", default=None,
                    help="write the scenario report JSON here")
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--robust-agg", default="mean",
                    choices=["mean", "clip", "trimmed", "median"])
    ap.add_argument("--quorum", type=int, default=0)
    ap.add_argument("--lr", type=float, default=0.05,
                    help="step size of the sgd, sgdm (and their decayed "
                         "variants), adam and adagrad clients")
    ap.add_argument("--fedprox-mu", type=float, default=0.0)
    ap.add_argument("--use-pallas", action="store_true",
                    help="--arch: the vmap engine's Δ-SGD step on its "
                         "kernel route (the model trains on its plain "
                         "route). --task ignores it, as the reference's "
                         "paper task does. The flat engines always run "
                         "the kernels")
    ap.add_argument("--rounds-per-call", type=int, default=1,
                    help="R > 1 fuses R rounds per call on persistent flat "
                         "state (repro_torch.core.fed_loop)")
    ap.add_argument("--flat", action="store_true",
                    help="host loop on the flat Δ-SGD engine (the engine "
                         "--rounds-per-call fuses, for bitwise parity "
                         "runs) instead of the vmap engine")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint the FLState here (the fleet arena in "
                         "its arena/ subdirectory)")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint under "
                         "--ckpt-dir for --rounds more rounds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry", action="store_true",
                    help="the round's telemetry block (repro_torch."
                         "telemetry): eta histogram, loss deciles, guard "
                         "counts; the trajectory stays bitwise the same")
    ap.add_argument("--log-every", type=int, default=0,
                    help="host-loop metric conversion interval (rounds "
                         "per device-to-host copy); 0 = ~10 per run")
    ap.add_argument("--events", default=None,
                    help="write a JSONL event log here (header, round, "
                         "static and spans events)")
    ap.add_argument("--profile", type=int, default=0,
                    help="profile the fused block holding this (1-based) "
                         "round: torch.profiler trace to --profile-dir "
                         "and a static event of its kernel launches; "
                         "needs --rounds-per-call > 1")
    ap.add_argument("--profile-dir", default="experiments/profile",
                    help="torch.profiler trace output directory")
    ap.add_argument("--k-frac", type=float, default=0.25)
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--eta-carry", action="store_true",
                    help="fleet: warm-start a returning client's eta0 from "
                         "its arena row (off: Algorithm 1's reset)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--clients-per-round", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    return ap


def main(argv: Optional[List[str]] = None) -> TrainResult:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.profile and args.rounds_per_call <= 1:
        ap.error("--profile needs the round-fused engine: pass "
                 "--rounds-per-call > 1")
    if args.arch:
        return train_lm(args)
    if args.task:
        return train_paper_task(args)
    ap.error("pass --arch or --task")


if __name__ == "__main__":
    main()
