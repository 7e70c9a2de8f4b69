"""Federated training driver for the paper tasks (MLP / shallow CNN).

Port of ``train_paper_task`` of ``repro/launch/train.py`` with the
reference's flags, plus ``--device`` (default ``cuda``; ``--device cpu``
runs the plain versions of the kernels on the CPU).

  PYTHONPATH=src python -m repro_torch.launch.train --task image \\
      --model cnn --rounds 4 --rounds-per-call 2

``--rounds-per-call R`` (R > 1) runs the round-fused loop
(``repro_torch.core.fed_loop``): the example arena is staged on the
device once and each R-round block ships only (R, C, K, b) gather
indices. Otherwise rounds run one at a time in a host loop on the same
flat engine (``--flat`` forces it, as in the reference); the two give
bitwise equal params and metrics. The reference runs its vmap engine
when neither is given; the port runs the flat engine there, which the
reference's own tests hold within 1e-5 of the vmap engine for Δ-SGD (the
vmap engine is ROADMAP A7). ``--use-pallas`` is accepted and changes
nothing: the port always goes through its kernel wrappers.

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

Flags of features not ported yet exit with an error naming their
ROADMAP item, and so do the async presets (the FedBuff buffer, A10) and
the fleet presets (the fleet loop, A14).
"""
from __future__ import annotations

import argparse
import time
from typing import List, NamedTuple, Optional

import torch

from repro_torch.compression import CompressionSpec
from repro_torch.configs import CNN_PAPER, MLP_SMALL, MLP_WIDE, FLConfig
from repro_torch.core import (arena_gather, flatten_fl_state,
                              get_client_opt, get_server_opt, init_fl_state,
                              make_fl_loop, make_fl_round, make_loss,
                              unflatten_fl_state)
from repro_torch.data.pipeline import FederatedDataset
from repro_torch.data.synthetic import get_task
from repro_torch.device import resolve_device
from repro_torch.federation import cohort_size, get_scenario
from repro_torch.models.small import accuracy, make_small_model, softmax_ce
from repro_torch.utils.tree import tree_map

MODELS = {"mlp": MLP_SMALL, "mlp-wide": MLP_WIDE, "cnn": CNN_PAPER}

# flag -> (its default, the ROADMAP item that ports it): any other value
# exits with an error naming the item
_NOT_PORTED = {
    "arch": (None, "A15 (LM zoo)"),
    "reduced": (False, "A15 (LM zoo)"),
    "layers": (4, "A15 (LM zoo)"),
    "d_model": (512, "A15 (LM zoo)"),
    "clients_per_round": (4, "A15 (LM zoo)"),
    "local_steps": (4, "A15 (LM zoo)"),
    "seq": (256, "A15 (LM zoo)"),
    "lr": (0.05, "A6 (client optimizers)"),
    "num_registered": (None, "A14 (fleet)"),
    "telemetry": (False, "A13 (telemetry)"),
    "events": (None, "A13 (telemetry)"),
    "profile": (0, "A13 (telemetry)"),
    "profile_dir": ("experiments/profile", "A13 (telemetry)"),
    "log_every": (0, "A13 (telemetry)"),
    "eta_carry": (False, "A14 (fleet)"),
    "ckpt_dir": (None, "A9 (checkpointing)"),
    "ckpt_every": (20, "A9 (checkpointing)"),
    "resume": (False, "A9 (checkpointing)"),
}


class TrainResult(NamedTuple):
    state: object              # final FLState
    history: List[dict]        # per-round metric rows, numpy f32 scalars
    test_acc: float


def check_ported(args) -> None:
    """Raise SystemExit for a flag whose feature is not ported yet."""
    for name, (off, item) in _NOT_PORTED.items():
        if getattr(args, name) != off:
            flag = "--" + name.replace("_", "-")
            raise SystemExit(f"{flag} is not ported to repro_torch yet: it "
                             f"comes with ROADMAP {item}")


def resolve_scenario(args):
    """The preset with the run's --seed threaded in; --robust-agg and
    --quorum fold onto it (and promote a bare run to sync_iid). Async and
    fleet presets exit naming their ROADMAP item."""
    overrides = {}
    if args.robust_agg != "mean":
        overrides["robust_agg"] = args.robust_agg
    if args.quorum:
        overrides["quorum"] = args.quorum
    if not args.scenario and not overrides:
        return None
    scn = get_scenario(args.scenario or "sync_iid", seed=args.seed,
                       **overrides)
    if scn.is_async:
        raise SystemExit(f"--scenario {scn.name} aggregates asynchronously: "
                         "the FedBuff buffer is not ported to repro_torch "
                         "yet, it comes with ROADMAP A10")
    if scn.registered_hint is not None or scn.participation_hint is not None:
        raise SystemExit(f"--scenario {scn.name} runs the fleet loop, which "
                         "is not ported to repro_torch yet: it comes with "
                         "ROADMAP A14")
    return scn


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
    """Stacked (R,) device metrics -> R rows of numpy f32 scalars, with
    one device-to-host copy per key."""
    host = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
    n = len(next(iter(host.values())))
    return [{k: v[r] for k, v in host.items()} for r in range(n)]


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


def setup_paper_task(args) -> PaperTask:
    check_ported(args)
    scn = resolve_scenario(args)
    device = resolve_device(args.device)
    task = get_task(args.task, seed=args.seed)
    fed = FederatedDataset.build(task, num_clients=args.num_clients,
                                 alpha=args.alpha, seed=args.seed,
                                 scenario=scn)
    init_fn, logits_fn = make_small_model(MODELS[args.model])
    participation = 0.1 if args.participation is None else args.participation
    fl = FLConfig(client_opt=args.client_opt, server_opt=args.server_opt,
                  fedprox_mu=args.fedprox_mu,
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
                     cohort_size(participation, args.num_clients))


def init_state(pt: PaperTask):
    """The run's initial FLState, with the EF21 slab when it needs one."""
    return init_fl_state(pt.params, pt.server_opt, pt.scenario,
                         compression=pt.compression, cohort=pt.cohort)


def _round_kw(pt: PaperTask, args) -> dict:
    """The scenario and compression arguments of the run's round."""
    return dict(scenario=pt.scenario, num_clients=args.num_clients,
                client_sizes=(pt.fed.client_sizes() if pt.scenario
                              else None),
                compression=pt.compression)


def make_fused_loop(pt: PaperTask, args):
    """The round-fused loop of a run and its device-resident arena: each
    R-round block ships only (R, C, K, b) gather indices."""
    loop = make_fl_loop(pt.loss_fn, pt.client_opt, pt.server_opt,
                        params_like=pt.params, num_rounds=args.rounds,
                        rounds_per_call=args.rounds_per_call,
                        gather=arena_gather, **_round_kw(pt, args))
    arena = {k: torch.from_numpy(v).to(pt.device)
             for k, v in pt.fed.arena().items()}
    return loop, arena


def block_indices(pt: PaperTask, args, round0: int, rounds: int):
    idx, _, _ = pt.fed.sample_block(pt.participation, pt.local_steps,
                                    args.batch, round0=round0, rounds=rounds)
    return torch.from_numpy(idx).to(pt.device)


def train_paper_task(args) -> TrainResult:
    pt = setup_paper_task(args)
    state = init_state(pt)
    history: List[dict] = []
    t0 = time.time()

    def log_round(t, row):
        history.append(row)
        if t % max(1, args.rounds // 10) == 0 or t == args.rounds - 1:
            print(f"round {t:4d} loss {float(row['loss']):.4f} "
                  f"eta {float(row['eta_mean']):.4f}{_health_str(row)} "
                  f"({time.time() - t0:.1f}s)", flush=True)

    if args.rounds_per_call > 1:
        loop, arena = make_fused_loop(pt, args)
        fstate = flatten_fl_state(state, loop.layout)
        t = 0
        while t < args.rounds:
            n = min(args.rounds_per_call, args.rounds - t)
            fstate, mets = loop(fstate, block_indices(pt, args, fstate.round,
                                                      n), arena=arena)
            for r, row in enumerate(_rows(mets)):
                log_round(t + r, row)
            t += n
        state = unflatten_fl_state(fstate, loop.layout)
    else:
        round_fn = make_fl_round(pt.loss_fn, pt.client_opt, pt.server_opt,
                                 num_rounds=args.rounds, flat=True,
                                 **_round_kw(pt, args))
        for t in range(args.rounds):
            batches, _, _ = pt.fed.sample_round(
                pt.participation, pt.local_steps, args.batch,
                round_idx=state.round)
            batches = {k: torch.from_numpy(v).to(pt.device)
                       for k, v in batches.items()}
            state, mets, _ = round_fn(state, batches)
            log_round(t, _rows({k: v[None] for k, v in mets.items()})[0])

    xt, yt = pt.fed.test_batch(2000)
    with torch.no_grad():
        logits = pt.logits_fn(state.params, torch.from_numpy(xt).to(pt.device))
        acc = float(accuracy(logits, torch.from_numpy(yt).to(pt.device)))
    print(f"final test-acc {acc:.4f}", flush=True)
    return TrainResult(state, history, acc)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no GPU without "
                         "--device cpu is an error")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--task", default=None,
                    choices=["easy", "medium", "hard", "image", "lm"])
    ap.add_argument("--model", default="mlp", choices=sorted(MODELS))
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--num-clients", type=int, default=100)
    ap.add_argument("--num-registered", type=int, default=None)
    ap.add_argument("--participation", type=float, default=None,
                    help="participation rate p (|S_t| = p*m), default 0.1")
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--client-opt", default="delta_sgd")
    ap.add_argument("--server-opt", default="fedavg")
    ap.add_argument("--scenario", default=None,
                    help="synchronous federation preset "
                         "(repro_torch.federation.scenarios)")
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--robust-agg", default="mean",
                    choices=["mean", "clip", "trimmed", "median"])
    ap.add_argument("--quorum", type=int, default=0)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--fedprox-mu", type=float, default=0.0)
    ap.add_argument("--use-pallas", action="store_true",
                    help="accepted for parity with the reference; the port "
                         "always runs its kernel wrappers")
    ap.add_argument("--rounds-per-call", type=int, default=1,
                    help="R > 1 fuses R rounds per call on persistent flat "
                         "state (repro_torch.core.fed_loop)")
    ap.add_argument("--flat", action="store_true",
                    help="host loop on the flat engine (the engine "
                         "--rounds-per-call fuses, for bitwise parity runs)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry", action="store_true")
    ap.add_argument("--log-every", type=int, default=0)
    ap.add_argument("--events", default=None)
    ap.add_argument("--profile", type=int, default=0)
    ap.add_argument("--profile-dir", default="experiments/profile")
    ap.add_argument("--k-frac", type=float, default=0.25)
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--eta-carry", action="store_true")
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
    if not args.task:
        ap.error("pass --task")
    return train_paper_task(args)


if __name__ == "__main__":
    main()
