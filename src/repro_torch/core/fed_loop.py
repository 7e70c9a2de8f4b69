"""Round-fused training loop on persistent flat state.

Port of the non-sharded ``make_fl_loop`` of ``repro/core/fed_loop.py``.
The carried state is a ``FlatFLState``: the param tree packed into the
``(N,)`` flat buffer once per R-round block (``flatten_fl_state``) and
unpacked only at block boundaries (``unflatten_fl_state``). A block runs
R rounds of the SAME ``flat_body`` the single-round engine runs, in a
plain Python loop, so fused and host-loop rounds are bitwise equal by
construction and a block launches exactly 2·K·R kernels. Per-round
batches come pre-stacked with a leading R axis, or as (R, C, K, b)
gather indices into a device-resident example arena (``arena_gather``).
Metrics come back stacked over the R rounds.

Scenarios, compression and telemetry compose with the loop as with the
single round, because the loop runs the round's own body; the EF21 slab
rides in the carried state, and the telemetry distributions stack like
the scalars (``eta_hist`` (R, B), ``loss_deciles`` (R, Q)); the async
FedBuff buffer rides in the carried state. Capturing a block as a CUDA
graph is later performance work (ROADMAP A8).

Under a mesh (``mesh=``, ``federation=``) the loop runs the round's body
on this rank's block (``repro_torch.core.fed_round``) and carries the
rank's ``FlatFLState``: the (N,) params whole, the EF21 slab as the
rank's (C_loc, N_loc) block; ``round_data`` holds the rank's clients'
batches (R, C_loc, K, ...) (under training rules their rows cut by
``launch.steps.place_train_for_rank``, the local steps then on the
rank's tensor-parallel blocks, ``core.sharded``) and ``client_weights``
the whole (R, C) block. The reference's block path (``block_sharded=True``) folds the R
rounds into one ``shard_map`` to enter the mesh once a block; a rank here
runs the same body either way, so ``block_sharded`` keeps the reference's
API, its refusals (clients only, ``flat_shards(mesh) == 1``; no fault,
robust or quorum tail) and what its block path reports: no
``loss_deciles``, which keeps the round at two collectives, one packed
sum of (N + 5,) elements ((N + 5 + B,) with telemetry's B η-histogram
bins) and one (2,) min.

Fleet loop (``make_fleet_loop``): C_registered clients, only the sampled
cohort materialized per round. A ``repro_torch.federation.arena
.ClientArena`` holds per-REGISTERED-client state (Δ-SGD η carry, EF21
reconstruction, participation history) in (C_registered, ...) device
storage. Each round gathers the cohort's rows (``arena_take``), runs the
same ``flat_body`` on the cohort slab, and writes the rows back
(``arena_update``); a never-sampled client's rows keep their bits. The
reference draws the cohort inside the loop, on the device with
``jax.random``, the same draw its host data pipeline makes. The port's
schedulers draw on the host with numpy, so the pipeline's draw is the
only one: the caller hands the loop the block's (R, C) ids, the ids the
pipeline gathered the block's batches for
(``FederatedDataset.sample_block``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import flat as flatlib
from repro_torch.core.fed_round import FLState, make_fl_round
from repro_torch.telemetry.spec import resolve_telemetry
from repro_torch.utils.numerics import xla_mean
from repro_torch.utils.tree import tree_leaves, tree_map


class FlatFLState(NamedTuple):
    """FLState in persistent flat form: ``P`` is the packed (N,) f32
    global params; ``ef`` (EF21 compression) the packed (C, N) f32
    reconstruction slab; ``server_state`` and the async ``buffer`` keep
    their tree form."""
    P: torch.Tensor
    server_state: Any
    round: int
    buffer: Any = None
    ef: Any = None


def flatten_fl_state(state: FLState, layout: flatlib.FlatLayout
                     ) -> FlatFLState:
    """Pack an FLState once per R-round block (exact: bf16 -> f32 widens,
    and the ef tree is f32 already)."""
    ef = state.ef
    if ef is not None:
        ef = flatlib.pack_batched(ef, layout)
    return FlatFLState(flatlib.pack(state.params, layout),
                       state.server_state, state.round, state.buffer, ef)


def unflatten_fl_state(fstate: FlatFLState, layout: flatlib.FlatLayout
                       ) -> FLState:
    """Back to tree form: eval / checkpoint cadence only. The ef tree
    stays f32 (views of the slab)."""
    ef = fstate.ef
    if ef is not None:
        ef = flatlib.unpack_batched(ef, layout, cast=False)
    return FLState(flatlib.unpack(fstate.P, layout), fstate.server_state,
                   fstate.round, fstate.buffer, ef)


def arena_gather(arena, idx: torch.Tensor):
    """Device-side per-round batch gather: ``idx`` (C, K, b) rows index
    the staged arena (leaves (num_examples, ...)) -> (C, K, b, ...)."""
    return tree_map(lambda a: a[idx], arena)


def _stack_rows(rows):
    """Per-round metric dicts -> one dict of (R, ...) stacks."""
    return {k: torch.stack([m[k] for m in rows]) for k in rows[0]}


def make_fl_loop(loss_fn, client_opt, server_opt, *, params_like,
                 num_rounds: int, rounds_per_call: int = 8,
                 weighted: bool = False, flat=True, mesh=None,
                 federation=None, scenario=None,
                 num_clients: Optional[int] = None, client_sizes=None,
                 compression=None, gather=None,
                 block_sharded: bool = False, telemetry=None):
    """Build the R-round fused loop.

    Returns ``loop_fn(fstate, round_data, client_weights=None,
    arena=None) -> (fstate, metrics)``: ``round_data`` leaves carry a
    leading R axis (stacked (R, C, K, b, ...) batches, or with ``gather``
    (R, C, K, b) indices into ``arena``); ``client_weights`` is an
    optional (R, C) block; ``metrics`` leaves are stacked over R.
    ``params_like`` (a params tree, or anything with shapes and dtypes)
    fixes the flat layout. ``rounds_per_call`` is advisory: the R of a
    call is the leading axis of ``round_data``. ``telemetry`` is passed
    to the round (``make_fl_round``). ``mesh``/``federation`` and
    ``block_sharded`` are described in the module docstring."""
    if not flat:
        raise ValueError("the round-fused loop requires the flat engine "
                         "(flat=True): the carry is the packed flat buffer")
    if rounds_per_call < 1:
        raise ValueError(f"rounds_per_call must be >= 1, got "
                         f"{rounds_per_call}")
    if block_sharded:
        if mesh is None or federation is None:
            raise ValueError("block_sharded=True requires mesh= and "
                             "federation=")
        if federation.flat_shards(mesh) != 1:
            raise ValueError(
                "the block-level shard_map shards CLIENTS only — each "
                "device carries full-N rows for its C_loc clients, so "
                "the flat dim must be replicated: use a FederationSpec "
                "whose fsdp/tp axes are absent from the mesh "
                f"(flat_shards == 1, got "
                f"{federation.flat_shards(mesh)})")
        if scenario is not None and (scenario.faulty or scenario.robust
                                     or scenario.quorum > 0):
            raise ValueError(
                "fault injection / robust aggregation / quorum are not "
                "supported on the block-sharded path — their "
                "order-statistic tails need cross-client data movement; "
                "use the per-round sharded engine "
                "(make_fl_loop(mesh=..., block_sharded=False))")
        # a cross-client sort has no shard-local form: the reference's
        # block path reports no loss_deciles
        telemetry = resolve_telemetry(telemetry)._replace(
            loss_deciles=False)
    round_fn = make_fl_round(loss_fn, client_opt, server_opt,
                             num_rounds=num_rounds, weighted=weighted,
                             flat=flat, mesh=mesh, federation=federation,
                             scenario=scenario, num_clients=num_clients,
                             client_sizes=client_sizes,
                             compression=compression, telemetry=telemetry)
    body = round_fn.flat_body
    shards = federation.flat_shards(mesh) if mesh is not None else 1
    layout = flatlib.layout_of(params_like, shards=shards)

    def loop_fn(carry: FlatFLState, round_data, client_weights=None,
                arena=None):
        if gather is not None and arena is None:
            raise ValueError("this loop gathers batches from a staged "
                             "arena: pass arena=")
        R = tree_leaves(round_data)[0].shape[0]
        rows = []
        for r in range(R):
            data = tree_map(lambda x: x[r], round_data)
            batches = gather(arena, data) if gather is not None else data
            w_r = client_weights[r] if client_weights is not None else None
            carry, metrics, _ = body(carry, batches, layout,
                                     client_weights=w_r)
            rows.append(metrics)
        return carry, _stack_rows(rows)

    loop_fn.layout = layout
    return loop_fn


def make_fleet_loop(loss_fn, client_opt, server_opt, *, params_like,
                    num_rounds: int, num_registered: int,
                    rounds_per_call: int = 8, weighted: bool = False,
                    flat=True, scenario=None, compression=None,
                    gather=None, batch_index_fn=None,
                    eta_carry: bool = False, telemetry=None):
    """Fleet-scale fused loop: C_registered clients, only the sampled
    cohort materialized per round.

    Returns ``loop_fn(carry, round_data, client_weights=None,
    arena=None, *, cohort_ids) -> (carry, metrics)``, ``carry`` the pair
    ``(FlatFLState, ClientArena)`` and ``cohort_ids`` the block's
    (R, C) int32 registered ids (< ``num_registered``) on the device:
    the data pipeline's draw, so data and state stay aligned. Per round
    the loop

      1. gathers the cohort's arena rows (``arena_take``): the EF21 slab
         and the η carry enter the round body as ``FlatFLState.ef`` and
         ``eta0_c``;
      2. runs the flat round body (the one ``make_fl_loop`` chains);
      3. writes the rows back in place (``arena_update``): round-end η
         (only through lanes whose NaN guard held), ``rounds_seen + 1``,
         ``last_round = round`` and the new EF21 rows. Every other row
         keeps its bits.

    ``round_data`` leaves carry a leading R axis: stacked batches
    (R, C, K, b, ...), or with ``gather`` (R, C, K, b) indices into
    ``arena``; with ``batch_index_fn(ids, round) -> (C, K, b)`` the
    indices come from the ids on the device and ``round_data`` is
    ignored. ``eta_carry=True`` warm-starts a returning client's η₀
    from its arena row; the default keeps Algorithm 1's per-round reset,
    and then, with ``num_registered`` equal to the data's client count,
    the loop equals ``make_fl_loop`` bitwise. Each round adds
    ``cohort_ids``, ``revisit_frac``, ``realized_stale_mean`` and
    ``eta_carry_mean`` to its metrics. A block launches 2·K·R Δ-SGD
    kernels."""
    if not flat:
        raise ValueError("the fleet loop requires the flat engine "
                         "(flat=True)")
    if num_registered < 1:
        raise ValueError(f"num_registered must be >= 1, got "
                         f"{num_registered}")
    from repro_torch.federation.arena import (ClientArena, arena_take,
                                              arena_update)
    round_fn = make_fl_round(loss_fn, client_opt, server_opt,
                             num_rounds=num_rounds, weighted=weighted,
                             flat=flat, scenario=scenario,
                             compression=compression, telemetry=telemetry)
    body = round_fn.flat_body
    layout = flatlib.layout_of(params_like)
    if compression is not None or (
            scenario is not None and scenario.bandwidth_heterogeneous):
        from repro_torch.compression import get_compression
        compression = get_compression(compression)
    use_ef = (compression is not None and compression.error_feedback
              and compression.active(scenario))
    eta0 = (client_opt.hyper or {}).get("eta0", 0.0)

    def loop_fn(carry, round_data, client_weights=None, arena=None, *,
                cohort_ids):
        fstate, car = carry
        if not isinstance(car, ClientArena):
            raise ValueError("fleet carry is (FlatFLState, ClientArena): "
                             "build the arena with arena_init()")
        if use_ef and car.ef is None:
            raise ValueError("error-feedback compression needs the "
                             "arena's EF slab: arena_init(..., "
                             "ef_width=layout.padded_size)")
        if (gather is not None or batch_index_fn is not None) \
                and arena is None:
            raise ValueError("this loop gathers batches from a staged "
                             "arena: pass arena=")
        fstate = fstate._replace(ef=None)
        out = []
        for r in range(cohort_ids.shape[0]):
            rnd, ids = fstate.round, cohort_ids[r]
            rows = arena_take(car, ids)
            if batch_index_fn is not None:
                batches = (gather or arena_gather)(
                    arena, batch_index_fn(ids, rnd))
            else:
                data = tree_map(lambda x: x[r], round_data)
                batches = gather(arena, data) if gather is not None \
                    else data
            w_r = client_weights[r] if client_weights is not None else None
            new_fstate, metrics, aux = body(
                fstate._replace(ef=rows.ef if use_ef else None), batches,
                layout, client_weights=w_r,
                eta0_c=rows.eta if eta_carry else None)
            # fleet telemetry from the rows as they were before the round
            seen = (rows.last_round >= 0).to(torch.float32)
            gap = torch.where(rows.last_round >= 0, rnd - rows.last_round,
                              0).to(torch.float32)
            metrics.update(
                cohort_ids=ids, revisit_frac=xla_mean(seen),
                realized_stale_mean=(gap.sum()
                                     / torch.clamp(seen.sum(), min=1.0)),
                eta_carry_mean=xla_mean(rows.eta))
            # η survives only through valid lanes (a latched NaN guard
            # keeps the previous carry); the bookkeeping always advances
            arena_update(car, ids, ClientArena(
                torch.where(aux.valid, aux.etas, rows.eta),
                rows.rounds_seen + 1,
                torch.full_like(rows.last_round, rnd),
                new_fstate.ef if use_ef else None))
            # per-client EF state lives in the arena between rounds
            fstate = new_fstate._replace(ef=None)
            out.append(metrics)
        return (fstate, car), _stack_rows(out)

    loop_fn.layout = layout
    loop_fn.rounds_per_call = rounds_per_call
    loop_fn.eta0 = eta0
    return loop_fn
