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
the scalars (``eta_hist`` (R, B), ``loss_deciles`` (R, Q)). Capturing a block as a CUDA graph is later
performance work; the fleet loop (ROADMAP A14) and the block-sharded
loop (A17) are not ported.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import flat as flatlib
from repro_torch.core.fed_round import FLState, _reject, make_fl_round
from repro_torch.utils.tree import tree_leaves, tree_map


class FlatFLState(NamedTuple):
    """FLState in persistent flat form: ``P`` is the packed (N,) f32
    global params; ``ef`` (EF21 compression) the packed (C, N) f32
    reconstruction slab; ``server_state`` keeps its tree form and
    ``buffer`` (the async FedBuff buffer, ROADMAP A10) is always None."""
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
    to the round (``make_fl_round``)."""
    _reject(block_sharded=block_sharded)
    if not flat:
        raise ValueError("the round-fused loop requires the flat engine "
                         "(flat=True): the carry is the packed flat buffer")
    if rounds_per_call < 1:
        raise ValueError(f"rounds_per_call must be >= 1, got "
                         f"{rounds_per_call}")
    round_fn = make_fl_round(loss_fn, client_opt, server_opt,
                             num_rounds=num_rounds, weighted=weighted,
                             flat=flat, mesh=mesh, federation=federation,
                             scenario=scenario, num_clients=num_clients,
                             client_sizes=client_sizes,
                             compression=compression, telemetry=telemetry)
    body = round_fn.flat_body
    layout = flatlib.layout_of(params_like)

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
        stacked = {k: torch.stack([m[k] for m in rows]) for k in rows[0]}
        return carry, stacked

    loop_fn.layout = layout
    return loop_fn
