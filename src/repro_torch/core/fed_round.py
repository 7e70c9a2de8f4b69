"""One federated round on the flat Δ-SGD engine (Algorithm 1).

Port of the flat engine of ``repro/core/fed_round.py``. The round-start
params are packed into an ``(N,)`` f32 buffer (``repro_torch.core.flat``)
and broadcast to a ``(C, N)`` client slab. Each of the K local steps
evaluates per-client losses and gradients with ``torch.func.vmap`` of
``torch.func.grad_and_value`` over the ``(C, ...)`` views of the slab,
packs the gradients, and runs ``flat_delta_sgd_step``: exactly two
kernel launches for all leaves and all clients. Aggregation is one
(weighted) mean over the client axis, then the ServerOpt step.

The round logic lives in ``flat_body``, which works on the flat state of
``repro_torch.core.fed_loop.FlatFLState``; ``round_fn`` is a pack/unpack
wrapper around it and exposes it as ``round_fn.flat_body``, which the
round-fused loop chains. Fused and host-loop rounds are therefore the
same computation.

Not ported yet, and rejected with the ROADMAP item that brings them: the
vmap engine (``flat=False``, A7), scenarios (A10), faults and robust
aggregation (A11), compression (A12), telemetry (A13), mesh sharding
(A17) and the per-client η₀ warm start of the fleet loop (A14).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core import flat as flatlib
from repro_torch.core.client_opt import ClientOpt
from repro_torch.core.delta_sgd import flat_delta_sgd_init, flat_delta_sgd_step
from repro_torch.core.server_opt import ServerOpt
from repro_torch.utils.tree import tree_leaves, tree_map


class FLState(NamedTuple):
    """The synchronous round's state; the async buffer (ROADMAP A10) and
    the EF21 state (A12) join it with their items."""
    params: Any
    server_state: Any
    round: int


class RoundAux(NamedTuple):
    """Per-client round outputs next to the new state: ``P_locals``
    (C, N) round-end local params, ``etas`` (C,) round-end Δ-SGD step
    sizes, ``valid`` (C,) NaN-guard survivors."""
    P_locals: torch.Tensor
    etas: torch.Tensor
    valid: torch.Tensor


def init_fl_state(params, server_opt: ServerOpt, scenario=None,
                  compression=None, cohort: Optional[int] = None) -> FLState:
    _reject(scenario=scenario, compression=compression)
    return FLState(params, server_opt.init(params), 0)


def _reject(**kw) -> None:
    """Raise for an argument whose feature is not ported yet."""
    items = {"scenario": "the scenario axes, ROADMAP A10",
             "compression": "delta compression, ROADMAP A12",
             "telemetry": "the telemetry plane, ROADMAP A13",
             "mesh": "mesh sharding, ROADMAP A17",
             "federation": "mesh sharding, ROADMAP A17",
             "eta0_c": "the fleet loop's per-client η₀, ROADMAP A14",
             "prev_local_params": "the MOON loss, ROADMAP A5",
             "block_sharded": "the block-sharded loop, ROADMAP A17"}
    for name, value in kw.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{name}= is not ported yet: it comes with {items[name]}")


def _round_metrics(losses: torch.Tensor, etas: torch.Tensor) -> dict:
    """``losses`` is (C, K), ``etas`` (C,)."""
    return {"loss": losses.mean(),
            "loss_last_step": losses[:, -1].mean(),
            "eta_mean": etas.mean(),
            "eta_min": etas.min(),
            "eta_max": etas.max()}


def _finish_round(state: FLState, agg, losses, etas, server_opt: ServerOpt,
                  *, extra=None):
    """Shared synchronous round tail: server update + metrics."""
    params, sstate = server_opt.update(state.params, agg,
                                       state.server_state)
    metrics = _round_metrics(losses, etas)
    if extra:
        metrics.update(extra)
    return FLState(params, sstate, state.round + 1), metrics


def make_fl_round(loss_fn, client_opt: ClientOpt, server_opt: ServerOpt, *,
                  num_rounds: int, weighted: bool = False, flat=True,
                  mesh=None, federation=None, scenario=None,
                  num_clients: Optional[int] = None, client_sizes=None,
                  compression=None, telemetry=None):
    """loss_fn(params, batch, global_params, prev_params) -> (loss, metrics).

    Returns round_fn(state, client_batches, client_weights=None,
    prev_local_params=None) -> (state, metrics, new_local_params). Every
    leaf of ``client_batches`` is (C, K, ...).

    ``flat``: True (or the reference's "pallas"/"xla") selects the flat
    Δ-SGD engine; its two kernels run on the device of the tensors.
    ``num_rounds``, ``num_clients`` and ``client_sizes`` are accepted for
    signature parity; the flat sync round reads none of them."""
    _reject(mesh=mesh, federation=federation, scenario=scenario,
            compression=compression, telemetry=telemetry)
    if not flat:
        raise NotImplementedError(
            "the vmap engine (flat=False) comes with ROADMAP A7; the port "
            "runs the flat engine (flat=True)")
    return _make_flat_round(loss_fn, client_opt, server_opt,
                            weighted=weighted)


def _make_flat_round(loss_fn, client_opt: ClientOpt, server_opt: ServerOpt,
                     *, weighted: bool):
    hyper = client_opt.hyper
    if (client_opt.name != "delta_sgd" or hyper is None
            or hyper.get("groupwise")):
        raise ValueError("flat engine requires the global-rule delta_sgd "
                         f"client optimizer, got {client_opt.name!r}")
    gamma, delta = hyper["gamma"], hyper["delta"]
    eta0, theta0 = hyper["eta0"], hyper["theta0"]
    # per-client (grads, (loss, aux)): params and batch carry the client
    # axis; the global params are shared
    vgrad = vmap(grad_and_value(loss_fn, has_aux=True),
                 in_dims=(0, 0, None))

    def flat_body(fstate, client_batches, layout, client_weights=None,
                  prev_local_params=None, gp=None, eta0_c=None):
        """One round on flat-form state (core.fed_loop.FlatFLState) ->
        (new_fstate, metrics, RoundAux). ``gp`` optionally passes the
        global params tree when the caller has it; otherwise the body
        takes views of the carried flat buffer."""
        from repro_torch.core.fed_loop import FlatFLState
        _reject(prev_local_params=prev_local_params, eta0_c=eta0_c)
        if gp is None:
            gp = flatlib.unpack(fstate.P, layout)
        device = fstate.P.device
        mask = flatlib.round_mask(layout, device)
        C, K = tree_leaves(client_batches)[0].shape[:2]
        # the client slab is owned by this round: the apply kernel
        # updates it in place, step after step
        P = fstate.P[None].expand(C, layout.padded_size).clone()
        S = flat_delta_sgd_init(C, layout, eta0=eta0, theta0=theta0,
                                device=device)
        losses = []
        for k in range(K):
            batch_k = tree_map(lambda x: x[:, k], client_batches)
            params_c = flatlib.unpack_batched(P, layout)
            g, (loss, _) = vgrad(params_c, batch_k, gp)
            G = flatlib.pack_batched(g, layout)
            P, S = flat_delta_sgd_step(P, G, S, gamma=gamma, delta=delta,
                                       eta0=eta0, mask=mask)
            losses.append(loss)
        losses = torch.stack(losses, dim=1)       # (C, K)

        if weighted and client_weights is not None:
            w = client_weights.to(torch.float32)
            agg_flat = torch.tensordot(w / w.sum(), P, dims=([0], [0]))
        else:
            agg_flat = P.mean(dim=0)
        # numerical-guard telemetry: how often η hit the ETA_CLAMP
        # ceiling, and the share of lanes the NaN guard dropped
        guard = dict(
            eta_clip_rate=S.clips.to(torch.float32).sum() / float(C * K),
            nan_guard_rate=(~S.valid).to(torch.float32).mean())
        state = FLState(gp, fstate.server_state, fstate.round)
        new_state, metrics = _finish_round(
            state, flatlib.unpack(agg_flat, layout), losses, S.eta,
            server_opt, extra=guard)
        new_fstate = FlatFLState(flatlib.pack(new_state.params, layout),
                                 *new_state[1:])
        return new_fstate, metrics, RoundAux(P, S.eta, S.valid)

    def round_fn(state: FLState, client_batches, client_weights=None,
                 prev_local_params=None):
        """-> (new_state, metrics, new_local_params (C, ...))."""
        from repro_torch.core.fed_loop import (flatten_fl_state,
                                               unflatten_fl_state)
        layout = flatlib.layout_of(state.params)
        fstate = flatten_fl_state(state, layout)
        new_fstate, metrics, aux = flat_body(
            fstate, client_batches, layout, client_weights=client_weights,
            prev_local_params=prev_local_params, gp=state.params)
        new_state = unflatten_fl_state(new_fstate, layout)
        return new_state, metrics, flatlib.unpack_batched(aux.P_locals,
                                                          layout)

    round_fn.flat_body = flat_body
    return round_fn

