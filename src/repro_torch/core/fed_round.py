"""One federated round (Algorithm 1), on the vmap engine or the flat
Δ-SGD engine. Port of ``repro/core/fed_round.py``.

The vmap engine (``flat=False``, the default, as in the reference) runs
any client optimizer (``repro_torch.core.client_opt``). Every client
starts from the round-start params; ``torch.func.vmap`` over the client
axis runs one local step (the loss's ``grad_and_value`` with the global
and, for MOON, the previous local params, then the per-leaf
``client_opt.update``), and a Python loop runs K of them. Under
heterogeneous K a client past its K_c keeps its params and optimizer
state, through ``torch.where``. Aggregation is the (weighted) mean of
the round-end local params over the client axis, then the ServerOpt
step. The global-rule Δ-SGD client with ``use_pallas`` takes the kernel
route: vmap runs only the gradient, and one ``fused_delta_sgd_update``
a step, on the stacked cohort, makes the step's two kernel launches
(``torch.func.vmap`` cannot trace the kernels' ctypes calls). Faults,
robust aggregation, quorum and active compression need the flat engine,
and the vmap engine refuses them as the reference does.

The flat engine (``flat=True``, Δ-SGD only): the round-start
params are packed into an ``(N,)`` f32 buffer (``repro_torch.core.flat``)
and broadcast to a ``(C, N)`` client slab. Each of the K local steps
evaluates per-client losses and gradients with ``torch.func.vmap`` of
``torch.func.grad_and_value`` over the ``(C, ...)`` views of the slab,
packs the gradients, and runs ``flat_delta_sgd_step``: exactly two
kernel launches for all leaves and all clients. Aggregation is one
(weighted) mean over the client axis, then the ServerOpt step.

Scenarios (``scenario=``, ``repro_torch.federation``) add, for the
synchronous round:
  * heterogeneous K: per-client step counts K_c ≤ K, folded into the
    Δ-SGD step as η=0 lanes (no extra launches);
  * fault lanes: mid-round drops (folded into the same lane budget), NaN
    gradients injected on the wire side of the in-step guard, byzantine
    delta scaling;
  * the guarded tail: the RobustAgg ladder (mean/clip/trimmed/median)
    over the survivors' deltas, re-anchored on the round-start params,
    and quorum degradation (fewer than Q valid clients: the round keeps
    the previous params and server state). The quorum test is one host
    read of the (C,) survivor count per round;
  * cohort reporting (``cohort_ids``) and effective-K metrics.
The draws are the scenario's (``Scenario.draw_*``), keyed on the round.

Async scenarios (``zipf_async``, ``byzantine_async``; flat engine only,
as in the reference) route the aggregate through the FedBuff buffer
(``repro_torch.federation.buffer``) in ``FLState.buffer``: one
staleness-weighted product over the packed (C, N) deltas gives the
cohort's delta sum, the buffer merges it, and the server steps only once
it holds M updates. The flush-or-hold choice is made on the device
(``buffer_step``), so the plain async tail reads nothing on the host.
The guarded async tail rejects over-stale updates, runs the RobustAgg
ladder with the staleness weights, scales byzantine deltas and merges
the robust mean times the survivors' weight sum; below quorum the round
freezes buffer, params and server state, through the same single host
read of the survivor count the synchronous guarded tail makes.

Compression (``compression=``, ``repro_torch.compression``) compresses
each client's round delta Δ_c = x_c^K − x_t before any aggregation:
int8 per chunk or top-k per chunk, optionally behind EF21 error feedback
(the (C, N) ``ef`` slab of the flat state), with per-client bandwidth
levels drawn by a bandwidth-heterogeneous scenario. Wire bytes and the
compression ratio ride in the round metrics.

Telemetry (``telemetry=``, ``repro_torch.telemetry``) adds the round's
distribution block to the metrics: the η histogram and the per-client
mean-loss deciles (two kernel launches per round, in the telemetry
namespace), and the absolute η-clamp and NaN-guard counts. It only reads
round-end values, so params and every other metric are bitwise equal
with it on and off.

With no scenario (or ``sync_iid``) and an inert compression spec the
round takes the exact slice-1 code path, bit for bit.

The round logic lives in ``flat_body``, which works on the flat state of
``repro_torch.core.fed_loop.FlatFLState``; ``round_fn`` is a pack/unpack
wrapper around it and exposes it as ``round_fn.flat_body``, which the
round-fused loop chains. Fused and host-loop rounds are therefore the
same computation.

Cohort means and fractions (``k_eff_mean``, ``nan_guard_rate``,
``drop_frac``, ...) are the sum times f32(1/C), as XLA takes the
reference's ``jnp.mean`` (``repro_torch.utils.numerics``).

``flat_body(..., eta0_c=)`` takes a (C,) per-client η₀ in place of the
scalar one: the fleet loop's warm start (``core.fed_loop
.make_fleet_loop``, ``eta_carry``).

Not ported yet, and rejected with the ROADMAP item that brings it: mesh
sharding (A17).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.utils._pytree as pytree
from torch.func import grad_and_value, vmap

from repro_torch.core import flat as flatlib
from repro_torch.core.client_opt import ClientOpt
from repro_torch.core.delta_sgd import (DeltaSGDState, flat_delta_sgd_init,
                                        flat_delta_sgd_step)
from repro_torch.core.server_opt import ServerOpt
from repro_torch.telemetry.spec import resolve_telemetry, round_telemetry
from repro_torch.utils.numerics import reciprocal, round_frac, xla_mean
from repro_torch.utils.tree import tree_leaves, tree_map


class FLState(NamedTuple):
    """The round's state. ``buffer`` is the async FedBuff buffer (an
    ``AsyncBufferState`` under async scenarios, else None). ``ef`` is
    the EF21 state under error-feedback compression: a tree like
    ``params`` with a leading cohort axis, f32."""
    params: Any
    server_state: Any
    round: int
    buffer: Any = None
    ef: Any = None


class RoundAux(NamedTuple):
    """Per-client round outputs next to the new state: ``P_locals``
    (C, N) round-end local params, ``etas`` (C,) round-end Δ-SGD step
    sizes, ``valid`` (C,) NaN-guard survivors."""
    P_locals: torch.Tensor
    etas: torch.Tensor
    valid: torch.Tensor


def init_fl_state(params, server_opt: ServerOpt, scenario=None,
                  compression=None, cohort: Optional[int] = None) -> FLState:
    """Async scenarios allocate the server-side delta buffer.
    ``compression`` with ``error_feedback=True`` allocates the
    per-cohort-slot EF21 reconstruction tree; ``cohort`` (C, clients per
    round) sizes its leading axis."""
    buf = None
    if scenario is not None and scenario.is_async:
        from repro_torch.federation.buffer import buffer_init
        buf = buffer_init(params)
    ef = None
    if compression is not None and compression.error_feedback:
        if cohort is None:
            raise ValueError("error-feedback compression needs cohort= "
                             "(clients per round) to size FLState.ef")
        ef = tree_map(lambda p: torch.zeros((cohort,) + tuple(p.shape),
                                            dtype=torch.float32,
                                            device=p.device), params)
    return FLState(params, server_opt.init(params), 0, buf, ef)


def _reject(**kw) -> None:
    """Raise for an argument whose feature is not ported yet."""
    items = {"mesh": "mesh sharding, ROADMAP A17",
             "federation": "mesh sharding, ROADMAP A17",
             "block_sharded": "the block-sharded loop, ROADMAP A17"}
    for name, value in kw.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{name}= is not ported yet: it comes with {items[name]}")


def _round_metrics(losses: torch.Tensor, etas: torch.Tensor,
                   step_counts: Optional[torch.Tensor] = None) -> dict:
    """``losses`` is (C, K), ``etas`` (C,). Under heterogeneous K the
    per-step losses of a finished client are masked out of the mean and
    "last step" is the client's K_c-th step."""
    if step_counts is None:
        loss = losses.mean()
        last = losses[:, -1].mean()
    else:
        from repro_torch.federation.heterogeneity import active_mask
        amask = active_mask(step_counts, losses.shape[1])
        loss = (losses * amask).sum() / amask.sum()
        last = losses.gather(1, (step_counts - 1).long()[:, None])[:, 0]
        last = last.mean()
    return {"loss": loss, "loss_last_step": last,
            "eta_mean": etas.mean(),
            "eta_min": etas.min(),
            "eta_max": etas.max()}


def _scenario_extras(scenario, round_idx: int, C: int, num_clients,
                     client_sizes, step_counts, device) -> dict:
    """Cohort and effective-K metrics of a scenario round."""
    extra = {}
    if scenario is None:
        return extra
    if num_clients is not None:
        ids = scenario.draw_cohort(round_idx, num_clients, C,
                                   sizes=client_sizes)
        extra["cohort_ids"] = _queued_copy(ids, device)
    if step_counts is not None:
        sc = step_counts.to(torch.float32)
        extra.update(k_eff_mean=xla_mean(sc), k_eff_min=sc.min(),
                     k_eff_max=sc.max())
    return extra


def make_fl_round(loss_fn, client_opt: ClientOpt, server_opt: ServerOpt, *,
                  num_rounds: int, weighted: bool = False, flat=False,
                  mesh=None, federation=None, scenario=None,
                  num_clients: Optional[int] = None, client_sizes=None,
                  compression=None, telemetry=None):
    """loss_fn(params, batch, global_params, prev_params) -> (loss, metrics).

    Returns round_fn(state, client_batches, client_weights=None,
    prev_local_params=None) -> (state, metrics, new_local_params). Every
    leaf of ``client_batches`` is (C, K, ...).

    ``flat``: False runs the vmap engine (any client optimizer); True
    (or the reference's "pallas"/"xla") the flat Δ-SGD engine. Kernels
    run on the device of the tensors.
    ``scenario`` (a ``repro_torch.federation.Scenario``) and
    ``compression`` (a ``CompressionSpec`` or a kind name) are described
    in the module docstring; ``num_clients``/``client_sizes`` let the
    round report the scenario's cohort ids. An inert compression spec
    (kind "none", no error feedback, no bandwidth-heterogeneous
    scenario) leaves the round on its exact uncompressed path.
    ``telemetry`` (None, a bool or a ``TelemetrySpec``) adds the round's
    telemetry block to the metrics, read-only over round-end values.
    ``num_rounds`` (T) sets round_frac = t/T of the (↓) client
    optimizers."""
    _reject(mesh=mesh, federation=federation)
    tele = resolve_telemetry(telemetry)
    if scenario is not None and scenario.is_async and not flat:
        raise ValueError(
            "async buffered aggregation requires the flat engine "
            "(flat=...): the staleness-weighted delta merge is one "
            "reduction over the packed (C, N) buffer")
    if scenario is not None and not flat and (
            scenario.faulty or scenario.robust or scenario.quorum > 0):
        raise ValueError(
            "fault injection / robust aggregation / quorum degradation "
            "require the flat engine (flat=...): faults are lowered as "
            "per-client lanes on the packed (C, N) buffer and the "
            "RobustAgg ladder runs on it (repro.federation.faults)")
    if compression is not None or (
            scenario is not None and scenario.bandwidth_heterogeneous):
        # a bandwidth-heterogeneous scenario implies compression even if
        # the caller passed none: the inert "none" spec (level 0 of the
        # ladder) makes the per-client level draws happen
        from repro_torch.compression import get_compression
        compression = get_compression(compression)
        if compression.active(scenario) and not flat:
            raise ValueError(
                "delta compression requires the flat engine (flat=...): "
                "the compressors operate on the packed (C, N) buffer")
    if not flat:
        return _make_vmap_round(loss_fn, client_opt, server_opt,
                                num_rounds=num_rounds, weighted=weighted,
                                scenario=scenario, num_clients=num_clients,
                                client_sizes=client_sizes, tele=tele)
    return _make_flat_round(loss_fn, client_opt, server_opt,
                            weighted=weighted, scenario=scenario,
                            num_clients=num_clients,
                            client_sizes=client_sizes,
                            compression=compression, tele=tele)


def _client_grads(loss_fn):
    """Per-client ``(grads, (loss, aux))`` of ``loss_fn``: params, batch
    and, for MOON, the previous local params carry the client axis; the
    global params are shared."""
    gv = grad_and_value(loss_fn, has_aux=True)
    by_prev = {False: vmap(gv, in_dims=(0, 0, None, None)),
               True: vmap(gv, in_dims=(0, 0, None, 0))}

    def grads(params_c, batch, gp, prev_c=None):
        return by_prev[prev_c is not None](params_c, batch, gp, prev_c)

    return grads


def _batch_dims(tree):
    """vmap in/out dims of a client-stacked tree: 0 per tensor leaf,
    None where the tree holds None (an optimizer without momentum)."""
    return pytree.tree_map(lambda x: None if x is None else 0, tree)


def _stack_clients(tree, C: int):
    """The same tree for each of C clients: every tensor leaf gains a
    leading client axis (a broadcast view)."""
    return pytree.tree_map(
        lambda x: None if x is None else x.expand((C,) + tuple(x.shape)),
        tree)


def _queued_copy(a, device) -> torch.Tensor:
    """A host array on ``device`` with no host sync: on a GPU the copy
    leaves pinned memory, queued on the current stream."""
    t = torch.tensor(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _freeze(active: torch.Tensor, new, old):
    """Heterogeneous K: keep ``old`` where the client is past its K_c."""
    def pick(a, o):
        if a is None:
            return None
        return torch.where(active.view((-1,) + (1,) * (a.dim() - 1)), a, o)
    return pytree.tree_map(pick, new, old)


def _make_vmap_round(loss_fn, client_opt: ClientOpt, server_opt: ServerOpt,
                     *, num_rounds: int, weighted: bool, scenario=None,
                     num_clients=None, client_sizes=None, tele=None):
    hyper = client_opt.hyper or {}
    # the kernel route: vmap runs the gradient only, and the stacked
    # cohort's Δ-SGD step is one fused_delta_sgd_update (2 launches)
    kernel_route = (client_opt.name == "delta_sgd"
                    and bool(hyper.get("use_pallas"))
                    and not hyper.get("groupwise"))
    hetero = scenario is not None and scenario.heterogeneous
    vgrad = _client_grads(loss_fn)
    grad_fn = grad_and_value(loss_fn, has_aux=True)
    edges = {}

    def local_step(p, os, batch, gp, prev_c):
        g, (loss, _) = grad_fn(p, batch, gp, prev_c)
        p_new, os_new = client_opt.update(p, g, os, loss)
        return p_new, os_new, loss

    def round_fn(state: FLState, client_batches, client_weights=None,
                 prev_local_params=None):
        """-> (new_state, metrics, new_local_params (C, ...))."""
        gp = state.params
        device = tree_leaves(gp)[0].device
        C, K = tree_leaves(client_batches)[0].shape[:2]
        step_counts = (_queued_copy(scenario.draw_step_counts(
            state.round, C, K), device) if hetero else None)
        # round_frac stays a host scalar: only the (↓) optimizers read
        # it, at reset, on the host
        os = _stack_clients(client_opt.reset(
            client_opt.init(gp), round_frac(state.round, num_rounds)), C)
        p = _stack_clients(gp, C)
        prev_dim = None if prev_local_params is None else 0
        vstep = vmap(local_step, in_dims=(0, _batch_dims(os), 0, None,
                                          prev_dim),
                     out_dims=(0, _batch_dims(os), 0))
        losses = []
        for k in range(K):
            batch_k = tree_map(lambda x: x[:, k], client_batches)
            if kernel_route:
                g, (loss, _) = vgrad(p, batch_k, gp, prev_local_params)
                p_new, os_new = client_opt.update(p, g, os, loss)
            else:
                p_new, os_new, loss = vstep(p, os, batch_k, gp,
                                            prev_local_params)
            if hetero:
                # past its K_c a client's params and optimizer state
                # (Adam's t, momenta, Δ-SGD's k) stay frozen
                active = k < step_counts
                p_new = _freeze(active, p_new, p)
                os_new = _freeze(active, os_new, os)
            p, os = p_new, os_new
            losses.append(loss)
        losses = torch.stack(losses, dim=1)       # (C, K)
        etas = (os.eta if isinstance(os, DeltaSGDState)
                and not isinstance(os.eta, dict)
                else torch.full((C,), float("nan"), device=device))

        if weighted and client_weights is not None:
            w = client_weights / client_weights.sum()
            agg = tree_map(lambda x: torch.tensordot(
                w.to(torch.float32), x.to(torch.float32),
                dims=([0], [0])).to(x.dtype), p)
        else:
            agg = tree_map(lambda x: xla_mean(x.to(torch.float32), dim=0
                                              ).to(x.dtype), p)

        extra = _scenario_extras(scenario, state.round, C, num_clients,
                                 client_sizes, step_counts, device)
        if tele is not None and tele.enabled:
            # η is NaN for non-Δ-SGD and groupwise optimizers: NaN counts
            # in no histogram bin, so eta_hist reads all zeros there
            if device not in edges:
                edges[device] = tele.edges_on(device)
            extra.update(round_telemetry(tele, etas, losses,
                                         edges=edges[device]))
        params, sstate = server_opt.update(gp, agg, state.server_state)
        metrics = _round_metrics(losses, etas, step_counts)
        metrics.update(extra)
        return (FLState(params, sstate, state.round + 1, state.buffer,
                        state.ef), metrics, p)

    return round_fn


def _make_flat_round(loss_fn, client_opt: ClientOpt, server_opt: ServerOpt,
                     *, weighted: bool, scenario=None, num_clients=None,
                     client_sizes=None, compression=None, tele=None):
    from repro_torch.compression import compress_flat
    from repro_torch.federation.buffer import (buffer_merge, buffer_step,
                                               staleness_weights)
    from repro_torch.federation.faults import FaultLanes, robust_aggregate
    hyper = client_opt.hyper
    if (client_opt.name != "delta_sgd" or hyper is None
            or hyper.get("groupwise")):
        raise ValueError("flat engine requires the global-rule delta_sgd "
                         f"client optimizer, got {client_opt.name!r}")
    gamma, delta_ = hyper["gamma"], hyper["delta"]
    eta0, theta0 = hyper["eta0"], hyper["theta0"]
    vgrad = _client_grads(loss_fn)

    # build-time flags: with all of them off every branch below is the
    # slice-1 code path
    hetero = scenario is not None and scenario.heterogeneous
    is_async = scenario is not None and scenario.is_async
    bw_hetero = scenario is not None and scenario.bandwidth_heterogeneous
    comp = compression if (compression is not None
                           and compression.active(scenario)) else None
    use_ef = comp is not None and comp.error_feedback
    fm = scenario.fault_model if scenario is not None else None
    faults_on = fm is not None and fm.active
    ragg = scenario.robust_model if scenario is not None else None
    robust_on = ragg is not None and ragg.robust
    quorum = scenario.quorum if scenario is not None else 0
    guard_tail = faults_on or robust_on or quorum > 0
    drops_on = faults_on and fm.drop_rate > 0.0
    nan_on = faults_on and fm.nan_rate > 0.0
    byz_on = faults_on and fm.byzantine_rate > 0.0
    overstale_on = faults_on and fm.overstale_rate > 0.0
    # the telemetry bin edges, built once per device (not once per round)
    edges = {}

    def flat_body(fstate, client_batches, layout, client_weights=None,
                  prev_local_params=None, gp=None, eta0_c=None):
        """One round on flat-form state (core.fed_loop.FlatFLState) ->
        (new_fstate, metrics, RoundAux). ``gp`` optionally passes the
        global params tree when the caller has it; otherwise the body
        takes views of the carried flat buffer. ``eta0_c`` optionally
        replaces the scalar round-start η₀ with a (C,) per-client
        tensor (the fleet loop's ``eta_carry`` warm start)."""
        from repro_torch.core.fed_loop import FlatFLState
        if gp is None:
            gp = flatlib.unpack(fstate.P, layout)
        device = fstate.P.device
        mask = flatlib.round_mask(layout, device)
        C, K = tree_leaves(client_batches)[0].shape[:2]

        def on_device(a):
            # the round's host draws, queued with no host sync
            return _queued_copy(a, device)

        step_counts = (on_device(scenario.draw_step_counts(
            fstate.round, C, K)) if hetero else None)
        # fault lanes: drops fold into the SAME per-step lane budget as
        # heterogeneous K (a dropped client runs out of budget at its
        # drop step), so the step stays at two kernel launches
        lanes = (FaultLanes(*map(on_device, scenario.draw_faults(
            fstate.round, C, K))) if faults_on else None)
        if drops_on:
            budget = (torch.minimum(step_counts, lanes.drop_step) if hetero
                      else lanes.drop_step)
            # loss metrics mask on the effective budget; clamp >= 1 so a
            # step-0 drop (K=1) still indexes a defined "last step"
            mcounts = torch.clamp(budget, min=1)
        else:
            budget = mcounts = step_counts

        # the client slab is owned by this round: the apply kernel
        # updates it in place, step after step
        P = fstate.P[None].expand(C, layout.padded_size).clone()
        P_start = (fstate.P[None].expand(C, layout.padded_size)
                   if (is_async or comp is not None or guard_tail)
                   else None)
        S = flat_delta_sgd_init(C, layout, eta0=eta0, theta0=theta0,
                                device=device)
        losses = []
        for k in range(K):
            batch_k = tree_map(lambda x: x[:, k], client_batches)
            params_c = flatlib.unpack_batched(P, layout)
            g, (loss, _) = vgrad(params_c, batch_k, gp, prev_local_params)
            G = flatlib.pack_batched(g, layout)
            # the gradient tree (a (C, N) slab in all) and, after the
            # step, its packed copy are freed here, not when the next
            # step reassigns them: an LM's slab is gigabytes
            del g
            if nan_on:
                # NaN gradients from the drawn step on, injected on the
                # wire side of the guard: the in-step guard must catch
                # them (valid latches off, η=0, lane sanitised)
                G = torch.where((k >= lanes.nan_step)[:, None],
                                float("nan"), G)
            active = (k < budget) if budget is not None else None
            P, S = flat_delta_sgd_step(
                P, G, S, gamma=gamma, delta=delta_,
                eta0=eta0 if eta0_c is None else eta0_c, mask=mask,
                active=active)
            del G
            losses.append(loss)
        losses = torch.stack(losses, dim=1)       # (C, K)

        extra = _scenario_extras(scenario, fstate.round, C, num_clients,
                                 client_sizes, step_counts, device)
        # numerical-guard telemetry: how often η hit the ETA_CLAMP
        # ceiling, and the share of lanes the NaN guard dropped
        extra.update(
            eta_clip_rate=(S.clips.to(torch.float32).sum()
                           * reciprocal(C * K)),
            nan_guard_rate=xla_mean((~S.valid).to(torch.float32)))
        if tele is not None and tele.enabled:
            # the distribution block: read-only over round-end values,
            # so the trajectory is unperturbed
            if device not in edges:
                edges[device] = tele.edges_on(device)
            extra.update(round_telemetry(tele, S.eta, losses, S.clips,
                                         S.valid, edges=edges[device]))

        # survivor mask + byzantine factor of the guarded tail: a client
        # is excluded when its NaN guard latched or it dropped mid-round
        byz = valid = None
        if guard_tail:
            valid = S.valid
            if drops_on:
                valid = valid & (lanes.drop_step >= K)
            if byz_on:
                byz = torch.where(lanes.byzantine, fm.byzantine_scale, 1.0)

        # delta compression: each client's round delta is compressed
        # before any aggregation; EF21 ships C(Δ_c − g_c) and rolls
        # g_c ← g_c + C(Δ_c − g_c), so Δ̂_c is the new g_c
        new_ef = E = None
        if comp is not None:
            levels = (on_device(scenario.draw_compression_levels(
                fstate.round, C)) if bw_hetero else None)
            delta = P - P_start
            if byz is not None:
                # byzantine corruption happens client-side, before the
                # (honest) compression transport
                delta = delta * byz[:, None]
            if use_ef:
                if fstate.ef is None:
                    raise ValueError(
                        "error-feedback compression needs FLState.ef: "
                        "allocate it with init_fl_state(..., compression="
                        "spec, cohort=C)")
                E = fstate.ef
                chat = compress_flat(delta - E, comp, levels=levels)
                delta_hat = new_ef = E + chat
            else:
                delta_hat = compress_flat(delta, comp, levels=levels)
            # wire accounting over the VALID elements (layout.size)
            wire = comp.wire_bytes(layout.size, levels=levels,
                                   num_clients=C, device=device)
            total = wire.sum()
            extra.update(wire_bytes=total,
                         comp_ratio=total.new_full(
                             (), 4.0 * layout.size * C) / total)
            if levels is not None:
                extra["comp_level_mean"] = xla_mean(
                    levels.to(torch.float32))
            P_agg = P_start + delta_hat
        else:
            delta_hat = None
            P_agg = P

        buf = fstate.buffer
        skipped = False
        if not is_async and not guard_tail:
            # aggregate: single (weighted) mean over the packed client
            # axis
            if weighted and client_weights is not None:
                w = client_weights.to(torch.float32)
                agg_flat = torch.tensordot(w / w.sum(), P_agg,
                                           dims=([0], [0]))
            else:
                agg_flat = P_agg.mean(dim=0)
            new_params, sstate = server_opt.update(
                gp, flatlib.unpack(agg_flat, layout), fstate.server_state)
            newP = flatlib.pack(new_params, layout)
            metrics = _round_metrics(losses, S.eta, step_counts)
        elif not is_async:
            # guarded tail: the RobustAgg ladder aggregates the survivors'
            # deltas and the result re-anchors on the round-start params
            delta_eff = delta_hat if comp is not None else (P - P_start)
            if byz is not None and comp is None:
                delta_eff = delta_eff * byz[:, None]
            w_raw = (client_weights.to(torch.float32)
                     if weighted and client_weights is not None else None)
            agg_delta, rinfo = robust_aggregate(delta_eff, ragg, valid,
                                                weights=w_raw)
            n_valid = valid.to(torch.float32).sum()
            # quorum degradation: with < Q valid clients the round keeps
            # the previous params, server state and EF21 state
            skipped = quorum > 0 and float(n_valid) < quorum
            if skipped:
                newP, sstate = fstate.P, fstate.server_state
                if new_ef is not None:
                    new_ef = E
            else:
                agg = flatlib.unpack(fstate.P + agg_delta, layout)
                new_params, sstate = server_opt.update(
                    gp, agg, fstate.server_state)
                newP = flatlib.pack(new_params, layout)
            metrics = _round_metrics(losses, S.eta, mcounts)
        else:
            # FedBuff: the cohort's staleness-weighted delta sum goes into
            # the buffer, and the server steps once it holds M updates
            stale = on_device(scenario.draw_staleness(fstate.round, C))
            if overstale_on:
                stale = torch.where(lanes.overstale, fm.overstale,
                                    stale).to(torch.int32)
            w = staleness_weights(stale, scenario.staleness_exp)
            if weighted and client_weights is not None:
                w = w * client_weights.to(torch.float32)
            d = delta_hat if comp is not None else (P - P_start)
            if not guard_tail:
                # one weighted product over the packed client axis
                delta_flat = torch.tensordot(w, d, dims=([0], [0]))
                wsum, n_updates = w.sum(), C
                metrics = _round_metrics(losses, S.eta, step_counts)
            else:
                # guarded async tail: over-stale updates are rejected, the
                # ladder aggregates the survivors' weighted deltas, and
                # the buffer takes the robust mean scaled back to Σ wΔ
                # form, so the flush's Σ wΔ / Σ w recovers it
                valid = valid & (stale <= scenario.staleness_max)
                if byz is not None and comp is None:
                    d = d * byz[:, None]
                rob, rinfo = robust_aggregate(d, ragg, valid, weights=w)
                vf = valid.to(torch.float32)
                wsum, n_valid = (w * vf).sum(), vf.sum()
                delta_flat = rob * wsum
                n_updates = n_valid.to(torch.int32)
                # below quorum the round freezes buffer, params, server
                # state and EF21 state (the tail's one host read)
                skipped = quorum > 0 and float(n_valid) < quorum
                metrics = _round_metrics(losses, S.eta, mcounts)
            if skipped:
                newP, sstate = fstate.P, fstate.server_state
                flushed = wsum.new_zeros(())
                if new_ef is not None:
                    new_ef = E
            else:
                buf = buffer_merge(
                    buf, flatlib.unpack(delta_flat, layout, cast=False),
                    wsum, n_updates, stale)
                new_params, sstate, buf, flushed = buffer_step(
                    gp, fstate.server_state, buf, server_opt,
                    scenario.buffer_size)
                newP = flatlib.pack(new_params, layout)
            sf = stale.to(torch.float32)
            extra.update(stale_mean=xla_mean(sf), stale_max=sf.max(),
                         buffer_fill=buf.count.to(torch.float32),
                         flushed=flushed)
        if guard_tail:
            extra.update(rinfo)
            extra.update(valid_count=n_valid,
                         round_skipped=n_valid.new_full(
                             (), float(skipped)))
            if drops_on:
                extra["drop_frac"] = xla_mean(
                    (lanes.drop_step < K).to(torch.float32))
            if byz is not None:
                extra["byz_frac"] = xla_mean(
                    lanes.byzantine.to(torch.float32))
            if is_async and overstale_on:
                extra["overstale_frac"] = xla_mean(
                    lanes.overstale.to(torch.float32))
        metrics.update(extra)
        new_fstate = FlatFLState(newP, sstate, fstate.round + 1, buf,
                                 fstate.ef if new_ef is None else new_ef)
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
