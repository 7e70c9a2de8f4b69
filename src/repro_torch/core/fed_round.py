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

Mesh sharding (``mesh=``, ``federation=``, flat engine only): every rank
of a ``torch.distributed`` mesh runs the same ``flat_body`` on its
(C_loc, N_loc) block of the client buffers: C over the client axes, N
over the N-shard axes (``FederationSpec.flat_spec``), the layout built
with ``shards=FederationSpec.flat_shards(mesh)``; the global (C, N) slab
never exists on one rank. Each ``psum``/``pmin`` of the reference's
``shard_map`` is an ``all_reduce`` (``repro_torch.sharding.dist``):
  * the local steps run on the rank's TP slab (``core.sharded``), cut
    from the round-start params: each element of N on exactly one rank
    of the N-shard group, a leaf the placement cuts as the rank's
    placement block, the rest split over the axes that leave it whole.
    A local step runs the model on the rank's placement blocks under
    the training rules the caller installed (``launch.steps
    .train_rules``: tensor-parallel layers, vocab-parallel CE, the fsdp
    gather at use), the split leaves gathered at use (``flat_gather``)
    a chunk of clients at a time; each gradient is summed over its
    ``grad_sync`` axes and the rank keeps its pieces; then
    ``flat_delta_sgd_step_sharded`` (the kernel pair on the TP slab,
    one (2, C_loc) ``norms`` sum over the N-shard axes, each element
    counted once). Without rules the model is gathered whole at use;
  * one ``all_to_all`` over the N-shard axes (``flat_reshard``) moves
    the round-end local params to the reference's contiguous (C_loc,
    N_loc) columns before the tail, so compression's chunks, EF21's
    slab, the robust ladder and the FedBuff buffer see the reference's
    layout;
  * the scenario's host draws stay whole (C,) vectors on every rank,
    which slices its own lanes (the reference's replicated pins);
  * every client-axis sum of the round's tail rides ONE packed
    all_reduce of (N_loc + k,) f32: the aggregate's N_loc columns, then
    the metric sums (and telemetry's η-histogram counts); both η extrema
    share ONE (2,) min; the (N_loc,) aggregate is then gathered to (N,)
    over the N-shard axes for the server step. The robust ladder
    (``robust_aggregate_sharded``) reduces its own aggregate, and the
    quorum test reads the all-reduced survivor count, so every rank
    takes the same branch; ``loss_deciles`` gathers the (C_loc,)
    per-client mean losses over the client axes.
Under a mesh ``client_batches`` are the rank's clients' (C_loc, K, ...)
batches, ``client_weights`` the whole (C,) vector, ``FLState.ef`` the
rank's (C_loc, N_loc) EF21 slab (``init_fl_state(..., mesh=,
federation=)``), and the third value ``round_fn`` returns is the rank's
(C_loc, N_loc) slab of round-end local params (``core.flat.gather_slab``
puts the ranks' slabs together). ``repro_torch.core.sharded`` counts the
collectives a round makes. Off a mesh the flat engine evaluates each
client's model whole: it runs its loss with no logical rules applied.

Tensor-parallel vmap round: where a caller installs training rules
(``LogicalRules(serve=False)`` with the params' placement, through
``models.common.logical_rules``, as the reference runs its round under
``with mesh, logical_rules(rules)``) the vmap engine runs on a rank's
blocks (``launch.steps.place_train_for_rank``): ``state.params`` is the
rank's block of every leaf, ``client_batches`` its C_loc clients' (C_loc,
K, b_loc, ...) rows (C over the client axes, b over the fsdp axes),
``client_weights`` the whole (C,) vector. The model's forward and
backward run Megatron-style inside ``vmap(grad_and_value)`` (its
collectives are ``sharding.dist``'s differentiable operators); each
gradient is then summed over the fsdp axes that do not shard its leaf
(``sharding.spec.grad_sync_axes``, one ``grad_sync`` a group of leaves),
and Δ-SGD's two global norms count each element once
(``core.delta_sgd.sharded_sq_sums``, one ``norms`` sum a step). The
FedAvg mean is a local f32 sum over the rank's clients, ONE ``fedavg``
sum over the client axes of every leaf packed, times f32(1/C); the
weighted mean takes the rank's slice of the weights. The (C_loc, K)
losses and (C_loc,) η are gathered in one ``metrics`` op for the
round's metrics and telemetry. Heterogeneous K takes the rank's slice
of the (C,) step counts. The third value is the rank's (C_loc, ...)
blocks of the round-end local params.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import is_fake
from torch.func import grad_and_value, vmap

from repro_torch.core import flat as flatlib
from repro_torch.core.client_opt import ClientOpt
from repro_torch.core.delta_sgd import (DeltaSGDState, flat_delta_sgd_init,
                                        flat_delta_sgd_step,
                                        flat_delta_sgd_step_sharded)
from repro_torch.core.server_opt import ServerOpt
from repro_torch.sharding.spec import axes_size
from repro_torch.telemetry.spec import resolve_telemetry, round_telemetry
from repro_torch.utils.numerics import reciprocal, round_frac, xla_mean
from repro_torch.utils.tree import (tree_flatten, tree_leaves, tree_map,
                                    tree_unflatten)


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
                  compression=None, cohort: Optional[int] = None, *,
                  mesh=None, federation=None) -> FLState:
    """Async scenarios allocate the server-side delta buffer.
    ``compression`` with ``error_feedback=True`` allocates the
    per-cohort-slot EF21 reconstruction tree; ``cohort`` (C, clients per
    round) sizes its leading axis. With ``mesh`` and ``federation`` the
    EF21 state is this rank's (C_loc, N_loc) f32 slab of the packed
    buffer (the layout built with ``shards=flat_shards(mesh)``)."""
    buf = None
    if scenario is not None and scenario.is_async:
        from repro_torch.federation.buffer import buffer_init
        buf = buffer_init(params)
    ef = None
    if compression is not None and compression.error_feedback:
        if cohort is None:
            raise ValueError("error-feedback compression needs cohort= "
                             "(clients per round) to size FLState.ef")
        if mesh is not None:
            layout = flatlib.layout_of(
                params, shards=federation.flat_shards(mesh))
            shape = federation.local_shape(mesh, cohort, layout.padded_size)
            ef = torch.zeros(shape, dtype=torch.float32,
                             device=tree_leaves(params)[0].device)
        else:
            ef = tree_map(lambda p: torch.zeros(
                (cohort,) + tuple(p.shape), dtype=torch.float32,
                device=p.device), params)
    return FLState(params, server_opt.init(params), 0, buf, ef)


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
    optimizers. ``mesh`` (a DeviceMesh from
    ``repro_torch.sharding.dist.make_mesh``) and ``federation`` (a
    ``FederationSpec``), both or neither, run the flat engine on this
    rank's block of the mesh (module docstring)."""
    tele = resolve_telemetry(telemetry)
    if (mesh is None) != (federation is None):
        raise ValueError("mesh and federation must be given together")
    if mesh is not None and not flat:
        raise ValueError("mesh/federation sharding requires the flat "
                         "engine (flat=...)")
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
                            compression=compression, tele=tele, mesh=mesh,
                            federation=federation)


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


def _tp_round_setup(client_opt: ClientOpt):
    """The installed training rules when the vmap round runs
    tensor-parallel (``LogicalRules(serve=False)`` with placements),
    else None; refuses what that round does not run."""
    from repro_torch.core.delta_sgd import training_rules
    rules = training_rules()
    if rules is None:
        return None
    hyper = client_opt.hyper or {}
    if client_opt.name == "sps" or hyper.get("groupwise"):
        raise ValueError(
            f"{client_opt.name}{' (groupwise)' if hyper.get('groupwise') else ''}"
            " under tensor-parallel rules: its per-group or loss-scaled "
            "norms are not ported to sharded params; the global-rule "
            "Δ-SGD and the elementwise optimizers run")
    return rules


def _grad_sync(grads, sync: list):
    """Sum each leaf's gradient over its ``grad_sync_axes`` (a list
    aligned with the leaves): one ``grad_sync`` reduce a group of leaves
    that share their axes."""
    from repro_torch.models.common import get_logical_rules
    from repro_torch.sharding import dist
    leaves, treedef = tree_flatten(grads)
    out = list(leaves)
    for axes in sorted({a for a in sync if a}):
        idx = [i for i, a in enumerate(sync) if a == axes]
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        flat = dist.reduce_from(flat, get_logical_rules().mesh, axes,
                                role="grad_sync")
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].view(leaves[i].shape)
            off += n
    return tree_unflatten(treedef, out)


def _sum_over_clients(p, w_loc, C: int, mesh, ca):
    """The cohort mean (``w_loc`` None) or the weighted sum with this
    rank's (C_loc,) slice of the normalised weights, of the rank's
    (C_loc, ...) blocks: a local f32 sum, then ONE ``fedavg`` sum over
    the client axes of every leaf packed, then × f32(1/C) for the mean.
    Returns f32 leaves."""
    from repro_torch.sharding import dist
    leaves, treedef = tree_flatten(p)
    if w_loc is None:
        parts = [x.to(torch.float32).sum(dim=0) for x in leaves]
    else:
        parts = [torch.tensordot(w_loc.to(torch.float32),
                                 x.to(torch.float32), dims=([0], [0]))
                 for x in leaves]
    flat = torch.cat([x.reshape(-1) for x in parts])
    flat = dist.all_reduce(flat, mesh, ca, role="fedavg")
    if w_loc is None:
        flat = flat * reciprocal(C)
    out, off = [], 0
    for x in parts:
        out.append(flat[off:off + x.numel()].view(x.shape))
        off += x.numel()
    return tree_unflatten(treedef, out)


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
    sync = []    # the leaves' grad_sync_axes under training rules

    def local_step(p, os, batch, gp, prev_c):
        g, (loss, _) = grad_fn(p, batch, gp, prev_c)
        if any(sync):
            g = _grad_sync(g, sync)
        p_new, os_new = client_opt.update(p, g, os, loss)
        return p_new, os_new, loss

    def round_fn(state: FLState, client_batches, client_weights=None,
                 prev_local_params=None):
        """-> (new_state, metrics, new_local_params (C, ...)). Under
        training rules, the rank's (C_loc, ...) blocks (the docstring of
        ``make_fl_round``)."""
        gp = state.params
        device = tree_leaves(gp)[0].device
        C_loc, K = tree_leaves(client_batches)[0].shape[:2]
        rules = _tp_round_setup(client_opt)
        C, c0, ca, mesh = C_loc, 0, (), None
        sync.clear()
        if rules is not None:
            from repro_torch.sharding.spec import (block_index,
                                                   client_axes_on,
                                                   grad_sync_axes)
            mesh = rules.mesh
            ca = client_axes_on(rules.spec, mesh)
            C = C_loc * axes_size(mesh, ca)
            c0 = block_index(mesh, ca, rules.coords) * C_loc
            sync.extend(tree_leaves(grad_sync_axes(rules.spec, mesh,
                                                   rules.param_axes)))
        step_counts = (_queued_copy(scenario.draw_step_counts(
            state.round, C, K), device) if hetero else None)
        counts_loc = (step_counts[c0:c0 + C_loc] if hetero else None)
        # round_frac stays a host scalar: only the (↓) optimizers read
        # it, at reset, on the host
        os = _stack_clients(client_opt.reset(
            client_opt.init(gp), round_frac(state.round, num_rounds)), C_loc)
        p = _stack_clients(gp, C_loc)
        prev_dim = None if prev_local_params is None else 0
        vstep = vmap(local_step, in_dims=(0, _batch_dims(os), 0, None,
                                          prev_dim),
                     out_dims=(0, _batch_dims(os), 0))
        losses = []
        for k in range(K):
            batch_k = tree_map(lambda x: x[:, k], client_batches)
            if kernel_route:
                g, (loss, _) = vgrad(p, batch_k, gp, prev_local_params)
                if any(sync):
                    g = _grad_sync(g, sync)
                p_new, os_new = client_opt.update(p, g, os, loss)
            else:
                p_new, os_new, loss = vstep(p, os, batch_k, gp,
                                            prev_local_params)
            if hetero:
                # past its K_c a client's params and optimizer state
                # (Adam's t, momenta, Δ-SGD's k) stay frozen
                active = k < counts_loc
                p_new = _freeze(active, p_new, p)
                os_new = _freeze(active, os_new, os)
            p, os = p_new, os_new
            losses.append(loss)
        losses = torch.stack(losses, dim=1)       # (C, K)
        etas = (os.eta if isinstance(os, DeltaSGDState)
                and not isinstance(os.eta, dict)
                else torch.full((C_loc,), float("nan"), device=device))

        w = None
        if weighted and client_weights is not None:
            w = client_weights / client_weights.sum()
        if rules is None:
            if w is not None:
                agg = tree_map(lambda x: torch.tensordot(
                    w.to(torch.float32), x.to(torch.float32),
                    dims=([0], [0])).to(x.dtype), p)
            else:
                agg = tree_map(lambda x: xla_mean(x.to(torch.float32), dim=0
                                                  ).to(x.dtype), p)
        else:
            from repro_torch.sharding import dist
            agg = tree_map(lambda a, x: a.to(x.dtype), _sum_over_clients(
                p, None if w is None else w[c0:c0 + C_loc], C, mesh, ca),
                gp)
            # the (C, K) losses and (C,) η of every client, in one
            # gather over the client axes
            both = dist.all_gather(torch.cat([losses, etas[:, None]], 1),
                                   mesh, ca, 0, role="metrics")
            losses, etas = both[:, :K], both[:, K]

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
                     client_sizes=None, compression=None, tele=None,
                     mesh=None, federation=None):
    from repro_torch.compression import compress_flat
    from repro_torch.models.common import logical_rules
    rank_loss = loss_fn

    def whole_loss(*args):
        # off a mesh the flat engine evaluates each client's model
        # whole: no logical rules apply to it, whatever a caller
        # installed
        with logical_rules(None):
            return rank_loss(*args)

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
    # under a mesh the local steps run the model on the rank's blocks,
    # under the rules the caller installed (none: the whole model)
    vgrad = _client_grads(rank_loss if mesh is not None else whole_loss)

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
    tele_on = tele is not None and tele.enabled
    # the telemetry bin edges, built once per device (not once per round)
    edges = {}

    # the mesh: this rank's block of the (C, N) buffers is row block
    # c_blk over the client axes ``ca`` and column block n_blk over the
    # N-shard axes ``na``; off-mesh the block is the whole buffer
    sharded = mesh is not None
    shards, n_cshards, c_blk, n_blk = 1, 1, 0, 0
    slabs = {}
    if sharded:
        from repro_torch.compression import compress_flat_sharded
        from repro_torch.core.delta_sgd import training_rules
        from repro_torch.core.sharded import tp_slab
        from repro_torch.federation.faults import robust_aggregate_sharded
        from repro_torch.federation.heterogeneity import active_mask
        from repro_torch.kernels.telemetry import telemetry as tk
        from repro_torch.sharding import dist
        from repro_torch.sharding.spec import axes_size, block_index
        pspec = ca, na = federation.flat_spec(mesh)
        shards = federation.flat_shards(mesh)
        n_cshards = axes_size(mesh, ca)
        here = dist.coords(mesh)
        c_blk, n_blk = block_index(mesh, ca, here), block_index(mesh, na,
                                                                 here)

    def step(P, G, S, mask, active, eta0_c):
        if sharded:
            # G is the round's own slab (local_grads'): its invalid
            # lanes are zeroed in place
            return flat_delta_sgd_step_sharded(
                P, G, S, gamma=gamma, delta=delta_, eta0=eta0, mesh=mesh,
                pspec=pspec, mask=mask, active=active, g_inplace=True)
        return flat_delta_sgd_step(
            P, G, S, gamma=gamma, delta=delta_,
            eta0=eta0 if eta0_c is None else eta0_c, mask=mask,
            active=active)

    def compress(x, levels):
        if sharded:
            return compress_flat_sharded(x, comp, mesh=mesh, pspec=pspec,
                                         levels=levels)
        return compress_flat(x, comp, levels=levels)

    def robust(d, valid, weights):
        if sharded:
            return robust_aggregate_sharded(d, ragg, valid, mesh=mesh,
                                            pspec=pspec, weights=weights)
        return robust_aggregate(d, ragg, valid, weights=weights)

    def whole(x):
        """The rank's (N_loc,) columns -> (N,) over the N-shard axes."""
        if shards == 1:
            return x
        return dist.all_gather(x.contiguous(), mesh, na, dim=0,
                               role="flat_params")

    def rank_slab(layout):
        """(TPSlab, the leaves' grad_sync axes) of this rank under the
        installed training rules, made once for a layout and rules."""
        from repro_torch.core.sharded import placement_key
        rules = training_rules()
        key = (layout, None if rules is None else
               (placement_key(rules.param_axes), tuple(sorted(
                   rules.coords.items()))))
        hit = slabs.get(key)
        if hit is None:
            sync = []
            if rules is not None:
                from repro_torch.sharding.spec import grad_sync_axes
                sync = tree_leaves(grad_sync_axes(rules.spec, mesh,
                                                  rules.param_axes))
            hit = slabs[key] = (tp_slab(layout, mesh, federation, rules),
                                sync)
        return hit

    def local_grads(P, layout, batch_k, gp, prev, slab=None, sync=()):
        """Packed gradients and losses of the block's clients. Off a
        mesh: the whole model of every client, vmapped. Under a mesh
        ``P`` is the rank's (C_loc, width) TP slab (``core.sharded``):
        a chunk of ``slab.chunk(C_loc)`` clients at a time, the model
        runs on the rank's placement blocks (the split leaves' pieces
        gathered at use), each gradient is summed over its
        ``grad_sync`` axes and the rank keeps its pieces. MOON's ``prev``
        (whole leaves, the block's clients) is cut to each chunk."""
        if not sharded:
            g, (loss, _) = vgrad(flatlib.unpack_batched(P, layout), batch_k,
                                 gp, prev)
            # the gradient tree (a (C, N) slab in all) is freed on
            # return, not when the next step reassigns it: an LM's slab
            # is gigabytes
            return flatlib.pack_batched(g, layout), loss
        C_loc = P.shape[0]
        ch = slab.chunk(C_loc)
        G = torch.zeros_like(P)
        losses = []
        for a in range(0, C_loc, ch):
            b = min(a + ch, C_loc)
            params = slab.blocks(P[a:b])
            g, (loss, _) = vgrad(
                params, tree_map(lambda x: x[a:b], batch_k), gp,
                None if prev is None else tree_map(lambda x: x[a:b], prev))
            del params
            if any(sync):
                g = _grad_sync(g, sync)
            slab.pack(tree_leaves(g), G[a:b])
            del g
            losses.append(loss)
        return G, (losses[0] if len(losses) == 1 else torch.cat(losses))

    def flat_body(fstate, client_batches, layout, client_weights=None,
                  prev_local_params=None, gp=None, eta0_c=None):
        """One round on flat-form state (core.fed_loop.FlatFLState) ->
        (new_fstate, metrics, RoundAux). ``gp`` optionally passes the
        global params tree when the caller has it; otherwise the body
        takes views of the carried flat buffer. ``eta0_c`` optionally
        replaces the scalar round-start η₀ with a (C,) per-client
        tensor (the fleet loop's ``eta_carry`` warm start). Under a mesh
        the body runs on this rank's block (module docstring)."""
        from repro_torch.core.fed_loop import FlatFLState
        if sharded:
            if eta0_c is not None:
                raise ValueError("per-client eta0 warm start (eta0_c) is "
                                 "not supported on the per-round sharded "
                                 "engine — the fleet loop runs un-meshed")
            if layout.shards != shards:
                raise ValueError(f"layout has shards={layout.shards}, the "
                                 f"mesh needs shards={shards}")
            if (prev_local_params is not None
                    and training_rules() is not None):
                raise ValueError("previous local params (MOON) on the "
                                 "sharded flat round under training "
                                 "rules: its distances over the rank's "
                                 "blocks are not ported")
        if gp is None:
            gp = flatlib.unpack(fstate.P, layout)
        device = fstate.P.device
        C_loc, K = tree_leaves(client_batches)[0].shape[:2]
        C = C_loc * n_cshards
        n_loc = layout.padded_size // shards
        cols = slice(n_blk * n_loc, (n_blk + 1) * n_loc)
        lanes_of = slice(c_blk * C_loc, (c_blk + 1) * C_loc)
        mask = flatlib.round_mask(layout, device)

        def on_device(a):
            # the round's host draws, queued with no host sync
            return _queued_copy(a, device)

        def mine(x):
            """The block's lanes of a whole (C,) vector: every rank
            draws the whole vectors (the reference's replicated pins)."""
            return x[lanes_of] if sharded and x is not None else x

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
        counts = mcounts if guard_tail else step_counts
        budget = mine(budget)

        # the client slab is owned by this round: the apply kernel
        # updates it in place, step after step. Under a mesh the local
        # steps run on the rank's TP slab, cut from the whole params
        P0 = fstate.P[cols] if sharded else fstate.P
        P_start = (P0[None].expand(C_loc, n_loc)
                   if (is_async or comp is not None or guard_tail)
                   else None)
        slab, sync = rank_slab(layout) if sharded else (None, ())
        if sharded:
            P = slab.cut(fstate.P)[None].expand(C_loc, slab.width).clone()
            mask = slab.mask(device)
            S = flat_delta_sgd_init(
                C_loc, flatlib.FlatLayout(None, (), slab.width, slab.width),
                eta0=eta0, theta0=theta0, device=device)
        else:
            P = P0[None].expand(C_loc, n_loc).clone()
            S = flat_delta_sgd_init(C, layout, eta0=eta0, theta0=theta0,
                                    device=device)
        losses = []
        for k in range(K):
            batch_k = tree_map(lambda x: x[:, k], client_batches)
            G, loss = local_grads(P, layout, batch_k, gp, prev_local_params,
                                  slab, sync)
            if nan_on:
                # NaN gradients from the drawn step on, injected on the
                # wire side of the guard: the in-step guard must catch
                # them (valid latches off, η=0, lane sanitised)
                G = torch.where((k >= mine(lanes.nan_step))[:, None],
                                float("nan"), G)
            active = (k < budget) if budget is not None else None
            P, S = step(P, G, S, mask, active, eta0_c)
            del G
            losses.append(loss)
        losses = torch.stack(losses, dim=1)       # (C_loc, K)
        if sharded:
            # the round-end local params back to the contiguous columns
            # of the reference's layout, for the round's tail (the
            # previous gradients are dead by now)
            S = S._replace(prev_grads=None)
            P = slab.to_columns(P)

        extra = _scenario_extras(scenario, fstate.round, C, num_clients,
                                 client_sizes, step_counts, device)
        if device not in edges and tele_on:
            edges[device] = tele.edges_on(device)
        if not sharded:
            # numerical-guard telemetry: how often η hit the ETA_CLAMP
            # ceiling, and the share of lanes the NaN guard dropped
            extra.update(
                eta_clip_rate=(S.clips.to(torch.float32).sum()
                               * reciprocal(C * K)),
                nan_guard_rate=xla_mean((~S.valid).to(torch.float32)))
            if tele_on:
                # the distribution block: read-only over round-end
                # values, so the trajectory is unperturbed
                extra.update(round_telemetry(tele, S.eta, losses, S.clips,
                                             S.valid, edges=edges[device]))

        # survivor mask + byzantine factor of the guarded tail: a client
        # is excluded when its NaN guard latched or it dropped mid-round
        byz = valid = None
        if guard_tail:
            valid = S.valid
            if drops_on:
                valid = valid & (mine(lanes.drop_step) >= K)
            if byz_on:
                byz = torch.where(mine(lanes.byzantine),
                                  fm.byzantine_scale, 1.0)

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
                delta_hat = new_ef = E + compress(delta - E, mine(levels))
            else:
                delta_hat = compress(delta, mine(levels))
            # wire accounting over the VALID elements (layout.size), of
            # the whole cohort on every rank
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

        # the tail's inputs: the survivors' deltas for the RobustAgg
        # ladder (guarded tail), the FedBuff staleness weights (async)
        w_raw = (client_weights.to(torch.float32)
                 if weighted and client_weights is not None else None)
        stale = w = None
        if is_async:
            stale = on_device(scenario.draw_staleness(fstate.round, C))
            if overstale_on:
                stale = torch.where(lanes.overstale, fm.overstale,
                                    stale).to(torch.int32)
            w = staleness_weights(stale, scenario.staleness_exp)
            if w_raw is not None:
                w = w * w_raw
        d = delta_hat if comp is not None else (
            (P - P_start) if P_start is not None else None)
        rinfo = {}
        if guard_tail:
            if is_async:
                # over-stale updates are rejected
                valid = valid & (mine(stale) <= scenario.staleness_max)
            if byz is not None and comp is None:
                d = d * byz[:, None]
            rob, rinfo = robust(d, valid, mine(w if is_async else w_raw))

        # the client-axis reductions -> ``agg``: the (weighted) mean of
        # the round-end params (sync), the staleness-weighted delta sum
        # Σ wΔ (async) or the ladder's delta (guarded), in the block's
        # columns; ``n_valid`` and ``wsum`` are the survivors' count and
        # weight sum
        n_valid = wsum = None
        if guard_tail:
            vf = valid.to(torch.float32)
            agg = rob
        if not sharded:
            metrics = _round_metrics(losses, S.eta, counts)
            if guard_tail:
                n_valid = vf.sum()
                if is_async:
                    wsum = (w * vf).sum()
            elif is_async:
                # one weighted product over the packed client axis
                agg, wsum = torch.tensordot(w, d, dims=([0], [0])), w.sum()
            elif w_raw is not None:
                agg = torch.tensordot(w_raw / w_raw.sum(), P_agg,
                                      dims=([0], [0]))
            else:
                agg = P_agg.mean(dim=0)
        else:
            # every client-axis sum rides ONE packed all_reduce: the
            # aggregate's columns (off the guarded tail, whose ladder
            # reduced its own), then loss, last-step loss, Σ η, clamp
            # hits, guard trips and, as needed, the survivor count, their
            # staleness weight and telemetry's B η-histogram counts; both
            # η extrema share ONE (2,) min
            if counts is not None:
                am = active_mask(mine(counts), K)
                loss_num = (losses * am).sum()
                loss_den = active_mask(counts, K).sum()
                last_num = losses.gather(
                    1, (mine(counts) - 1).long()[:, None]).sum()
            else:
                loss_num = losses.sum()
                loss_den = losses.new_full((), float(C * K))
                last_num = losses[:, -1].sum()
            scal = [loss_num, last_num, S.eta.sum(),
                    S.clips.to(torch.float32).sum(),
                    (~S.valid).to(torch.float32).sum()]
            parts = []
            if guard_tail:
                scal.append(vf.sum())
                if is_async:
                    scal.append((mine(w) * vf).sum())
            elif is_async:
                parts.append(torch.tensordot(mine(w), d, dims=([0], [0])))
            elif w_raw is not None:
                parts.append(torch.tensordot(mine(w_raw / w_raw.sum()),
                                             P_agg, dims=([0], [0])))
            else:
                parts.append(P_agg.sum(dim=0))
            parts.append(torch.stack(scal))
            if tele_on:
                parts.append(tk.lane_histogram(S.eta, edges[device]).to(
                    torch.float32))
            packed = dist.all_reduce(torch.cat(parts), mesh, ca,
                                     role="flat_sum")
            ext = dist.all_reduce(torch.stack([S.eta.min(), -S.eta.max()]),
                                  mesh, ca, op="min", role="flat_min")
            off = 0 if guard_tail else n_loc
            sg = packed[off:]
            metrics = {"loss": sg[0] / loss_den,
                       "loss_last_step": sg[1] / C,
                       "eta_mean": sg[2] / C,
                       "eta_min": ext[0], "eta_max": -ext[1]}
            extra.update(eta_clip_rate=sg[3] * reciprocal(C * K),
                         nan_guard_rate=sg[4] * reciprocal(C))
            if tele_on:
                extra.update(eta_hist=sg[-tele.eta_bins:],
                             eta_clip_count=sg[3], nan_guard_count=sg[4])
                if tele.loss_deciles:
                    # the clients' (C_loc,) mean losses, gathered over
                    # the client axes for the ranked values
                    client_loss = dist.all_gather(
                        xla_mean(losses.to(torch.float32), dim=1), mesh, ca,
                        role="metrics")
                    extra["loss_deciles"] = tk.lane_quantiles(
                        client_loss, tele.quantiles)
            if guard_tail:
                n_valid = sg[5]
                if is_async:
                    wsum = sg[6]
            else:
                agg = packed[:off]
                if is_async:
                    wsum = w.sum()
                elif w_raw is None:
                    agg = agg / C

        buf = fstate.buffer
        # quorum degradation: with < Q valid clients the round keeps the
        # previous params, server state, buffer and EF21 state (the
        # tail's one host read; under a mesh the count is whole on
        # every rank, so every rank takes the same branch). A fake
        # tensor (the dry run) has no count to read: it counts the path
        # that steps
        skipped = (guard_tail and quorum > 0 and not is_fake(n_valid)
                   and float(n_valid) < quorum)
        if skipped:
            newP, sstate = fstate.P, fstate.server_state
            flushed = n_valid.new_zeros(())
            if new_ef is not None:
                new_ef = E
        elif not is_async:
            # the guarded tail's delta re-anchors on the round-start
            # params
            agg = whole(agg)
            if guard_tail:
                agg = fstate.P + agg
            new_params, sstate = server_opt.update(
                gp, flatlib.unpack(agg, layout), fstate.server_state)
            newP = flatlib.pack(new_params, layout)
        else:
            # FedBuff: the cohort's staleness-weighted delta sum goes into
            # the buffer, and the server steps once it holds M updates;
            # the guarded tail merges the robust mean scaled back to Σ wΔ
            # form, so the flush's Σ wΔ / Σ w recovers it
            delta_flat = whole(agg)
            if guard_tail:
                delta_flat = delta_flat * wsum
            buf = buffer_merge(
                buf, flatlib.unpack(delta_flat, layout, cast=False), wsum,
                n_valid.to(torch.int32) if guard_tail else C, stale)
            new_params, sstate, buf, flushed = buffer_step(
                gp, fstate.server_state, buf, server_opt,
                scenario.buffer_size)
            newP = flatlib.pack(new_params, layout)
        if is_async:
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
        """-> (new_state, metrics, new_local_params (C, ...)); under a
        mesh the third value is the rank's (C_loc, N_loc) slab of
        round-end local params."""
        from repro_torch.core.fed_loop import (flatten_fl_state,
                                               unflatten_fl_state)
        layout = flatlib.layout_of(state.params, shards=shards)
        # under a mesh FLState.ef is the rank's slab already
        fstate = flatten_fl_state(state._replace(ef=None) if sharded
                                  else state, layout)
        if sharded:
            fstate = fstate._replace(ef=state.ef)
        new_fstate, metrics, aux = flat_body(
            fstate, client_batches, layout, client_weights=client_weights,
            prev_local_params=prev_local_params, gp=state.params)
        if sharded:
            new_state = unflatten_fl_state(new_fstate._replace(ef=None),
                                           layout)
            return (new_state._replace(ef=new_fstate.ef), metrics,
                    aux.P_locals)
        new_state = unflatten_fl_state(new_fstate, layout)
        return new_state, metrics, flatlib.unpack_batched(aux.P_locals,
                                                          layout)

    round_fn.flat_body = flat_body
    return round_fn

