"""Δ-SGD (DELTA-SGD), the paper's contribution: Eq. (4) + Algorithm 1.

    η_{t,k}^i = min( γ·‖x_k − x_{k−1}‖ / (2‖∇̃f_i(x_k) − ∇̃f_i(x_{k−1})‖),
                     sqrt(1 + δ·θ_{k−1})·η_{k−1} )
    θ_k = η_k / η_{k−1}

Port of ``repro/core/delta_sgd.py``. For SGD updates
‖x_k − x_{k−1}‖ = η_{k−1}·‖g_{k−1}‖, so the state carries only the
previous gradient, η, θ and ‖g_{k−1}‖. Norms are global over the param
tree, in f32.

Per-leaf engine (the vmap engine's client optimizer): ``DeltaSGDState``
and ``delta_sgd_init/reset/update`` for one client's param tree, with
the beyond-paper ``groupwise`` variant (one step size per top-level
param group). ``use_pallas=True`` hands the global rule to the kernel
route, ``repro_torch.kernels.delta_sgd.ops.fused_delta_sgd_update``.
Under installed training rules (the tensor-parallel vmap round) a
client's tree is this rank's blocks, and the two global norms come from
``sharded_sq_sums``: one (2,) sum over the norm axes a step, each
element counted once.

Flat engine: ``FlatDeltaSGDState`` + ``flat_delta_sgd_step`` run the
rule for all C participating clients at once on packed ``(C, N)``
buffers (``repro_torch.core.flat``), with exactly two kernel launches
per local step (``batched_norms`` + ``batched_apply``) whatever the leaf
and client counts. ``flat_delta_sgd_step_sharded`` is the same step on a
rank's (C_loc, N_loc) slab of a mesh-sharded buffer: the kernel pair runs
on the local slab and the per-client sums finish with one ``all_reduce``
of a stacked (2, C_loc) tensor over the N-shard axes.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Union

import torch

from repro_torch.core import flat as flatlib
from repro_torch.kernels.delta_sgd import delta_sgd as kernels
from repro_torch.utils import numerics
from repro_torch.utils.tree import tree_leaves, tree_map

# Numerical guard ceiling on η: Eq. (4)'s cand1 can blow up when
# ‖∇̃f(x_k) − ∇̃f(x_{k−1})‖ underflows, and a non-finite η would poison the
# packed buffer. η is clamped to this ceiling (counted per client in
# FlatDeltaSGDState.clips); non-finite norms drop the lane to η=0 and
# latch FlatDeltaSGDState.valid off for the rest of the round. The f32
# min against a finite ceiling is exact, so healthy lanes are unchanged.
ETA_CLAMP = 1e3


class DeltaSGDState(NamedTuple):
    prev_grads: Any               # tree like params
    eta: Any                      # step size: 0-d f32, or a dict per group
    theta: Any                    # η_k / η_{k-1}
    prev_grad_norm: Any
    k: torch.Tensor               # local step counter, int32 (resets per round)


def _global_norm(tree) -> torch.Tensor:
    return numerics.sqrt(sum((l.to(torch.float32) ** 2).sum()
                          for l in tree_leaves(tree)))


def training_rules():
    """The installed training rules that shard the params of a client
    (``LogicalRules(serve=False)`` with its placements), else None."""
    from repro_torch.models.common import get_logical_rules
    rules = get_logical_rules()
    if rules is None or rules.serve or rules.param_axes is None:
        return None
    return rules


def sharded_sq_sums(grads, prev_grads, rules) -> torch.Tensor:
    """(Σ(g − g_prev)², Σg²) over a client's whole tree from this rank's
    blocks: each leaf's partial sums, counted where
    ``sharding.spec.counted_leaves`` says (a leaf replicated over a norm
    axis only on its index 0), summed in one (2,) ``reduce_from`` over
    the norm axes (``norms``), so every element counts once."""
    from repro_torch.sharding import dist
    from repro_torch.sharding.spec import counted_leaves, norm_axes
    count = tree_leaves(counted_leaves(rules.spec, rules.mesh,
                                       rules.param_axes, rules.coords))
    dg = gg = None
    for c, g, q in zip(count, tree_leaves(grads), tree_leaves(prev_grads)):
        if not c:
            continue
        g32 = g.to(torch.float32)
        d = ((g32 - q.to(torch.float32)) ** 2).sum()
        n = (g32 ** 2).sum()
        dg, gg = (d, n) if dg is None else (dg + d, gg + n)
    if dg is None:
        like = tree_leaves(grads)[0]
        dg = gg = like.new_zeros((), dtype=torch.float32)
    return dist.reduce_from(torch.stack([dg, gg]), rules.mesh,
                            norm_axes(rules.spec, rules.mesh), role="norms")


def _group_norms(tree) -> dict:
    """One norm per top-level key (beyond-paper groupwise variant)."""
    return {k: _global_norm(v) for k, v in tree.items()}


def _f32(x, like) -> torch.Tensor:
    """A 0-d f32 state tensor on like's device: a fill, no host copy."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def delta_sgd_init(params, *, eta0: float, theta0: float,
                   groupwise: bool = False) -> DeltaSGDState:
    zeros = tree_map(torch.zeros_like, params)
    like = tree_leaves(params)[0]
    if groupwise:
        eta = {k: _f32(eta0, like) for k in params}
        theta = {k: _f32(theta0, like) for k in params}
        pgn = {k: _f32(0.0, like) for k in params}
    else:
        eta, theta, pgn = (_f32(eta0, like), _f32(theta0, like),
                           _f32(0.0, like))
    return DeltaSGDState(zeros, eta, theta, pgn,
                         torch.zeros((), dtype=torch.int32,
                                     device=like.device))


def delta_sgd_reset(state: DeltaSGDState, *, eta0: float,
                    theta0: float) -> DeltaSGDState:
    """Round-start reset (Alg. 1 line 6): η ← η₀, θ ← θ₀, k ← 0."""
    eta = tree_map(lambda e: torch.full_like(e, eta0), state.eta)
    theta = tree_map(lambda t: torch.full_like(t, theta0), state.theta)
    pgn = tree_map(torch.zeros_like, state.prev_grad_norm)
    return DeltaSGDState(state.prev_grads, eta, theta, pgn,
                         torch.zeros_like(state.k))


def _sgd_apply(params, grads, eta):
    """x ← x − η·g in f32, cast back to each leaf's dtype."""
    return tree_map(lambda p, g: (p.to(torch.float32)
                                  - eta * g.to(torch.float32)).to(p.dtype),
                    params, grads)


def _diff_norm(grads, prev_grads) -> torch.Tensor:
    """‖g − g_prev‖ with the difference in f32 (exact for bf16 inputs)."""
    return _global_norm(tree_map(
        lambda a, b: a.to(torch.float32) - b.to(torch.float32),
        grads, prev_grads))


def delta_sgd_update(params, grads, state: DeltaSGDState, *, gamma: float,
                     delta: float, eta0: float, use_pallas: bool = False):
    """One local step: η by Eq. (4) (η₀ on the first local step), then
    x ← x − η·g, and the state rolls. Tensor ops only, with no host
    read, so it runs under ``torch.func.vmap`` over a client axis."""
    first = state.k == 0
    if isinstance(state.eta, dict):
        new_eta, new_theta = {}, {}
        for k in params:
            dx = state.eta[k] * state.prev_grad_norm[k]
            e, t = _eta_rule(state.eta[k], state.theta[k], dx,
                             _diff_norm(grads[k], state.prev_grads[k]),
                             gamma, delta)
            new_eta[k] = torch.where(first, eta0, e)
            new_theta[k] = torch.where(first, state.theta[k], t)
        new_params = {k: _sgd_apply(params[k], grads[k], new_eta[k])
                      for k in params}
        return new_params, DeltaSGDState(grads, new_eta, new_theta,
                                         _group_norms(grads), state.k + 1)

    if use_pallas:
        from repro_torch.kernels.delta_sgd import ops
        return ops.fused_delta_sgd_update(params, grads, state, gamma=gamma,
                                          delta=delta, eta0=eta0)

    dx_norm = state.eta * state.prev_grad_norm
    rules = training_rules()
    if rules is None:
        dg_norm, g_norm = (_diff_norm(grads, state.prev_grads),
                           _global_norm(grads))
    else:
        sums = numerics.sqrt(sharded_sq_sums(grads, state.prev_grads, rules))
        dg_norm, g_norm = sums[0], sums[1]
    eta, theta = _eta_rule(state.eta, state.theta, dx_norm, dg_norm, gamma,
                           delta)
    eta = torch.clamp(torch.where(first, eta0, eta), max=ETA_CLAMP)
    theta = torch.where(first, state.theta, theta)
    return _sgd_apply(params, grads, eta), DeltaSGDState(
        grads, eta, theta, g_norm, state.k + 1)


class FlatDeltaSGDState(NamedTuple):
    prev_grads: torch.Tensor      # (C, N) packed previous gradients, f32
    eta: torch.Tensor             # (C,) per-client step size
    theta: torch.Tensor           # (C,) η_k / η_{k-1}
    prev_grad_norm: torch.Tensor  # (C,)
    k: Union[int, torch.Tensor]   # local step counter (resets per round):
    #                               the flat engines' Python int, or the
    #                               per-leaf state's int32 tensor on the
    #                               kernel route (``kernels.delta_sgd.ops``)
    valid: torch.Tensor           # (C,) bool: lane healthy, LATCHES off
    clips: torch.Tensor           # (C,) int32: η-clamp hits


def flat_delta_sgd_init(num_clients: int, layout: flatlib.FlatLayout, *,
                        eta0: float, theta0: float, device=None,
                        mesh=None, federation=None) -> FlatDeltaSGDState:
    """Round-start flat state of ``num_clients`` clients. With ``mesh``
    and ``federation`` it is this rank's block: (C_loc, N_loc) slabs and
    (C_loc,) lanes."""
    C, N = num_clients, layout.padded_size
    if mesh is not None:
        C, N = federation.local_shape(mesh, C, N)
    f32 = dict(dtype=torch.float32, device=device)
    return FlatDeltaSGDState(
        torch.zeros((C, N), **f32),
        torch.full((C,), eta0, **f32),
        torch.full((C,), theta0, **f32),
        torch.zeros((C,), **f32),
        0,
        torch.ones((C,), dtype=torch.bool, device=device),
        torch.zeros((C,), dtype=torch.int32, device=device))


def _eta_rule(eta_prev, theta_prev, dx_norm, dg_norm, gamma, delta):
    """Eq. (4) with the δ-damped growth condition (Appendix B.1)."""
    cand1 = torch.where(dg_norm > 0.0, gamma * dx_norm / (2.0 * dg_norm),
                        float("inf"))
    cand2 = numerics.sqrt(1.0 + delta * theta_prev) * eta_prev
    eta = torch.minimum(cand1, cand2)
    return eta, eta / eta_prev


def _guard(eta, dg_norm, grad_norm, valid_prev):
    """In-step numerical guard: non-finite norms drop the lane (``valid``
    latches off) and runaway η is clamped to ETA_CLAMP. A NaN η compares
    False against the ceiling, so a poisoned lane counts as a NaN-guard
    trip, not a clip. Returns (eta, valid, clip_hit)."""
    finite = torch.isfinite(dg_norm) & torch.isfinite(grad_norm)
    valid = valid_prev & finite
    clip_hit = eta > ETA_CLAMP
    # clamp propagates NaN, like jnp.minimum
    return torch.clamp(eta, max=ETA_CLAMP), valid, clip_hit


def _mask_inactive(active, eta, theta, grad_norm, state):
    """Heterogeneous-K lane masking: a client past its budget applies η=0
    and keeps its scalar state frozen. Returns (eta_applied, eta, theta,
    grad_norm)."""
    eta_applied = torch.where(active, eta, 0.0)
    eta = torch.where(active, eta, state.eta)
    theta = torch.where(active, theta, state.theta)
    grad_norm = torch.where(active, grad_norm, state.prev_grad_norm)
    return eta_applied, eta, theta, grad_norm


def flat_delta_sgd_step(P: torch.Tensor, G: torch.Tensor,
                        state: FlatDeltaSGDState, *, gamma: float,
                        delta: float,
                        eta0: Union[float, torch.Tensor],
                        mask: Optional[torch.Tensor] = None,
                        active: Optional[torch.Tensor] = None):
    """One Δ-SGD local step for ALL clients on packed (C, N) buffers.

    Exactly two kernel launches. ``P`` is updated IN PLACE by the apply
    kernel and returned; ``G`` is not modified. ``eta0`` is the scalar
    η₀ or a (C,) f32 tensor of per-client ones (the fleet loop's warm
    start). ``active`` is an optional (C,) bool lane mask (inactive
    clients apply η=0 and keep their state). Returns (P, new_state)."""
    dg2, gg2 = kernels.batched_norms(G, state.prev_grads)
    return _finish_step(P, G, state, dg2, gg2, gamma=gamma, delta=delta,
                        eta0=eta0, mask=mask, active=active)


def flat_delta_sgd_step_sharded(P: torch.Tensor, G: torch.Tensor,
                                state: FlatDeltaSGDState, *, gamma: float,
                                delta: float,
                                eta0: Union[float, torch.Tensor], mesh,
                                pspec, mask: Optional[torch.Tensor] = None,
                                active: Optional[torch.Tensor] = None,
                                g_inplace: bool = False):
    """One Δ-SGD local step on this rank's block of a mesh-sharded
    packed (C, N) buffer.

    ``pspec`` is ``FederationSpec.flat_spec(mesh)``: clients over
    ``pspec[0]``, N over ``pspec[1]`` (the layout built with
    ``shards=FederationSpec.flat_shards(mesh)``). ``P``, ``G`` and
    ``state.prev_grads`` are the rank's (C_loc, N_loc) slabs, the
    state's vectors and ``active`` its (C_loc,) lanes, ``mask`` its
    (N_loc,) columns. The kernel pair runs on the local slab; the
    per-client (dg², gg²) sums finish with ONE all_reduce of a stacked
    (2, C_loc) tensor over the N-shard axes, so η is exact while N is
    never gathered. Every rank of an N-shard group then takes the same
    η. ``P`` is updated in place; with ``g_inplace`` (``G`` is the
    caller's own) the invalid lanes of ``G`` are zeroed in place and
    ``G`` becomes the new state's previous gradients, with no second
    slab. Returns (P, new_state)."""
    from repro_torch.sharding import dist
    dg2, gg2 = kernels.batched_norms(G, state.prev_grads)
    if pspec[1]:
        sums = dist.all_reduce(torch.stack([dg2, gg2]), mesh, pspec[1],
                               role="norms")
        dg2, gg2 = sums[0], sums[1]
    return _finish_step(P, G, state, dg2, gg2, gamma=gamma, delta=delta,
                        eta0=eta0, mask=mask, active=active,
                        g_inplace=g_inplace)


def _finish_step(P, G, state: FlatDeltaSGDState, dg2, gg2, *, gamma, delta,
                 eta0, mask, active, g_inplace: bool = False):
    """η by Eq. (4) from the per-client sums, the guards, the lane mask,
    and the apply kernel. ``g_inplace``: ``G`` is the caller's own copy,
    and its invalid lanes are zeroed in place (no second slab)."""
    dg_norm = numerics.sqrt(dg2)
    grad_norm = numerics.sqrt(gg2)
    # a client's first local step takes η₀ (Alg. 1 line 6), θ unchanged.
    # ``first`` is a Python bool on the flat engines, whose counter is a
    # host int shared by all clients: their first step skips the rule's
    # device ops. The kernel route counts per client (an int32 tensor, as
    # the reference's vmapped call has it) and picks with torch.where.
    first = state.k == 0
    if first is True:
        eta = (eta0.to(state.eta.dtype).expand_as(state.eta)
               if isinstance(eta0, torch.Tensor)
               else torch.full_like(state.eta, eta0))
        theta = state.theta
    else:
        eta, theta = _eta_rule(state.eta, state.theta,
                               state.eta * state.prev_grad_norm, dg_norm,
                               gamma, delta)
        if isinstance(first, torch.Tensor):
            eta = torch.where(first, eta0, eta)
            theta = torch.where(first, state.theta, theta)
    eta, valid, clip_hit = _guard(eta, dg_norm, grad_norm, state.valid)
    act = valid if active is None else (active & valid)
    eta_applied, eta, theta, grad_norm = _mask_inactive(
        act, eta, theta, grad_norm, state)
    clips = state.clips + (clip_hit & act).to(torch.int32)
    # η=0 alone cannot stop a NaN gradient (0·NaN = NaN in the apply), so
    # invalid lanes are zeroed before both the apply and the prev_grads
    # roll; on healthy lanes this is G bitwise.
    G_safe = (G.masked_fill_(~valid[:, None], 0.0) if g_inplace
              else torch.where(valid[:, None], G, 0.0))
    P = kernels.batched_apply(P, G_safe, eta_applied, mask=mask)
    return P, FlatDeltaSGDState(G_safe, eta, theta, grad_norm, state.k + 1,
                                valid, clips)
