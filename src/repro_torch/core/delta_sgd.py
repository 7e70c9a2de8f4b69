"""Δ-SGD (DELTA-SGD), the paper's contribution: Eq. (4) + Algorithm 1,
on the flat engine.

    η_{t,k}^i = min( γ·‖x_k − x_{k−1}‖ / (2‖∇̃f_i(x_k) − ∇̃f_i(x_{k−1})‖),
                     sqrt(1 + δ·θ_{k−1})·η_{k−1} )
    θ_k = η_k / η_{k−1}

Port of the flat engine of ``repro/core/delta_sgd.py``:
``FlatDeltaSGDState`` + ``flat_delta_sgd_step`` run the rule for all C
participating clients at once on packed ``(C, N)`` buffers
(``repro_torch.core.flat``), with exactly two kernel launches per local
step (``batched_norms`` + ``batched_apply``) whatever the leaf and
client counts. For SGD updates ‖x_k − x_{k−1}‖ = η_{k−1}·‖g_{k−1}‖, so
the state carries only the previous gradient, η, θ and ‖g_{k−1}‖.

The per-leaf engine (``delta_sgd_init/reset/update``) belongs to the
vmap engine (ROADMAP A3/A7) and the sharded step to ROADMAP A17.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import flat as flatlib
from repro_torch.kernels.delta_sgd import delta_sgd as kernels

# Numerical guard ceiling on η: Eq. (4)'s cand1 can blow up when
# ‖∇̃f(x_k) − ∇̃f(x_{k−1})‖ underflows, and a non-finite η would poison the
# packed buffer. η is clamped to this ceiling (counted per client in
# FlatDeltaSGDState.clips); non-finite norms drop the lane to η=0 and
# latch FlatDeltaSGDState.valid off for the rest of the round. The f32
# min against a finite ceiling is exact, so healthy lanes are unchanged.
ETA_CLAMP = 1e3


class FlatDeltaSGDState(NamedTuple):
    prev_grads: torch.Tensor      # (C, N) packed previous gradients, f32
    eta: torch.Tensor             # (C,) per-client step size
    theta: torch.Tensor           # (C,) η_k / η_{k-1}
    prev_grad_norm: torch.Tensor  # (C,)
    k: int                        # local step counter (resets per round)
    valid: torch.Tensor           # (C,) bool: lane healthy, LATCHES off
    clips: torch.Tensor           # (C,) int32: η-clamp hits


def flat_delta_sgd_init(num_clients: int, layout: flatlib.FlatLayout, *,
                        eta0: float, theta0: float,
                        device=None) -> FlatDeltaSGDState:
    C, N = num_clients, layout.padded_size
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
    cand2 = torch.sqrt(1.0 + delta * theta_prev) * eta_prev
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
                        delta: float, eta0: float,
                        mask: Optional[torch.Tensor] = None,
                        active: Optional[torch.Tensor] = None):
    """One Δ-SGD local step for ALL clients on packed (C, N) buffers.

    Exactly two kernel launches. ``P`` is updated IN PLACE by the apply
    kernel and returned; ``G`` is not modified. ``active`` is an optional
    (C,) bool lane mask (inactive clients apply η=0 and keep their state).
    Returns (P, new_state)."""
    dg2, gg2 = kernels.batched_norms(G, state.prev_grads)
    dg_norm = torch.sqrt(dg2)
    grad_norm = torch.sqrt(gg2)
    if state.k == 0:
        # first local step: η₀ (Alg. 1 line 6), θ unchanged
        eta, theta = torch.full_like(state.eta, eta0), state.theta
    else:
        dx_norm = state.eta * state.prev_grad_norm
        eta, theta = _eta_rule(state.eta, state.theta, dx_norm, dg_norm,
                               gamma, delta)
    eta, valid, clip_hit = _guard(eta, dg_norm, grad_norm, state.valid)
    act = valid if active is None else (active & valid)
    eta_applied, eta, theta, grad_norm = _mask_inactive(
        act, eta, theta, grad_norm, state)
    clips = state.clips + (clip_hit & act).to(torch.int32)
    # η=0 alone cannot stop a NaN gradient (0·NaN = NaN in the apply), so
    # invalid lanes are zeroed before both the apply and the prev_grads
    # roll; on healthy lanes this is G bitwise.
    G_safe = torch.where(valid[:, None], G, 0.0)
    P = kernels.batched_apply(P, G_safe, eta_applied, mask=mask)
    return P, FlatDeltaSGDState(G_safe, eta, theta, grad_norm, state.k + 1,
                                valid, clips)
