"""Kernel-backed Δ-SGD local step over a param tree.

Port of ``repro/kernels/delta_sgd/ops.py``. The tree is packed into the
lane-aligned flat buffer (``repro_torch.core.flat``) and the step runs
``flat_delta_sgd_step``: exactly one ``batched_norms`` and one
``batched_apply`` launch, whatever the leaf count.

Called on one client's tree (a 0-d η) it is the reference's C = 1 call.
Called on the cohort's stacked trees (every leaf with a leading client
axis, a (C,) η and counter) it computes what ``jax.vmap`` of that call
lowers to, with the same two launches for all C clients: the vmap
engine takes this route, since ``torch.func.vmap`` cannot trace the
kernels' ctypes calls.
"""
from __future__ import annotations

import torch

from repro_torch.core import flat as flatlib


def fused_delta_sgd_update(params, grads, state, *, gamma: float,
                           delta: float, eta0: float):
    """Drop-in for ``core.delta_sgd.delta_sgd_update`` (global rule): the
    flat engine's step on packed (C, N) buffers, C = 1 for one client.
    As in the reference, no lane starts invalid (a lane is valid while
    its norms are finite) and the new state's previous gradients are
    ``grads`` as given."""
    from repro_torch.core.delta_sgd import (DeltaSGDState,
                                            FlatDeltaSGDState,
                                            flat_delta_sgd_step)
    stacked = state.eta.ndim == 1
    layout = flatlib.layout_of(params, batched=stacked)
    trees = (params, grads, state.prev_grads)
    scalars = (state.eta, state.theta, state.prev_grad_norm)
    if stacked:
        P, G, G_prev = (flatlib.pack_batched(t, layout) for t in trees)
        eta, theta, pgn = scalars
    else:
        P, G, G_prev = (flatlib.pack(t, layout)[None] for t in trees)
        eta, theta, pgn = (x[None] for x in scalars)
    C = P.shape[0]
    fstate = FlatDeltaSGDState(
        G_prev, eta, theta, pgn, state.k,
        torch.ones((C,), dtype=torch.bool, device=P.device),
        torch.zeros((C,), dtype=torch.int32, device=P.device))
    P, fstate = flat_delta_sgd_step(
        P, G, fstate, gamma=gamma, delta=delta, eta0=eta0,
        mask=flatlib.round_mask(layout, P.device))
    if stacked:
        return flatlib.unpack_batched(P, layout), DeltaSGDState(
            grads, fstate.eta, fstate.theta, fstate.prev_grad_norm,
            fstate.k)
    return flatlib.unpack(P[0], layout), DeltaSGDState(
        grads, fstate.eta[0], fstate.theta[0], fstate.prev_grad_norm[0],
        fstate.k)
