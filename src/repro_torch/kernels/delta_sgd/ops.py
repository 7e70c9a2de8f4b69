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

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import flat as flatlib
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

# the tensor-parallel slab's sub-rows: LANES·2^j elements each, the
# least j that keeps a client's row within this many sub-rows
TP_MAX_SUBROWS = 1024


def fused_delta_sgd_update(params, grads, state, *, gamma: float,
                           delta: float, eta0: float):
    """Drop-in for ``core.delta_sgd.delta_sgd_update`` (global rule): the
    flat engine's step on packed (C, N) buffers, C = 1 for one client.
    As in the reference, no lane starts invalid (a lane is valid while
    its norms are finite) and the new state's previous gradients are
    ``grads`` as given."""
    from repro_torch.core.delta_sgd import (DeltaSGDState,
                                            FlatDeltaSGDState,
                                            flat_delta_sgd_step,
                                            training_rules)
    stacked = state.eta.ndim == 1
    rules = training_rules()
    if rules is not None:
        if not stacked:
            raise ValueError("the tensor-parallel kernel route runs on the "
                             "cohort's stacked trees (the vmap round)")
        return _fused_sharded(params, grads, state, rules, gamma=gamma,
                              delta=delta, eta0=eta0)
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


class SubRowLayout(NamedTuple):
    """A rank's slab of a client's blocks, one leaf after another, each
    starting on a sub-row of ``unit`` elements (zero-filled tails):
    ``offsets``/``sizes`` of the leaves, ``rows`` sub-rows a client,
    ``counted`` a (rows,) 0/1 mask of the sub-rows this rank counts."""
    unit: int
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    rows: int
    counted: Tuple[bool, ...]

    @property
    def size(self) -> int:
        return self.rows * self.unit


def subrow_layout(sizes, counted) -> SubRowLayout:
    """The layout of leaves of ``sizes`` elements, counted where
    ``counted`` says: sub-rows of LANES·2^j elements, the least j
    that keeps a client within TP_MAX_SUBROWS sub-rows."""
    unit = flatlib.LANES
    while sum(-(-n // unit) for n in sizes) > TP_MAX_SUBROWS:
        unit *= 2
    offsets, mask, row = [], [], 0
    for n, c in zip(sizes, counted):
        k = -(-n // unit)
        offsets.append(row * unit)
        mask += [bool(c)] * k
        row += k
    return SubRowLayout(unit, tuple(offsets), tuple(int(n) for n in sizes),
                        row, tuple(mask))


def _pack_subrows(leaves, lay: SubRowLayout, C: int) -> torch.Tensor:
    parts = []
    for leaf, n in zip(leaves, lay.sizes):
        parts.append(leaf.reshape(C, -1).to(torch.float32))
        pad = -n % lay.unit
        if pad:
            parts.append(parts[-1].new_zeros((C, pad)))
    return torch.cat(parts, dim=1)


def _fused_sharded(params, grads, state, rules, *, gamma, delta, eta0):
    """The kernel route on a rank's blocks under training rules: the
    cohort's (C_loc, N) slab in sub-rows (``subrow_layout``).
    ``batched_norms`` runs once on the slab seen as (C_loc·rows, unit),
    each sub-row's sums masked by whether this rank counts its leaf
    (``sharding.spec.counted_leaves``) and added per client, and ONE
    (2, C_loc) ``norms`` sum over the norm axes finishes them; then one
    ``batched_apply`` on the (C_loc, N) slab: two launches a step, and
    every element of a client's params counted once."""
    from repro_torch.core.delta_sgd import (DeltaSGDState,
                                            FlatDeltaSGDState, _finish_step)
    from repro_torch.kernels.delta_sgd import delta_sgd as kernels
    from repro_torch.sharding import dist
    from repro_torch.sharding.spec import counted_leaves, norm_axes
    leaves, treedef = tree_flatten(params)
    C = leaves[0].shape[0]
    counted = tree_leaves(counted_leaves(rules.spec, rules.mesh,
                                         rules.param_axes, rules.coords))
    lay = subrow_layout([l[0].numel() for l in leaves], counted)
    # two packed slabs live at a time: (G, G_prev) for the norms, then
    # (G, P) for the apply, G's invalid lanes zeroed in place
    G = _pack_subrows(tree_leaves(grads), lay, C)
    G_prev = _pack_subrows(tree_leaves(state.prev_grads), lay, C)
    dg, gg = kernels.batched_norms(G.view(C * lay.rows, lay.unit),
                                   G_prev.view(C * lay.rows, lay.unit))
    del G_prev
    w = torch.tensor(lay.counted, dtype=torch.float32).to(G.device)
    sums = torch.stack([(dg.view(C, lay.rows) * w).sum(1),
                        (gg.view(C, lay.rows) * w).sum(1)])
    sums = dist.reduce_from(sums, rules.mesh, norm_axes(rules.spec,
                                                         rules.mesh),
                            role="norms")
    P = _pack_subrows(leaves, lay, C)
    mask = None
    if any(l.dtype != torch.float32 for l in leaves):
        mask = torch.zeros((lay.size,), dtype=torch.float32)
        for l, off, n in zip(leaves, lay.offsets, lay.sizes):
            if l.dtype != torch.float32:
                mask[off:off + n] = 1.0
        mask = mask.to(P.device)
    fstate = FlatDeltaSGDState(
        None, state.eta, state.theta, state.prev_grad_norm, state.k,
        torch.ones((C,), dtype=torch.bool, device=P.device),
        torch.zeros((C,), dtype=torch.int32, device=P.device))
    P, fstate = _finish_step(P, G, fstate, sums[0], sums[1], gamma=gamma,
                             delta=delta, eta0=eta0, mask=mask, active=None,
                             g_inplace=True)
    out = [P[:, off:off + n].reshape(l.shape).to(l.dtype)
           for l, off, n in zip(leaves, lay.offsets, lay.sizes)]
    return tree_unflatten(treedef, out), DeltaSGDState(
        grads, fstate.eta, fstate.theta, fstate.prev_grad_norm, fstate.k)
