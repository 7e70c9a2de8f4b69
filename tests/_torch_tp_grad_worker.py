"""The rank worker of the differentiable-collective tests (torch only).

``tests/test_torch_tp_grad.py`` starts 4 gloo CPU ranks once over a
(data 2, model 2) mesh; each rank runs every operator of
``repro_torch.sharding.dist`` (``copy_to``, ``reduce_from``,
``gather_from``, ``max_over``) on inputs drawn from one seed, forward,
under ``torch.func.grad`` and under ``torch.func.vmap(grad)``, and
writes what it got, with the collectives it recorded, to
``rank<r>.pkl``. The test holds them against the unsharded math. This
module imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.sharding import dist, hlo

MESH = ((2, 2), ("data", "model"))
C = 3            # clients stacked under vmap


def inputs():
    """Every rank's inputs, the same draw on every rank (and in the
    test): per-rank weights w (4, 5, 8), blocks x (4, C, 5, 8) and
    upstream gradients u (4, C, 5, 16)."""
    rng = np.random.default_rng(5)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"w": f(4, 5, 8), "x": f(4, C, 5, 8), "u": f(4, C, 5, 16),
            "c": f(5, 8)}


def _ops():
    return [(o.kind, o.role, o.axes, o.shape, o.backward)
            for o in hlo.snapshot()]


def run_rank(rank, world, out_dir):
    mesh = dist.make_mesh(*MESH)
    co = dist.coords(mesh)
    r = 2 * co["data"] + co["model"]
    t = {k: torch.from_numpy(v) for k, v in inputs().items()}
    w, x, u, c = t["w"][r], t["x"][r], t["u"][r], t["c"]
    both = ("data", "model")
    out = {"coord": co, "rank": r}

    def record(name, fn):
        hlo.reset()
        out[name] = fn()
        out[name + "_ops"] = _ops()

    # copy_to (f): each rank weighs the replicated input by its own w;
    # the loss is the sum over ranks, so d/dx is Σ_r w_r on every rank
    f_copy = lambda a: (dist.copy_to(a, mesh, both) * w).sum()
    record("copy_fwd", lambda: dist.copy_to(x[0], mesh, both).numpy())
    record("copy_grad", lambda: grad(f_copy)(x[0]).numpy())
    record("copy_vgrad", lambda: vmap(grad(f_copy))(x).numpy())
    # reduce_from (g): the sum of each rank's partial x_r·w_r, read
    # through a replicated c; d/dx_r is w_r·c
    f_red = lambda a: (dist.reduce_from(a * w, mesh, both) * c).sum()
    record("reduce_fwd", lambda: dist.reduce_from(x[0] * w, mesh,
                                                  both).numpy())
    record("reduce_grad", lambda: grad(f_red)(x[0]).numpy())
    record("reduce_vgrad", lambda: vmap(grad(f_red))(x).numpy())
    # gather_from over model along dim 1: each rank reads the gathered
    # tensor through its own u; d/dx is this rank's block of the sum of
    # its model group's u
    f_gat = lambda a, uu: (dist.gather_from(a, mesh, ("model",), 1)
                           * uu).sum()
    record("gather_fwd", lambda: dist.gather_from(x[0], mesh, ("model",),
                                                  1).numpy())
    record("gather_grad", lambda: grad(f_gat)(x[0], u[0]).numpy())
    record("gather_vgrad", lambda: vmap(grad(f_gat))(x, u).numpy())
    # max_over: the max over every rank, and no gradient through it
    f_max = lambda a: (dist.max_over(a, mesh, both) + a).sum()
    record("max_fwd", lambda: dist.max_over(x[0], mesh, both).numpy())
    record("max_grad", lambda: grad(f_max)(x[0]).numpy())
    record("max_vfwd", lambda: vmap(lambda a: dist.max_over(
        a, mesh, both))(x).numpy())
    # no operator writes its input
    x0 = x.clone()
    dist.reduce_from(x, mesh, both)
    dist.copy_to(x, mesh, both)
    out["input_kept"] = bool(torch.equal(x, x0))
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(out, fh)
