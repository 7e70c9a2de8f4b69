"""The rank worker of the MoE and MLA tensor-parallel tests (torch only).

``tests/test_torch_tp_moe.py`` writes each case's inputs to one pickle,
starts 4 gloo CPU ranks once with ``repro_torch.sharding.dist.spawn(
run_rank, ...)`` over a (data 2, model 2) mesh, and reads each rank's
results back from ``rank<r>.pkl``. The kinds: ``serve`` (prefill, forced
and greedy decode: ``tests/_torch_tp_worker.py``'s), ``round`` (one
vmap round under training rules: ``tests/_torch_tp_train_worker.py``'s),
``layer`` (one MoE layer on the rank's rows and experts, its output,
aux loss and, under training rules, the gradients of a fixed loss) and
``gather_split`` (the MTP gather's gradient, plain and under
``vmap(grad)``). This module imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import torch

from repro_torch import interop
from repro_torch.launch.steps import serve_rules, train_rules
from repro_torch.models import moe
from repro_torch.models.common import fsdp_gather_tree, logical_rules
from repro_torch.models.model import build_model
from repro_torch.sharding import dist, hlo
from repro_torch.sharding.spec import get_federation_spec, local_block
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

from _torch_tp_train_worker import run_round, tp_config
from _torch_tp_worker import MESH, _serve

ROWS = (("data",), None, None)


def _layer_params(params, axes):
    """Layer 0's MoE params of run0 and their entries, without the
    stacked layer axis."""
    return (tree_map(lambda a: a[0], params["stack"]["run0"]["moe"]),
            tree_map(lambda e: e[1:], axes["stack"]["run0"]["moe"]))


def run_layer(case, mesh):
    """``moe.apply_moe`` of layer 0 on the rank's rows (over ``data``)
    and experts, its params gathered at use where the spec shards them
    over an fsdp axis. Returns the rank's output rows and aux; under
    training rules also the gradients of aux + Σ out·R with respect to
    the rank's rows and its blocks of the layer's params."""
    cfg = tp_config(*case["cfg"])
    model = build_model(cfg)
    spec = get_federation_spec(case["federation"], mesh)
    whole = interop.params_from_numpy(case["params"])
    if case["serve"]:
        rules = serve_rules(model, mesh, whole, spec=spec,
                            batch_size=case["x"].shape[0])
    else:
        rules = train_rules(model, mesh, whole, spec=spec)
    coords = rules.coords
    p, ax = _layer_params(whole, rules.param_axes)
    loc = tree_map(lambda a, e: local_block(a, e, mesh, coords).clone()
                   .requires_grad_(not case["serve"]), p, ax)
    x = local_block(torch.from_numpy(case["x"]), ROWS, mesh, coords
                    ).clone().requires_grad_(not case["serve"])
    hlo.reset()
    with logical_rules(rules):
        lp = fsdp_gather_tree(loc, ax) if rules.fsdp_live else loc
        out, aux = moe.apply_moe(lp, x, cfg)
        res = {"coord": coords, "out": out.detach().numpy(),
               "aux": float(aux.detach())}
        if not case["serve"]:
            r = local_block(torch.from_numpy(case["r"]), ROWS, mesh, coords)
            leaves, treedef = tree_flatten(loc)
            grads = torch.autograd.grad(aux + (out * r).sum(),
                                        [x] + leaves)
            res["grad_x"] = grads[0].numpy()
            res["grads"] = interop.params_to_numpy(
                tree_unflatten(treedef, list(grads[1:])))
            res["axes"] = ax
    res["ops"] = [(c.kind, c.role, c.axes, c.shape, c.backward)
                  for c in hlo.snapshot()]
    return res


def run_gather_split(case, mesh):
    """The rank's block (over ``model``, the last dim) of ``x``,
    gathered whole with ``dist.gather_split`` and with
    ``dist.gather_from``, and Σ gathered·R differentiated: plain, and
    under ``vmap(grad)`` over a stacked leading axis."""
    coords = dist.coords(mesh)
    x = torch.from_numpy(case["x"])
    r = torch.from_numpy(case["r"])
    blk = local_block(x, (None,) * (x.dim() - 1) + ("model",), mesh,
                      coords).contiguous()
    out = {"coord": coords}
    for name, op in (("split", dist.gather_split),
                     ("from", dist.gather_from)):
        def loss(b):
            return (op(b, mesh, ("model",), -1, role="mtp_gather") * r).sum()
        b = blk.clone().requires_grad_(True)
        out[name] = torch.autograd.grad(loss(b), b)[0].numpy()
        if name == "split":
            def one(b, rr):
                return (op(b, mesh, ("model",), -1, role="mtp_gather")
                        * rr).sum()
            out["vmap"] = torch.func.vmap(torch.func.grad(one))(
                torch.stack([blk, 2 * blk]), torch.stack([r, 3 * r])
            ).numpy()
    return out


KINDS = {"serve": lambda case, mesh: _serve(case, mesh, dist.coords(mesh)),
         "round": run_round, "layer": run_layer,
         "gather_split": run_gather_split}


def run_rank(rank, world, in_path, out_dir):
    with open(in_path, "rb") as f:
        job = pickle.load(f)
    mesh = dist.make_mesh(*job["mesh"])
    out = {"coord": dist.coords(mesh), "cases": {}}
    for name, case in job["cases"].items():
        moe.CAPACITY_FACTOR = case.get("capacity", 1.25)
        out["cases"][name] = KINDS[case["kind"]](case, mesh)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


__all__ = ["MESH", "run_rank", "tp_config"]
