"""The rank worker of the tensor-parallel tests of Zamba2, Whisper,
InternVL2 and xLSTM, and of the decode on a cache cut over ``model``
(torch only).

``tests/test_torch_tp_hybrid.py``, ``tests/test_torch_tp_enc.py``,
``tests/test_torch_tp_xlstm.py`` and ``tests/test_torch_seq_decode.py``
write each case's inputs to one pickle, start 4 gloo CPU ranks once
with ``repro_torch.sharding.dist.spawn(run_rank, ...)`` over a (data 2,
model 2) mesh, and read each rank's results back from ``rank<r>.pkl``.
The kinds:

  * ``serve``: prefill of prompts with their stub-frontend extras
    (Whisper's ``frames``, InternVL2's ``image_embeds``, placed with the
    batch by ``place_for_rank``), teacher-forced decode steps (logits
    each step), greedy decode from the same prefill (tokens each step),
    each step's collectives; the prefill's cache; and, given a whole
    cache (``whole_cache``), the same forced steps from that cache
    placed by ``place_for_rank(cache=)``. With ``narrow`` the decode
    starts from the prefill's cache narrowed to the rank's block
    (``place_prefill_cache``: at one data rank, an xLSTM state's heads
    or units);
  * ``cut_decode``: teacher-forced decode steps (logits, collectives
    and their derivation each step) from a cache whose placement cuts
    its time dim over ``model``: a prefill's (``how="prefill"``, with
    ``window``) narrowed by ``place_prefill_cache``, a whole cache
    placed by ``place_for_rank`` (``"place_for_rank"``), or an empty
    one from ``init_cache`` under the rules (``"init_cache"``, int8
    with ``quant``); the cache's shapes and its blocks at the end;
  * ``round``: one vmap round under training rules
    (``tests/_torch_tp_train_worker.py``'s);
  * ``grad``: the gradients of the mean cross-entropy of one batch with
    respect to the rank's params under training rules, plain autograd.

A case may name its own mesh (``mesh``: (shape, axes)); every rank
makes each mesh once, in the cases' order.

This module imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import torch

from repro_torch import interop
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      place_for_rank, place_prefill_cache,
                                      place_train_for_rank,
                                      serve_collectives, serve_rules,
                                      train_rules)
from repro_torch.models.common import logical_rules
from repro_torch.models.model import build_model
from repro_torch.sharding import dist, hlo
from repro_torch.sharding.spec import get_federation_spec
from repro_torch.utils.tree import tree_flatten, tree_unflatten

from _torch_tp_train_worker import run_round, tp_config
from _torch_tp_worker import MESH, _ops


def _batch(case):
    """The whole prompt batch: tokens and the extras, as tensors."""
    batch = {"tokens": case["prompts"]}
    batch.update(case.get("extras", {}))
    return interop.params_from_numpy(batch)


def _forced(model, params, cache, forced, rules, res, key):
    """Teacher-forced decode steps from ``cache``: logits (and, for the
    prefill's cache, the collectives) each step."""
    for t in range(forced.shape[1]):
        hlo.reset()
        with logical_rules(rules):
            logits, cache = model.decode_step(params, cache,
                                              forced[:, t:t + 1])
        res[key].append(logits[:, 0].numpy())
        if key == "logits":
            res["ops"].append(_ops(hlo.snapshot()))


def run_serve(case, mesh):
    cfg = tp_config(*case["cfg"])
    model = build_model(cfg)
    spec = get_federation_spec(case["federation"], mesh)
    B = case["prompts"].shape[0]
    rules = serve_rules(model, mesh, interop.params_from_numpy(
        case["params"]), spec=spec, batch_size=B)
    params = interop.params_local_from_numpy(case["params"],
                                             rules.param_axes, mesh)
    batch = place_for_rank(rules, batch=_batch(case))["batch"]
    forced = place_for_rank(rules, batch={"f": torch.from_numpy(
        case["forced"])})["batch"]["f"]
    cache_len = case["prompts"].shape[1] + cfg.num_image_tokens \
        + case["forced"].shape[1]
    res = {"coord": dict(rules.coords), "logits": [], "ops": [],
           "tokens": [], "placed_logits": []}
    hlo.reset()
    logits, cache0 = make_prefill_step(model, cache_len=cache_len,
                                       rules=rules)(params, batch)
    res["ops"].append(_ops(hlo.snapshot()))
    res["logits"].append(logits[:, 0].numpy())
    if case.get("narrow"):
        cache0 = place_prefill_cache(rules, cache0, B)
    _forced(model, params, cache0, forced, rules, res, "logits")
    step = make_serve_step(model, rules=rules)
    tok, cache = torch.argmax(logits, -1), cache0
    for _ in range(case["greedy"]):
        res["tokens"].append(tok[:, 0].numpy())
        tok, cache = step(params, cache, tok)
    res["cache"] = interop.params_to_numpy(
        {k: v for k, v in cache0.items() if k in ("runs", "enc_kv")})
    if "whole_cache" in case:
        placed = place_for_rank(
            rules, cache=interop.params_from_numpy(case["whole_cache"]),
            batch_size=B)["cache"]
        res["placed_shapes"] = {"/".join(p): tuple(x.shape) for p, x in
                                zip(tree_flatten(placed)[1],
                                    tree_flatten(placed)[0])}
        _forced(model, params, placed, forced, rules, res, "placed_logits")
    rows = batch["tokens"].shape[0]
    res["want_ops"] = {
        "prefill": serve_collectives(model, rules, rows,
                                     batch["tokens"].shape[1]),
        "decode": serve_collectives(model, rules, rows, 1, cache=cache0)}
    return res


def _shapes(tree):
    leaves, paths = tree_flatten(tree)
    return {"/".join(p): tuple(x.shape) for p, x in zip(paths, leaves)}


def run_cut_decode(case, mesh):
    cfg = tp_config(*case["cfg"])
    model = build_model(cfg)
    spec = get_federation_spec(case["federation"], mesh)
    B = case["forced"].shape[0]
    rules = serve_rules(model, mesh, interop.params_from_numpy(
        case["params"]), spec=spec, batch_size=B)
    params = interop.params_local_from_numpy(case["params"],
                                             rules.param_axes, mesh)
    forced = place_for_rank(rules, batch={"f": torch.from_numpy(
        case["forced"])})["batch"]["f"]
    window, how = case.get("window"), case["how"]
    res = {"coord": dict(rules.coords), "logits": [], "ops": [],
           "want_ops": []}
    if how == "prefill":
        batch = place_for_rank(rules, batch=_batch(case))["batch"]
        logits, cache = make_prefill_step(
            model, cache_len=case["cache_len"], window=window,
            rules=rules)(params, batch)
        res["logits"].append(logits[:, 0].numpy())
        res["prefill_shapes"] = _shapes(cache)
        cache = place_prefill_cache(rules, cache, B)
    elif how == "place_for_rank":
        cache = place_for_rank(rules, cache=interop.params_from_numpy(
            case["whole_cache"]), batch_size=B)["cache"]
    else:
        with logical_rules(rules):
            cache = model.init_cache(B, case["cache_len"], device="cpu",
                                     quant_kv=case.get("quant", False))
    res["shapes"] = _shapes(cache)
    for t in range(forced.shape[1]):
        hlo.reset()
        with logical_rules(rules):
            logits, cache = model.decode_step(params, cache,
                                              forced[:, t:t + 1],
                                              window=window)
        res["ops"].append(_ops(hlo.snapshot()))
        res["want_ops"].append(serve_collectives(model, rules, B, 1,
                                                 cache=cache))
        res["logits"].append(logits[:, 0].numpy())
    res["cache"] = interop.params_to_numpy(
        {k: v for k, v in cache.items() if k in ("runs", "enc_kv")})
    return res


def run_grad(case, mesh):
    """∂ mean CE / ∂ (the rank's params) of one batch under the training
    rules of ``cross_device`` (the rows whole on each rank)."""
    cfg = tp_config(*case["cfg"])
    model = build_model(cfg)
    whole = interop.params_from_numpy(case["params"])
    rules = train_rules(model, mesh, whole, spec=get_federation_spec(
        "cross_device", mesh))
    loc = place_train_for_rank(rules, params=whole)["params"]
    leaves, treedef = tree_flatten(loc)
    leaves = [x.requires_grad_(True) for x in leaves]
    batch = interop.params_from_numpy(case["batch"])
    hlo.reset()
    with logical_rules(rules):
        loss, _ = model.loss(tree_unflatten(treedef, leaves), batch,
                             use_pallas=False)
        grads = torch.autograd.grad(loss, leaves)
    return {"coord": dict(rules.coords), "loss": float(loss.detach()),
            "grads": interop.params_to_numpy(tree_unflatten(treedef,
                                                            list(grads))),
            "axes": rules.param_axes, "ops": _ops(hlo.snapshot())}


KINDS = {"serve": run_serve, "round": run_round, "grad": run_grad,
         "cut_decode": run_cut_decode}


def run_rank(rank, world, in_path, out_dir):
    with open(in_path, "rb") as f:
        job = pickle.load(f)
    meshes = {job["mesh"]: dist.make_mesh(*job["mesh"])}
    for case in job["cases"].values():   # every rank makes them in order
        shape = case.get("mesh", job["mesh"])
        if shape not in meshes:
            meshes[shape] = dist.make_mesh(*shape)
    out = {"coord": dist.coords(meshes[job["mesh"]]), "cases": {}}
    for name, case in job["cases"].items():
        mesh = meshes[case.get("mesh", job["mesh"])]
        out["cases"][name] = KINDS[case["kind"]](case, mesh)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


__all__ = ["MESH", "run_rank", "tp_config"]
