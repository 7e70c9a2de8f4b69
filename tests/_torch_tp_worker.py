"""The rank worker of the tensor-parallel serving tests (torch only).

``tests/test_torch_tp_serve.py`` writes each case's inputs (the
reference's params as numpy, prompts, teacher-forced tokens) to one
pickle, starts 4 gloo CPU ranks once with
``repro_torch.sharding.dist.spawn(run_rank, ...)`` over a (data 2,
model 2) mesh, and reads each rank's results back from
``rank<r>.pkl``. A case runs prefill and teacher-forced decode steps
(logits each step), then greedy decode from the same prefill (tokens
each step), recording each step's collectives. This module imports
neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      serve_collectives, serve_rules)
from repro_torch.models.common import logical_rules
from repro_torch.models.model import build_model
from repro_torch.sharding import dist, hlo
from repro_torch.sharding.spec import (get_federation_spec, local_block,
                                       serve_batch_shardings)
from repro_torch.utils.tree import tree_leaves

MESH = ((2, 2), ("data", "model"))


def tp_config(arch: str, layers: int, d_model: int, vocab: int):
    return get_config(arch).reduced(num_layers=layers, d_model=d_model,
                                    vocab=vocab)


def _ops(ops):
    return [(c.kind, c.role, c.axes, c.shape) for c in ops]


def _serve(case, mesh, coords):
    cfg = tp_config(*case["cfg"])
    model = build_model(cfg)
    spec = get_federation_spec(case["federation"], mesh)
    struct = interop.params_from_numpy(case["params"])
    rules = serve_rules(model, mesh, struct, spec=spec,
                        batch_size=case["prompts"].shape[0])
    params = interop.params_local_from_numpy(case["params"],
                                             rules.param_axes, mesh)
    axes = serve_batch_shardings(mesh, {"p": case["prompts"]})["p"]
    prompts = local_block(torch.from_numpy(case["prompts"]), axes, mesh,
                          coords)
    forced = local_block(torch.from_numpy(case["forced"]), axes, mesh,
                         coords)
    cache_len = case["prompts"].shape[1] + case["forced"].shape[1]
    prefill = make_prefill_step(model, cache_len=cache_len, rules=rules)
    res = {"coord": coords, "logits": [], "ops": [], "tokens": []}
    hlo.reset()
    logits, cache0 = prefill(params, {"tokens": prompts})
    res["ops"].append(_ops(hlo.snapshot()))
    res["logits"].append(logits[:, 0].numpy())
    cache = cache0
    for t in range(forced.shape[1]):
        hlo.reset()
        with logical_rules(rules):
            logits, cache = model.decode_step(params, cache,
                                              forced[:, t:t + 1])
        res["ops"].append(_ops(hlo.snapshot()))
        res["logits"].append(logits[:, 0].numpy())
    step = make_serve_step(model, rules=rules)
    tok = torch.argmax(torch.from_numpy(res["logits"][0]), -1)[:, None]
    cache = cache0
    for _ in range(case["greedy"]):
        res["tokens"].append(tok[:, 0].numpy())
        tok, cache = step(params, cache, tok)
    res["cache_rows"] = int(tree_leaves(cache["runs"]["run0"])[0].shape[1])
    if case.get("keep_cache"):
        # the greedy run's last cache (MLA: the latent every model rank
        # writes alike)
        res["cache"] = interop.params_to_numpy(cache["runs"])
    rows = prompts.shape[0]
    res["want_ops"] = {
        "prefill": serve_collectives(model, rules, rows, prompts.shape[1]),
        "decode": serve_collectives(model, rules, rows, 1)}
    return res


def run_rank(rank, world, in_path, out_dir):
    with open(in_path, "rb") as f:
        job = pickle.load(f)
    mesh = dist.make_mesh(*job["mesh"])
    coords = dist.coords(mesh)
    out = {"coord": coords, "cases": {}}
    for name, case in job["cases"].items():
        out["cases"][name] = _serve(case, mesh, coords)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
