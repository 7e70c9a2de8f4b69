"""The rank worker of the tensor-parallel training tests (torch only).

``tests/test_torch_tp_train.py`` writes each case's inputs (the
reference's params as numpy, a round's (C, K, b, S) token batches) to
one pickle, starts 4 gloo CPU ranks once with
``repro_torch.sharding.dist.spawn(run_rank, ...)`` over a (data 2,
model 2) mesh, and reads each rank's results back from ``rank<r>.pkl``.
A case cuts the reference's whole ``FLState`` and batches to the rank's
blocks (``interop.train_local_from_numpy``) and runs
``make_train_step``'s round under the training rules: the rank's round-end params, the
metrics, the collectives it recorded and the Δ-SGD launches. Refusal
cases return the messages. This module imports neither ``jax`` nor
``repro``.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import torch

from repro_torch import interop
from repro_torch.configs import FLConfig, get_config
from repro_torch.core import init_fl_state
from repro_torch.federation import get_scenario
from repro_torch.kernels.delta_sgd import delta_sgd as tk
from repro_torch.launch.steps import (make_train_step, place_train_for_rank,
                                      train_collectives, train_rules)
from repro_torch.models.common import logical_rules
from repro_torch.models.model import build_model
from repro_torch.sharding import dist, hlo
from repro_torch.sharding.spec import get_federation_spec

MESH = ((2, 2), ("data", "model"))


def tp_config(arch: str, layers: int, d_model: int, vocab: int):
    return get_config(arch).reduced(num_layers=layers, d_model=d_model,
                                    vocab=vocab)


def _ops(ops):
    return [(c.kind, c.role, c.axes, c.shape, c.backward) for c in ops]


def _np(x):
    return interop._to_numpy(x) if isinstance(x, torch.Tensor) else x


def run_round(case, mesh):
    cfg = tp_config(*case["cfg"])
    model = build_model(cfg)
    spec = get_federation_spec(case["federation"], mesh)
    params = interop.params_from_numpy(case["params"])
    rules = train_rules(model, mesh, params, spec=spec)
    fl = FLConfig(local_steps=case["K"], **case.get("fl", {}))
    scn = case.get("scenario")
    if scn is not None:
        scn = get_scenario(scn, draws=interop.draws_from_numpy(
            case["draws"]))
    step, sopt, scn, comp = make_train_step(
        model, fl, remat=case["remat"], use_pallas=case["use_pallas"],
        scenario=scn)
    # the reference's initial FLState and batches, cut to the rank's
    # blocks
    loc = interop.train_local_from_numpy(rules, state=case["state"],
                                         batch=case["batch"])
    hlo.reset()
    tk.reset_launch_count()
    with logical_rules(rules):
        new, metrics = step(loc["state"], loc["batch"])
    return {"coord": dict(rules.coords),
            "params": interop.params_to_numpy(new.params),
            "axes": rules.param_axes,
            "metrics": {k: _np(v) for k, v in metrics.items()},
            "ops": _ops(hlo.snapshot()),
            "launches": dict(tk.LAUNCHES),
            "want_ops": train_collectives(model, rules,
                                          local_steps=case["K"],
                                          remat=case["remat"])}


def _message(fn):
    try:
        fn()
    except (ValueError, KeyError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def run_refusals(case, mesh):
    """The refusals of tensor-parallel training, as messages."""
    out = {}
    for arch in case["archs"]:
        model = build_model(tp_config(arch, 2, 64, 512))
        params = model.init(torch.Generator().manual_seed(0))
        out[arch] = _message(lambda: train_rules(model, mesh, params))
    tl = build_model(tp_config("tinyllama-1.1b", 2, 64, 512))
    params = tl.init(torch.Generator().manual_seed(0))
    rules = train_rules(tl, mesh, params,
                        spec=get_federation_spec("cross_device", mesh))
    loc = place_train_for_rank(rules, params=params)["params"]
    tokens = torch.zeros((2, 8), dtype=torch.long)
    with logical_rules(rules):
        out["prefill"] = _message(lambda: tl.prefill(loc,
                                                     {"tokens": tokens}))
    for name, kw in case["fl"].items():
        fl = FLConfig(local_steps=2, **kw)
        out[name] = _message(lambda: _round_under(tl, fl, rules, params))
    return out


def _round_under(model, fl, rules, params):
    step, sopt, scn, comp = make_train_step(model, fl)
    state = init_fl_state(params, sopt, scn, comp, cohort=2)
    tokens = torch.zeros((2, 2, 2, 8), dtype=torch.long)
    loc = place_train_for_rank(rules, state=state,
                               batch={"tokens": tokens, "labels": tokens})
    with logical_rules(rules):
        step(loc["state"], loc["batch"])


KINDS = {"round": run_round, "refusals": run_refusals}


def run_rank(rank, world, in_path, out_dir):
    with open(in_path, "rb") as f:
        job = pickle.load(f)
    mesh = dist.make_mesh(*job["mesh"])
    out = {"coord": dist.coords(mesh), "cases": {}}
    for name, case in job["cases"].items():
        out["cases"][name] = KINDS[case["kind"]](case, mesh)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
