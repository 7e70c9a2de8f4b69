"""The rank worker of the sharded flat round's tensor-parallel tests (torch
only).

``tests/test_torch_flat_tp.py`` writes each case's inputs (the
reference's params as numpy, R rounds of (C, K, b, S) token batches,
the reference's scenario draws) to one pickle, starts 4 gloo CPU ranks
once with ``repro_torch.sharding.dist.spawn(run_rank, ...)`` over a
(data 2, model 2) mesh, and reads each rank's results back from
``rank<r>.pkl``. A case runs ``make_train_step``'s flat round on the
mesh under the training rules (``train_rules``; the batches cut to the
rank's rows by ``place_train_for_rank``), round after round: each
round's params (whole on every rank), the rank's EF21 slab, the metrics,
the collectives it recorded and the Δ-SGD launches; with ``fused`` also
the R rounds fused (``make_train_loop``) from the same start. This
module imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import torch

from repro_torch import interop
from repro_torch.compression import CompressionSpec
from repro_torch.configs import FLConfig, get_config
from repro_torch.core import flat as flatlib
from repro_torch.core import init_fl_state
from repro_torch.core.fed_loop import FlatFLState
from repro_torch.core.sharded import tp_slab
from repro_torch.federation import get_scenario
from repro_torch.kernels.delta_sgd import delta_sgd as tk
from repro_torch.launch.steps import (flat_train_collectives, make_train_loop,
                                      make_train_step, place_train_for_rank,
                                      train_rules)
from repro_torch.models.common import logical_rules
from repro_torch.models.model import build_model
from repro_torch.sharding import dist, hlo
from repro_torch.sharding.spec import get_federation_spec

MESH = ((2, 2), ("data", "model"))


def tp_config(arch: str, layers: int, d_model: int, vocab: int):
    return get_config(arch).reduced(num_layers=layers, d_model=d_model,
                                    vocab=vocab)


def _ops(ops):
    return [(c.kind, c.role, c.axes, c.shape, c.backward, c.dtype)
            for c in ops]


def _np(x):
    return interop._to_numpy(x) if isinstance(x, torch.Tensor) else x


def _parts(case, mesh):
    model = build_model(tp_config(*case["cfg"]))
    spec = get_federation_spec(case["federation"], mesh)
    params = interop.params_from_numpy(case["params"])
    rules = train_rules(model, mesh, params, spec=spec)
    fl = FLConfig(local_steps=case["K"], flat_engine=True)
    scn = case.get("scenario")
    if scn is not None:
        scn = get_scenario(scn[0], draws=interop.draws_from_numpy(
            case["draws"]), **scn[1])
    comp = case.get("compression")
    comp = CompressionSpec(**comp) if comp else None
    return model, spec, params, rules, fl, scn, comp


def _rank_batch(rules, batch, t):
    whole = interop.params_from_numpy({k: v[t] for k, v in batch.items()})
    return place_train_for_rank(rules, batch=whole)["batch"]


def run_round(case, mesh):
    model, spec, params, rules, fl, scn, comp = _parts(case, mesh)
    step, sopt, scn_r, comp_r = make_train_step(
        model, fl, flat=True, mesh=mesh, federation=spec, scenario=scn,
        compression=comp)
    C, R = case["C"], case["rounds"]
    state = init_fl_state(params, sopt, scn_r, comp_r, cohort=C, mesh=mesh,
                          federation=spec)
    out = {"coord": dict(rules.coords), "metrics": [], "ops": [],
           "launches": []}
    for t in range(R):
        batch = _rank_batch(rules, case["batch"], t)
        hlo.reset()
        tk.reset_launch_count()
        with logical_rules(rules):
            state, m = step(state, batch)
        out["metrics"].append({k: _np(v) for k, v in m.items()})
        out.setdefault("params_t", []).append(
            interop.params_to_numpy(state.params))
        if state.ef is not None:
            out.setdefault("ef_t", []).append(_np(state.ef))
        out["ops"].append(_ops(hlo.snapshot()))
        out["launches"].append(dict(tk.LAUNCHES))
    out["params"] = out["params_t"][-1]
    layout = flatlib.layout_of(params, shards=spec.flat_shards(mesh))
    slab = tp_slab(layout, mesh, spec, rules)
    out["slab"] = {"width": slab.width, "valid": slab.valid,
                   "gathered": slab.gathered, "chunk": slab.chunk(
                       C // spec.clients_on(mesh) if spec.client_axes
                       else C),
                   "N": layout.padded_size, "size": layout.size}
    out["want_ops"] = flat_train_collectives(
        model, rules, slab, local_steps=case["K"], clients=C,
        robust=(scn_r.robust_model.kind if scn_r is not None and (
            scn_r.faulty or scn_r.robust or scn_r.quorum > 0) else None))
    if case.get("fused"):
        loop, sopt, scn_l, comp_l = make_train_loop(
            model, fl, rounds_per_call=R, mesh=mesh, federation=spec,
            scenario=scn, compression=comp)
        st0 = init_fl_state(params, sopt, scn_l, comp_l, cohort=C,
                            mesh=mesh, federation=spec)
        carry = FlatFLState(flatlib.pack(params, loop.layout),
                            st0.server_state, 0, st0.buffer, st0.ef)
        batches = [_rank_batch(rules, case["batch"], t) for t in range(R)]
        stacked = {k: torch.stack([b[k] for b in batches])
                   for k in batches[0]}
        with logical_rules(rules):
            carry, mets = loop(carry, stacked)
        out["fused_P"] = _np(carry.P)
        out["host_P"] = _np(flatlib.pack(state.params, loop.layout))
        out["fused_metrics"] = {k: _np(v) for k, v in mets.items()}
    return out


def run_moon(case, mesh):
    """The paper's CNN under MOON on the sharded flat round with no
    training rules, round after round: each round's ``prev`` is the
    previous round's local params, the rank's (C_loc, N_loc) slab
    gathered over the N-shard axes. -> each round's params (whole on
    every rank) and metrics."""
    from repro_torch.configs.paper_tasks import CNN_PAPER
    from repro_torch.core import (get_client_opt, get_server_opt,
                                  make_fl_round, make_loss)
    from repro_torch.models.small import make_small_model, softmax_ce
    _, logits = make_small_model(CNN_PAPER)
    loss = make_loss(
        lambda q, bt: (softmax_ce(logits(q, bt["x"]), bt["y"]), {}),
        moon_mu=case["mu"], repr_fn=lambda q, bt: logits(q, bt["x"]))
    spec = get_federation_spec(case["federation"], mesh)
    sopt = get_server_opt("fedavg")
    rnd = make_fl_round(loss, get_client_opt("delta_sgd"), sopt,
                        num_rounds=10, flat=True, mesh=mesh, federation=spec)
    params = interop.params_from_numpy(case["params"])
    state = init_fl_state(params, sopt, cohort=case["C"], mesh=mesh,
                          federation=spec)
    layout = flatlib.layout_of(params, shards=spec.flat_shards(mesh))
    batches = interop.clients_local_from_numpy(case["batch"], mesh, spec,
                                               axis=1)
    out, prev = {"metrics": [], "params_t": []}, None
    for t in range(case["rounds"]):
        state, m, loc = rnd(state, {k: v[t] for k, v in batches.items()},
                            prev_local_params=prev)
        prev = flatlib.unpack_batched(dist.all_gather(
            loc, mesh, spec.flat_axes(mesh)[1], dim=1), layout)
        out["metrics"].append({k: _np(v) for k, v in m.items()})
        out["params_t"].append(interop.params_to_numpy(state.params))
    return out


KINDS = {"round": run_round, "moon": run_moon}


def run_rank(rank, world, in_path, out_dir):
    with open(in_path, "rb") as f:
        job = pickle.load(f)
    mesh = dist.make_mesh(*job["mesh"])
    out = {"coord": dist.coords(mesh), "cases": {}}
    for name, case in job["cases"].items():
        out["cases"][name] = KINDS[case["kind"]](case, mesh)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
