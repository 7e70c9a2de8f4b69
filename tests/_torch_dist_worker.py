"""The rank worker of the port's sharded parity tests (torch only).

``tests/test_torch_sharded_round.py`` writes every case's inputs (numpy
arrays and the reference's scenario draws) to one pickle, starts the
ranks once with ``repro_torch.sharding.dist.spawn(run_rank, ...)`` and
reads each rank's results back from ``rank<r>.pkl``. This module imports
neither ``jax`` nor ``repro``, so a spawned rank never loads them.

Case kinds:
  step     ``flat_delta_sgd_step_sharded`` for 3 steps on the rank's
           blocks of global (C, N) slabs;
  round    ``make_fl_round(mesh=, federation=)`` for a few rounds, the
           rank's batches and EF21 slab cut by ``interop``;
  loop     ``make_fl_loop(block_sharded=True)`` against the per-round
           sharded host loop on the same inputs;
  refusals the sharded engine's refusals, as messages.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

from repro_torch import interop
from repro_torch.compression import CompressionSpec
from repro_torch.core import (flat, flat_delta_sgd_init, get_client_opt,
                              get_server_opt, init_fl_state, make_fl_loop,
                              make_fl_round, make_loss)
from repro_torch.core.delta_sgd import flat_delta_sgd_step_sharded
from repro_torch.core.fed_loop import FlatFLState
from repro_torch.federation import get_scenario
from repro_torch.kernels.delta_sgd import delta_sgd as tk
from repro_torch.sharding import dist, hlo
from repro_torch.sharding.spec import FederationSpec, get_federation_spec


def quad(params, batch):
    """The reference tests' quadratic problem: x f32, with an optional
    bf16 leaf e."""
    x32 = params["x"].to(torch.float32)
    if "e" not in params:
        r = batch["A"] @ x32 - batch["b"]
        return 0.5 * (r * r).mean(), {}
    e32 = params["e"].to(torch.float32)
    r = batch["A"] @ x32 - batch["b"] + e32.sum() * 0.01
    return 0.5 * (r * r).mean() + 0.05 * (e32 * e32).mean(), {}


def federation_of(name, mesh):
    if name == "clients_only":
        return FederationSpec(client_axes=("data", "model"), fsdp_axes=(),
                              tp_axes=())
    return get_federation_spec(name, mesh)


def _scenario(case):
    if case.get("scenario") is None:
        return None
    name, over = case["scenario"]
    return get_scenario(name, draws=interop.draws_from_numpy(case["draws"]),
                        **over)


def _np(x):
    if isinstance(x, torch.Tensor):
        return interop._to_numpy(x)
    return x


def _metrics_np(m):
    return {k: _np(v) for k, v in m.items()}


def _ops(ops):
    return [(c.kind, c.elems, c.axes, c.op, c.staged, c.shape, c.group_size)
            for c in ops]


def run_step(case, mesh):
    fed = federation_of(case["fed"], mesh)
    pspec = fed.flat_spec(mesh)
    gamma, delta, eta0, theta0 = case["hyper"]
    P = flat.local_slab(torch.from_numpy(case["P0"]), mesh, fed)
    mask = case.get("mask")
    if mask is not None:
        mask = flat.local_slab(torch.from_numpy(mask), mesh, fed)
    C, N = case["P0"].shape
    layout = flat.FlatLayout(None, (), N, N, fed.flat_shards(mesh))
    S = flat_delta_sgd_init(C, layout, eta0=eta0, theta0=theta0,
                            mesh=mesh, federation=fed)
    hlo.reset()
    tk.reset_launch_count()
    for G in case["Gs"]:
        G = flat.local_slab(torch.from_numpy(G), mesh, fed)
        P, S = flat_delta_sgd_step_sharded(
            P, G, S, gamma=gamma, delta=delta, eta0=eta0, mesh=mesh,
            pspec=pspec, mask=mask)
    return {"P": P.numpy(), "eta": S.eta.numpy(), "ops": _ops(hlo.snapshot()),
            "launches": dict(tk.LAUNCHES)}


def _setup(case, mesh):
    fed = federation_of(case["fed"], mesh)
    scn = _scenario(case)
    comp = (CompressionSpec(**case["compression"])
            if case.get("compression") else None)
    loss = make_loss(quad)
    copt, sopt = get_client_opt("delta_sgd"), get_server_opt("fedavg")
    params = interop.params_from_numpy(case["params"])
    state = init_fl_state(params, sopt, scn, compression=comp,
                          cohort=case["C"], mesh=mesh, federation=fed)
    return fed, scn, comp, loss, copt, sopt, state


def run_round(case, mesh):
    fed, scn, comp, loss, copt, sopt, state = _setup(case, mesh)
    rnd = make_fl_round(loss, copt, sopt, num_rounds=10, flat=True,
                        mesh=mesh, federation=fed, scenario=scn,
                        num_clients=case.get("num_clients"),
                        compression=comp, telemetry=case.get("telemetry"))
    batches = interop.clients_local_from_numpy(case["batches"], mesh, fed,
                                               axis=1)
    mets, ops = [], []
    for t in range(case["rounds"]):
        hlo.reset()
        state, m, loc = rnd(state, {k: v[t] for k, v in batches.items()})
        mets.append(_metrics_np(m))
        ops.append(_ops(hlo.snapshot()))
    return {"params": interop.params_to_numpy(state.params),
            "ef": None if state.ef is None else state.ef.numpy(),
            "loc": loc.numpy(), "metrics": mets, "ops": ops}


def run_loop(case, mesh):
    """The block path and the per-round sharded host loop from the same
    state: their states, metrics and the block's collectives."""
    fed, scn, comp, loss, copt, sopt, state0 = _setup(case, mesh)
    batches = interop.clients_local_from_numpy(case["batches"], mesh, fed,
                                               axis=1)
    R = case["rounds"]
    kw = dict(num_rounds=10, flat=True, mesh=mesh, federation=fed,
              scenario=scn, num_clients=case.get("num_clients"),
              compression=comp, telemetry=case.get("telemetry"))
    loop = make_fl_loop(loss, copt, sopt, params_like=state0.params,
                        rounds_per_call=R, block_sharded=True, **kw)
    fst = FlatFLState(flat.pack(state0.params, loop.layout),
                      state0.server_state, 0, state0.buffer, state0.ef)
    hlo.reset()
    tk.reset_launch_count()
    fst, fmets = loop(fst, batches)
    block_ops = _ops(hlo.snapshot())
    launches = dict(tk.LAUNCHES)
    rnd = make_fl_round(loss, copt, sopt, **kw)
    st, hmets = state0, []
    for t in range(R):
        st, m, _ = rnd(st, {k: v[t] for k, v in batches.items()})
        hmets.append(_metrics_np(m))
    return {"block_P": fst.P.numpy(),
            "block_ef": None if fst.ef is None else fst.ef.numpy(),
            "block_metrics": _metrics_np(fmets), "block_ops": block_ops,
            "launches": launches,
            "host_P": flat.pack(st.params, loop.layout).numpy(),
            "host_ef": None if st.ef is None else st.ef.numpy(),
            "host_metrics": hmets,
            "params": interop.params_to_numpy(
                flat.unpack(fst.P, loop.layout))}


def _message(fn):
    try:
        fn()
    except (ValueError, KeyError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def run_refusals(case, mesh):
    loss = make_loss(quad)
    copt, sopt = get_client_opt("delta_sgd"), get_server_opt("fedavg")
    params = interop.params_from_numpy(case["params"])
    cd = get_federation_spec("cross_device", mesh)
    out = {}
    out["block_without_mesh"] = _message(lambda: make_fl_loop(
        loss, copt, sopt, params_like=params, num_rounds=10,
        block_sharded=True))
    out["block_flat_shards"] = _message(lambda: make_fl_loop(
        loss, copt, sopt, params_like=params, num_rounds=10, mesh=mesh,
        federation=cd, block_sharded=True))
    out["block_robust"] = _message(lambda: make_fl_loop(
        loss, copt, sopt, params_like=params, num_rounds=10, mesh=mesh,
        federation=federation_of("clients_only", mesh), block_sharded=True,
        scenario=get_scenario("sync_iid", robust_agg="trimmed")))
    out["mesh_without_federation"] = _message(lambda: make_fl_round(
        loss, copt, sopt, num_rounds=10, flat=True, mesh=mesh))
    out["mesh_vmap_engine"] = _message(lambda: make_fl_round(
        loss, copt, sopt, num_rounds=10, mesh=mesh, federation=cd))
    rnd = make_fl_round(loss, copt, sopt, num_rounds=10, flat=True,
                        mesh=mesh, federation=cd)
    layout = flat.layout_of(params, shards=cd.flat_shards(mesh))
    fst = FlatFLState(flat.pack(params, layout), sopt.init(params), 0)
    batches = {k: torch.from_numpy(v[0][:4])
               for k, v in case["batches"].items()}
    out["eta0_c_under_mesh"] = _message(lambda: rnd.flat_body(
        fst, batches, layout, eta0_c=torch.ones(8)))
    out["layout_shards"] = _message(lambda: rnd.flat_body(
        fst, batches, flat.layout_of(params), gp=params))
    out["cohort_split"] = _message(lambda: init_fl_state(
        params, sopt, compression=CompressionSpec(kind="int8",
                                                  error_feedback=True),
        cohort=7, mesh=mesh, federation=cd))
    return out


KINDS = {"step": run_step, "round": run_round, "loop": run_loop,
         "refusals": run_refusals}


def run_rank(rank, world, in_path, out_dir):
    """Every case on this rank; results to ``out_dir/rank<rank>.pkl``."""
    with open(in_path, "rb") as f:
        spec = pickle.load(f)
    mesh = dist.make_mesh(*spec["mesh"])
    coord = tuple(dist.coords(mesh)[a] for a in mesh.mesh_dim_names)
    out = {"coord": coord, "cases": {}}
    for name, case in spec["cases"].items():
        out["cases"][name] = KINDS[case["kind"]](case, mesh)
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def run_card_step(rank, world, out_dir):
    """``flat_delta_sgd_step_sharded`` on the card over a (data 1, model
    world) mesh, twice from the same inputs: the rank's slab after 3
    steps of each run, the η lanes, the launches on the card and the
    recorded collectives (the card test in ``test_torch_cuda.py``)."""
    dev = dist.runtime().device
    mesh = dist.make_mesh((1, world), ("data", "model"))
    fed = get_federation_spec("cross_device", mesh)
    C, N = 4, 128 * 1024 * world
    rng = np.random.default_rng(0)
    P0 = torch.from_numpy(rng.normal(size=(C, N)).astype(np.float32))
    Gs = [torch.from_numpy(rng.normal(size=(C, N)).astype(np.float32))
          for _ in range(3)]
    layout = flat.FlatLayout(None, (), N, N, world)
    runs = []
    tk.reset_launch_count()
    hlo.reset()
    for _ in range(2):
        P = flat.local_slab(P0, mesh, fed).to(dev)
        S = flat_delta_sgd_init(C, layout, eta0=0.2, theta0=1.0, device=dev,
                                mesh=mesh, federation=fed)
        for G in Gs:
            P, S = flat_delta_sgd_step_sharded(
                P, flat.local_slab(G, mesh, fed).to(dev), S, gamma=2.0,
                delta=0.1, eta0=0.2, mesh=mesh, pspec=fed.flat_spec(mesh))
        runs.append((P.cpu().numpy(), S.eta.cpu().numpy()))
    out = {"runs": runs, "launches": tk.LAUNCHES.get(("batched_norms",
                                                      "cuda"), 0)
           + tk.LAUNCHES.get(("batched_apply", "cuda"), 0),
           "ops": _ops(hlo.snapshot()), "backend": dist.runtime().backend,
           "P0": P0.numpy(), "Gs": [g.numpy() for g in Gs]}
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
