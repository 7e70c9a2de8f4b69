"""Port parity for the vmap engine (``make_fl_round(flat=False)``).

Live reference rounds (``repro.core.make_fl_round``, jitted as its CLI
jits it) against the port's, 3 rounds each on a small MLP federation,
with the reference's initial params, batches, client weights and
scenario draws injected: every client optimizer under FedAvg, Δ-SGD
under every server optimizer, weighted aggregation with variable client
sizes (on the vmap and the flat engine), heterogeneous K, FedProx, MOON
with the previous local params fed back, groupwise Δ-SGD, the kernel
route (the reference's ``use_pallas`` in interpret mode) and telemetry.
Per-round metrics, the round-end local params and the final params agree
within 1e-5 relative; counts and cohort fractions are exact. Then the
reference's refusals, and the CLI on the CPU.

The reference runs under ``jax.threefry_partitionable(False)`` (ROADMAP
C: the installed jax's PRNG default differs from the one its fixtures
were recorded with); the harness injects every random draw anyway.
"""
import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_tasks import MLP_SMALL
from repro.core import get_client_opt as r_copt
from repro.core import get_server_opt as r_sopt
from repro.core import init_fl_state as r_init
from repro.core import make_fl_loop as r_loop
from repro.core import make_fl_round as r_round
from repro.core import make_loss as r_make_loss
from repro.data.pipeline import FederatedDataset as RFed
from repro.data.synthetic import get_task as r_task
from repro.federation import get_scenario as r_scenario
from repro.models.small import make_small_model as r_model
from repro.models.small import softmax_ce as r_ce
from repro_torch import interop
from repro_torch.configs import paper_tasks as tcfg
from repro_torch.core import (get_client_opt, get_server_opt, init_fl_state,
                              make_fl_loop, make_fl_round, make_loss)
from repro_torch.federation import get_scenario
from repro_torch.kernels.delta_sgd import delta_sgd as tk
from repro_torch.launch import train as ttrain
from repro_torch.models.small import make_small_model
from repro_torch.models.small import softmax_ce
from repro_torch.utils.tree import tree_leaves, tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one CPU thread while this module runs: eight threads a
    worker contend with the other test workers and with XLA's pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
CLIENTS, BATCH, K, SEED, ALPHA, R, PART = 20, 8, 3, 7, 0.5, 3, 0.2
C = 4                                       # cohort_size(0.2, 20)
# the GRIDS' middle step sizes (benchmarks/fl_common.py)
LRS = {"sgd": 0.05, "sgd_decay": 0.05, "sgdm": 0.05, "sgdm_decay": 0.05,
       "adam": 0.01, "adagrad": 0.01}
FLOAT = ("loss", "loss_last_step", "eta_mean", "eta_min", "eta_max")
EXACT = ("k_eff_mean", "k_eff_min", "k_eff_max", "cohort_ids", "eta_hist")

# case -> fields of the run (defaults in _case)
CASES = {f"{name}_fedavg": dict(copt=name) for name in
         ("sgd", "sgd_decay", "sgdm", "sgdm_decay", "adam", "adagrad",
          "sps", "delta_sgd")}
CASES.update({f"delta_sgd_{s}": dict(sopt=s)
              for s in ("fedavgm", "fedadam", "fedyogi")})
CASES.update({
    "weighted_vmap": dict(weighted=True),
    "weighted_flat": dict(weighted=True, flat=True),
    "hetero_delta_sgd": dict(scenario="dirichlet_stragglers"),
    "hetero_adam": dict(copt="adam", scenario="dirichlet_stragglers"),
    "fedprox": dict(fedprox=0.01),
    "moon": dict(moon=1.0),
    "moon_flat": dict(moon=1.0, flat=True),
    "groupwise": dict(copt_kw=dict(groupwise=True)),
    "kernel_route": dict(copt_kw=dict(use_pallas=True)),
    "telemetry_sgd": dict(copt="sgd", telemetry=True),
    "telemetry_delta_sgd": dict(telemetry=True),
    # round_frac at (T, t) = (82, 41) is 0.49999997 in the reference's
    # jitted round: the (↓) scale is still 1.0 there, where 41/82 = 0.5
    # would give 0.1
    "decay_threshold": dict(copt="sgd_decay", num_rounds=82, round0=41),
})


def _case(name):
    c = dict(copt="delta_sgd", copt_kw={}, sopt="fedavg", scenario=None,
             weighted=False, flat=False, fedprox=0.0, moon=0.0,
             telemetry=False, num_rounds=10, round0=0)
    c.update(CASES[name])
    if c["copt"] in LRS:
        c["copt_kw"] = dict(c["copt_kw"], lr=LRS[c["copt"]])
    return c


def _ce(logits_fn, ce):
    return lambda q, bt: (ce(logits_fn(q, bt["x"]), bt["y"]), {})


def _r_repr(q, bt):
    return jax.nn.relu(bt["x"] @ q["l0"]["w"] + q["l0"]["b"])


def _t_repr(q, bt):
    return torch.relu(bt["x"] @ q["l0"]["w"] + q["l0"]["b"])


def _sizes(c):
    """Variable client sizes for the weighted cases, as table3 draws
    them (benchmarks/fl_common.py), cut to this federation."""
    if not c["weighted"]:
        return None
    return np.random.default_rng(SEED + 5).integers(40, 161, CLIENTS)


@lru_cache(maxsize=None)
def _reference(name):
    """Live reference rounds -> (initial params, per-round inputs,
    per-round metrics, per-round local params, final FLState), numpy."""
    with jax.threefry_partitionable(False):
        return _reference_run(_case(name))


def _reference_run(c):
    scn = (r_scenario(c["scenario"], seed=SEED) if c["scenario"]
           else None)
    fed = RFed.build(r_task("easy", seed=SEED), num_clients=CLIENTS,
                     alpha=ALPHA, seed=SEED, scenario=scn,
                     variable_sizes=_sizes(c))
    init_fn, logits_fn = r_model(MLP_SMALL)
    params = init_fn(jax.random.key(SEED))
    loss = r_make_loss(_ce(logits_fn, r_ce), fedprox_mu=c["fedprox"],
                       moon_mu=c["moon"], repr_fn=_r_repr)
    sopt = r_sopt(c["sopt"])
    round_fn = jax.jit(r_round(
        loss, r_copt(c["copt"], **c["copt_kw"]), sopt,
        num_rounds=c["num_rounds"], weighted=c["weighted"],
        flat="xla" if c["flat"] else False, scenario=scn,
        num_clients=CLIENTS if scn else None,
        client_sizes=fed.client_sizes() if scn else None,
        telemetry=c["telemetry"]))
    state = r_init(params, sopt, scn)
    state = state._replace(round=jnp.asarray(c["round0"], jnp.int32))
    inputs, mets, locals_, prev = [], [], [], None
    for t in range(c["round0"], c["round0"] + R):
        batches, w, ids = fed.sample_round(PART, K, BATCH, round_idx=t)
        draws = {"cohort_ids": ids}
        if scn is not None:
            draws["step_counts"] = np.asarray(
                scn.draw_step_counts(t, C, K))
        state, m, new_locals = round_fn(
            state, jax.tree.map(jnp.asarray, batches),
            client_weights=jnp.asarray(w) if c["weighted"] else None,
            prev_local_params=prev)
        if c["moon"]:
            prev = new_locals
        inputs.append((batches, w, draws))
        mets.append(jax.device_get(m))
        locals_.append(jax.device_get(new_locals))
    return (jax.device_get(params), inputs, mets, locals_,
            jax.device_get(state))


def _port(name):
    """The port's rounds on the reference's inputs -> (metrics, local
    params, final FLState, Δ-SGD kernel launches a round)."""
    c = _case(name)
    params0, inputs, _, _, _ = _reference(name)
    scn = (get_scenario(c["scenario"], seed=SEED,
                        draws=interop.draws_from_numpy(
                            {c["round0"] + t: d for t, (_, _, d)
                             in enumerate(inputs)}))
           if c["scenario"] else None)
    _, logits_fn = make_small_model(tcfg.MLP_SMALL)
    loss = make_loss(_ce(logits_fn, softmax_ce), fedprox_mu=c["fedprox"],
                     moon_mu=c["moon"], repr_fn=_t_repr)
    sopt = get_server_opt(c["sopt"])
    sizes = None
    if scn is not None:
        sizes = RFed.build(r_task("easy", seed=SEED), num_clients=CLIENTS,
                           alpha=ALPHA, seed=SEED, scenario=r_scenario(
                               c["scenario"], seed=SEED)).client_sizes()
    round_fn = make_fl_round(
        loss, get_client_opt(c["copt"], **c["copt_kw"]), sopt,
        num_rounds=c["num_rounds"], weighted=c["weighted"],
        flat=c["flat"], scenario=scn, num_clients=CLIENTS if scn else None,
        client_sizes=sizes, telemetry=c["telemetry"])
    state = init_fl_state(interop.params_from_numpy(params0), sopt, scn)
    state = state._replace(round=c["round0"])
    mets, locals_, launches, prev = [], [], [], None
    for batches, w, _ in inputs:
        tk.reset_launch_count()
        state, m, new_locals = round_fn(
            state, {k: torch.from_numpy(v) for k, v in batches.items()},
            client_weights=torch.from_numpy(w) if c["weighted"] else None,
            prev_local_params=prev)
        launches.append(dict(tk.LAUNCHES))
        if c["moon"]:
            prev = new_locals
        mets.append(m)
        locals_.append(new_locals)
    return mets, locals_, state, launches


def _close(got, want, err):
    """Within 1e-5 relative: of each value for a scalar, of the tensor's
    largest magnitude for a tensor. Adam, Adagrad and SPS divide by
    gradient magnitudes, so an element whose gradient cancels to near
    zero (where XLA's and torch's sum orders differ most) moves by up to
    1e-5 of the leaf's scale, not of its own value."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.nanmax(np.abs(want)) if want.ndim else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=max(1e-7, 1e-5 * scale), err_msg=err)


@pytest.mark.parametrize("name", sorted(CASES))
def test_vmap_engine_matches_a_live_reference_run(name):
    c = _case(name)
    _, _, rmets, rlocals, rfinal = _reference(name)
    mets, locals_, state, launches = _port(name)
    for t, (m, rm) in enumerate(zip(mets, rmets)):
        assert set(m) == set(rm), (t, sorted(m), sorted(rm))
        for k in m:
            got = m[k].numpy()
            if k in EXACT:
                np.testing.assert_array_equal(got, np.asarray(rm[k]),
                                              err_msg=f"round {t} {k}")
            else:
                _close(got, rm[k], f"round {t} {k}")
        for a, b in zip(jax.tree_util.tree_leaves(rlocals[t]),
                        tree_leaves(locals_[t])):
            assert tuple(b.shape) == a.shape
            _close(b.numpy(), a, f"round {t} local params")
    for a, b in zip(jax.tree_util.tree_leaves(rfinal.params),
                    tree_leaves(state.params)):
        _close(b.numpy(), a, "final params")
    for a, b in zip(jax.tree_util.tree_leaves(rfinal.server_state),
                    tree_leaves(state.server_state)):
        _close(b.numpy(), a, "server state")
    assert state.round == c["round0"] + R
    want = ({("batched_norms", "cpu"): K, ("batched_apply", "cpu"): K}
            if c["copt_kw"].get("use_pallas") or c["flat"] else {})
    assert all(n == want for n in launches), launches
    if not (c["copt"] == "delta_sgd" and not c["copt_kw"].get("groupwise")):
        assert all(np.isnan(m["eta_mean"].item()) for m in mets)
    if c["telemetry"] and c["copt"] == "sgd":
        assert all(not m["eta_hist"].any() for m in mets)


def test_decay_threshold_case_sits_on_a_flip():
    """The decay_threshold case tests what it says: the reference's
    round_frac there is below 0.5, while the true quotient is not."""
    rf = jax.jit(lambda r: r.astype(jnp.float32) / 82)(
        jnp.asarray(41, jnp.int32))
    assert float(rf) < 0.5 <= np.float32(41) / np.float32(82)


def test_vmap_engine_refuses_what_the_reference_refuses():
    loss = make_loss(lambda q, bt: (q["x"].sum(), {}))
    rloss = r_make_loss(lambda q, bt: (q["x"].sum(), {}))
    cases = [dict(scenario="dirichlet_dropouts"),
             dict(scenario="sync_iid", over=dict(robust_agg="trimmed")),
             dict(scenario="sync_iid", over=dict(quorum=2)),
             dict(compression="int8")]
    for case in cases:
        over = case.get("over", {})
        kw, rkw = {}, {}
        if "scenario" in case:
            kw["scenario"] = get_scenario(case["scenario"], **over)
            rkw["scenario"] = r_scenario(case["scenario"], **over)
        if "compression" in case:
            kw["compression"] = rkw["compression"] = case["compression"]
        with pytest.raises(ValueError) as rexc:
            r_round(rloss, r_copt("delta_sgd"), r_sopt("fedavg"),
                    num_rounds=1, **rkw)
        with pytest.raises(ValueError) as exc:
            make_fl_round(loss, get_client_opt("delta_sgd"),
                          get_server_opt("fedavg"), num_rounds=1, **kw)
        assert str(exc.value) == str(rexc.value)
    # the flat engines take only the global-rule Δ-SGD client
    for name, kw in (("adam", {}), ("delta_sgd", dict(groupwise=True))):
        with pytest.raises(ValueError) as rexc:
            r_loop(rloss, r_copt(name, **kw), r_sopt("fedavg"),
                   params_like={"x": jnp.zeros(2)}, num_rounds=1)
        with pytest.raises(ValueError) as exc:
            make_fl_loop(loss, get_client_opt(name, **kw),
                         get_server_opt("fedavg"),
                         params_like={"x": torch.zeros(2)}, num_rounds=1)
        assert str(exc.value) == str(rexc.value)


def _cli(*extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--task", "easy", "--model", "mlp", "--rounds", "2",
           "--num-clients", "20", "--batch", "128", *extra]
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_runs_the_vmap_engine_with_r1_and_takes_lr():
    """R = 1 without --flat runs the vmap engine, as in the reference:
    Δ-SGD there agrees with --flat within 1e-5 (the reference's own
    cross-engine check), adam reports a NaN η, --lr is taken, and
    --rounds-per-call 2 with adam fails as the reference's loop does."""
    args = ["--client-opt", "delta_sgd"]
    vm = ttrain.main(["--device", "cpu", "--task", "easy", "--model", "mlp",
                      "--rounds", "2", "--num-clients", "20", "--batch",
                      "128"] + args)
    fl = ttrain.main(["--device", "cpu", "--task", "easy", "--model", "mlp",
                      "--rounds", "2", "--num-clients", "20", "--batch",
                      "128", "--flat"] + args)
    for a, b in zip(vm.history, fl.history):
        assert "eta_clip_rate" in b and "eta_clip_rate" not in a
        for k in FLOAT:
            _close(a[k], b[k], k)
    lines = {}
    for lr in ("0.01", "0.02"):
        proc = _cli("--client-opt", "adam", "--lr", lr)
        assert proc.returncode == 0, proc.stderr
        out = proc.stdout.splitlines()
        assert out[-1].startswith("final test-acc")
        assert all(" eta nan " in line for line in out[:2]), out
        lines[lr] = out[0].split("(")[0]
    assert lines["0.01"] != lines["0.02"]
    proc = _cli("--client-opt", "adam", "--lr", "0.01", "--rounds-per-call",
                "2")
    assert proc.returncode != 0
    assert ("flat engine requires the global-rule delta_sgd client "
            "optimizer, got 'adam'") in proc.stderr
    # a robust scenario with no compression and no --flat needs the flat
    # engine, as in the reference
    with pytest.raises(ValueError, match="require the flat engine"):
        ttrain.main(["--device", "cpu", "--task", "easy", "--rounds", "1",
                     "--num-clients", "20", "--robust-agg", "trimmed"])


def test_cli_telemetry_reports_the_vmap_engine_as_the_reference_does(
        capsys):
    ttrain.main(["--device", "cpu", "--task", "easy", "--model", "mlp",
                 "--rounds", "2", "--num-clients", "20", "--batch", "128",
                 "--client-opt", "sgd", "--telemetry"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert all(" eta nan " in line for line in lines[:2]), lines[:2]
    start = out.index("scenario report:") + len("scenario report:")
    report = json.loads(out[start:out.index("final test-acc")])
    assert report["rounds"] == 2
    assert report["eta_hist"] == [0.0] * 16
    assert np.isfinite(report["loss_deciles"]).all()
