"""Port parity for slice 2: scenario, fault-tolerant and compressed rounds.

R = 3 rounds of the port's ``make_fl_loop`` against live runs of the
reference's ``make_fl_loop(flat="xla")`` (and one ``flat="pallas"`` case)
on a small MLP federation (the golden fixtures' configuration,
``tests/_golden_common.py``), with the reference's initial params,
cohort ids and scenario draws injected (``repro_torch.interop``):

  a  dirichlet_stragglers (heterogeneous K)
  b  int8 + EF21 compression
  c  dirichlet_dropouts + trimmed mean, quorum 2 (drops, NaN lanes)
  d  bandwidth_tiered + median + EF21 (all four new kernels)
  e  a quorum larger than the cohort: every round is skipped
  f  byzantine deltas (scaled client-side, before top-k) + clip

Per-round ``loss``/``eta_*`` and the final params agree within 1e-5
relative; the count fields are exact. The port's fused loop equals its
host loop bitwise and makes the stated launches per namespace.
"""
import dataclasses
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

from repro.compression import CompressionSpec as RSpec
from repro.configs.paper_tasks import MLP_SMALL
from repro.core import arena_gather as r_gather
from repro.core import flatten_fl_state as r_flatten
from repro.core import get_client_opt as r_copt
from repro.core import get_server_opt as r_sopt
from repro.core import init_fl_state as r_init
from repro.core import make_fl_loop as r_loop
from repro.core import make_loss as r_make_loss
from repro.core import unflatten_fl_state as r_unflatten
from repro.data.pipeline import FederatedDataset as RFed
from repro.data.synthetic import get_task as r_task
from repro.federation import get_scenario as r_scenario
from repro.models.small import make_small_model as r_model
from repro.models.small import softmax_ce as r_ce
from repro_torch import interop
from repro_torch.compression import CompressionSpec
from repro_torch.configs import paper_tasks as tcfg
from repro_torch.core import (arena_gather, flatten_fl_state,
                              get_client_opt, get_server_opt, init_fl_state,
                              make_fl_loop, make_fl_round, make_loss,
                              unflatten_fl_state)
from repro_torch.data.pipeline import FederatedDataset
from repro_torch.data.synthetic import get_task
from repro_torch.federation import cohort_size, get_scenario
from repro_torch.kernels.compress import compress as tcomp
from repro_torch.kernels.delta_sgd import delta_sgd as tk
from repro_torch.kernels.robust_agg import robust_agg as tra
from repro_torch.launch import train as ttrain
from repro_torch.models.small import make_small_model, softmax_ce
from repro_torch.utils.tree import tree_leaves
from test_torch_slice import ReplayScheduler


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one CPU thread while this module runs: eight threads a
    worker contend with the other test workers and with XLA's pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
# the golden fixtures' federation (tests/_golden_common.py)
CLIENTS, BATCH, K, SEED, ALPHA, R = 20, 8, 3, 7, 0.5, 3

# name -> (scenario preset or None, scenario overrides, compression
# spec fields or None, participation)
CASES = {
    "a_stragglers": ("dirichlet_stragglers", {}, None, 0.2),
    "b_int8_ef21": (None, {}, dict(kind="int8", error_feedback=True), 0.2),
    "c_dropouts_trimmed": ("dirichlet_dropouts",
                           dict(robust_agg="trimmed", quorum=2), None, 0.5),
    "d_bandwidth_median_ef21": ("bandwidth_tiered", dict(robust_agg="median"),
                                dict(kind="none", error_feedback=True), 0.5),
    "e_quorum_skips": ("sync_iid", dict(quorum=5), None, 0.2),
    "f_byzantine_clip_topk": ("sync_iid", dict(byzantine_rate=0.3,
                                               robust_agg="clip"),
                              dict(kind="topk"), 0.5),
}
FLOAT = ("loss", "loss_last_step", "eta_mean", "eta_min", "eta_max")
# exact: counts, and means of counts over the cohort
EXACT = ("valid_count", "round_skipped", "drop_frac", "k_eff_mean",
         "k_eff_min", "k_eff_max", "wire_bytes", "comp_ratio",
         "cohort_ids", "nan_guard_rate", "eta_clip_rate", "byz_frac",
         "comp_level_mean")
# launches per round: (quantize, dequantize, topk, trimmed mean)
LAUNCHES = {"a_stragglers": (0, 0, 0, 0), "b_int8_ef21": (1, 1, 0, 0),
            "c_dropouts_trimmed": (0, 0, 0, 1),
            "d_bandwidth_median_ef21": (1, 1, 1, 1),
            "e_quorum_skips": (0, 0, 0, 0),
            "f_byzantine_clip_topk": (0, 0, 1, 0)}


def _loss(logits_fn, ce):
    return lambda q, bt: (ce(logits_fn(q, bt["x"]), bt["y"]), {})


@lru_cache(maxsize=None)
def _reference(case, flat="xla"):
    """The reference's fused loop -> (initial FLState, staged indices,
    per-round draws, metrics, final FLState), all numpy."""
    name, over, comp, part = CASES[case]
    scn = r_scenario(name, seed=SEED, **over) if name else None
    spec = RSpec(**comp) if comp else None
    fed = RFed.build(r_task("easy", seed=SEED), num_clients=CLIENTS,
                     alpha=ALPHA, seed=SEED, scenario=scn)
    init_fn, logits_fn = r_model(MLP_SMALL)
    params = init_fn(jax.random.key(SEED))
    sopt = r_sopt("fedavg")
    loop = r_loop(r_make_loss(_loss(logits_fn, r_ce)), r_copt("delta_sgd"),
                  sopt, params_like=params, num_rounds=10,
                  rounds_per_call=R, flat=flat, scenario=scn,
                  num_clients=CLIENTS,
                  client_sizes=fed.client_sizes() if scn else None,
                  compression=spec, gather=r_gather)
    C = cohort_size(part, CLIENTS)
    state0 = r_init(params, sopt, scn, compression=spec, cohort=C)
    idx, _, ids = fed.sample_block(part, K, BATCH, round0=0, rounds=R)
    arena = jax.tree.map(jnp.asarray, fed.arena())
    fst, mets = jax.jit(loop)(r_flatten(state0, loop.layout),
                              jnp.asarray(idx), arena=arena)
    draws = {}
    for t in range(R):
        d = {"cohort_ids": ids[t]}
        if scn is not None:
            d["step_counts"] = scn.draw_step_counts(t, C, K)
            d["levels"] = scn.draw_compression_levels(t, C)
            d["faults"] = scn.draw_faults(t, C, K)
        draws[t] = jax.device_get(d)
    return (jax.device_get(state0), idx, ids, draws, jax.device_get(mets),
            jax.device_get(r_unflatten(fst, loop.layout)))


def _port_setup(case, ids, draws):
    name, over, comp, part = CASES[case]
    scn = (get_scenario(name, seed=SEED, draws=interop.draws_from_numpy(
        draws), **over) if name else None)
    fed = FederatedDataset.build(
        get_task("easy", seed=SEED), num_clients=CLIENTS, alpha=ALPHA,
        seed=SEED, scenario=scn,
        scheduler=None if scn else ReplayScheduler(ids))
    _, logits_fn = make_small_model(tcfg.MLP_SMALL)
    kw = dict(scenario=scn, num_clients=CLIENTS,
              client_sizes=fed.client_sizes() if scn else None,
              compression=CompressionSpec(**comp) if comp else None)
    return fed, make_loss(_loss(logits_fn, softmax_ce)), kw, part


def _reset():
    for mod in (tk, tcomp, tra):
        mod.reset_launch_count()


def _port_fused(case, state0_np, ids, draws):
    fed, loss, kw, part = _port_setup(case, ids, draws)
    state0 = interop.fl_state_from_numpy(state0_np)
    sopt = get_server_opt("fedavg")
    loop = make_fl_loop(loss, get_client_opt("delta_sgd"), sopt,
                        params_like=state0.params, num_rounds=10,
                        rounds_per_call=R, gather=arena_gather, **kw)
    idx, _, _ = fed.sample_block(part, K, BATCH, round0=0, rounds=R)
    arena = {k: torch.from_numpy(v) for k, v in fed.arena().items()}
    _reset()
    fst, mets = loop(flatten_fl_state(state0, loop.layout),
                     torch.from_numpy(idx), arena=arena)
    launches = dict(tk.LAUNCHES) | dict(tcomp.LAUNCHES) | dict(tra.LAUNCHES)
    return idx, mets, unflatten_fl_state(fst, loop.layout), launches


def _port_host(case, ids, draws, **override):
    fed, loss, kw, part = _port_setup(case, ids, draws)
    kw.update(override)
    state0_np = _reference(case)[0]
    sopt = get_server_opt("fedavg")
    round_fn = make_fl_round(loss, get_client_opt("delta_sgd"), sopt,
                             num_rounds=10, flat=True, **kw)
    C = cohort_size(part, CLIENTS)
    state = init_fl_state(interop.params_from_numpy(state0_np.params), sopt,
                          kw["scenario"], compression=kw["compression"],
                          cohort=C)
    rows = []
    for t in range(R):
        batches, _, _ = fed.sample_round(part, K, BATCH, round_idx=t)
        state, m, _ = round_fn(state, {k: torch.from_numpy(v)
                                       for k, v in batches.items()})
        rows.append(m)
    return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def _assert_matches(case, mets, state, rmets, rfinal, rtol):
    assert set(mets) == set(rmets), (sorted(mets), sorted(rmets))
    for k in mets:
        got, want = mets[k].numpy(), np.asarray(rmets[k])
        if k in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            assert k in FLOAT + ("agg_clip_rate",), k
            np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7,
                                       err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(rfinal.params),
                    tree_leaves(state.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                   atol=1e-6)
    if rfinal.ef is not None:
        for a, b in zip(jax.tree_util.tree_leaves(rfinal.ef),
                        tree_leaves(state.ef)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol,
                                       atol=1e-6)
    assert state.round == R


@pytest.mark.parametrize("case", sorted(CASES))
def test_loop_matches_reference(case):
    state0_np, ridx, ids, draws, rmets, rfinal = _reference(case)
    idx, mets, state, launches = _port_fused(case, state0_np, ids, draws)
    np.testing.assert_array_equal(idx, ridx)
    _assert_matches(case, mets, state, rmets, rfinal, rtol=1e-5)
    quant, dequant, topk, trimmed = LAUNCHES[case]
    assert launches == {k: v for k, v in {
        ("batched_norms", "cpu"): K * R, ("batched_apply", "cpu"): K * R,
        ("quantize_int8", "cpu"): quant * R,
        ("dequantize_int8", "cpu"): dequant * R,
        ("topk_mask", "cpu"): topk * R,
        ("batched_trimmed_mean", "cpu"): trimmed * R}.items() if v}


def test_loop_matches_reference_pallas():
    case = "d_bandwidth_median_ef21"
    state0_np, _, ids, draws, rmets, rfinal = _reference(case, "pallas")
    _, mets, state, _ = _port_fused(case, state0_np, ids, draws)
    _assert_matches(case, mets, state, rmets, rfinal, rtol=1e-5)


def test_cases_reach_their_branches():
    """The cases exercise what they are named for: stragglers, drops,
    NaN lanes, several bandwidth levels, and skipped rounds."""
    mets = {c: _reference(c)[4] for c in CASES}
    assert np.asarray(mets["a_stragglers"]["k_eff_min"]).min() < K
    c = mets["c_dropouts_trimmed"]
    assert np.asarray(c["drop_frac"]).max() > 0
    assert np.asarray(c["valid_count"]).min() < 10
    assert np.asarray(mets["e_quorum_skips"]["round_skipped"]).tolist() == \
        [1.0] * R
    f = mets["f_byzantine_clip_topk"]
    assert np.asarray(f["byz_frac"]).max() > 0
    assert np.asarray(f["agg_clip_rate"]).max() > 0
    levels = np.concatenate([np.asarray(_reference(
        "d_bandwidth_median_ef21")[3][t]["levels"]) for t in range(R)])
    assert len(set(levels.tolist())) == 3


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_loop_equals_host_loop_bitwise(case):
    state0_np, _, ids, draws, _, _ = _reference(case)
    _, fmets, fstate, _ = _port_fused(case, state0_np, ids, draws)
    hstate, hmets = _port_host(case, ids, draws)
    assert set(fmets) == set(hmets)
    for k in fmets:
        assert torch.equal(fmets[k], hmets[k]), k
    for a, b in zip(tree_leaves(fstate.params), tree_leaves(hstate.params)):
        assert torch.equal(a, b)
    if fstate.ef is not None:
        for a, b in zip(tree_leaves(fstate.ef), tree_leaves(hstate.ef)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["inert_compression", "sync_iid"])
def test_inert_settings_take_the_slice1_path(variant):
    """An inert spec equals no compression, and sync_iid equals no
    scenario, bitwise (params and every shared metric)."""
    _, _, ids, _, _, _ = _reference("b_int8_ef21")
    base_state, base = _port_host("b_int8_ef21", ids, {}, compression=None)
    if variant == "inert_compression":
        kw = dict(compression=CompressionSpec("none"))
    else:
        kw = dict(compression=None, scenario=get_scenario(
            "sync_iid", seed=SEED, draws=interop.draws_from_numpy(
                {t: {"cohort_ids": ids[t]} for t in range(R)})))
    state, mets = _port_host("b_int8_ef21", ids, {}, **kw)
    assert set(base) <= set(mets)
    for k in base:
        assert torch.equal(base[k], mets[k]), k
    for a, b in zip(tree_leaves(base_state.params), tree_leaves(state.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["zipf_async", "byzantine_async"])
def test_async_presets_name_the_fedbuff_item(name):
    """The async presets run through the FedBuff buffer: the vmap engine
    refuses them as the reference's does, the state carries the buffer,
    and the CLI takes the flat engine by itself and reports the
    buffer's metrics."""
    loss = make_loss(lambda q, bt: (q["x"].sum(), {}))
    copt, sopt = get_client_opt("delta_sgd"), get_server_opt("fedavg")
    scn = get_scenario(name)
    with pytest.raises(ValueError, match="flat engine"):
        make_fl_round(loss, copt, sopt, num_rounds=1, scenario=scn)
    buf = init_fl_state({"x": torch.zeros(2)}, sopt, scn).buffer
    assert buf.delta["x"].tolist() == [0.0, 0.0] and int(buf.count) == 0
    out = ttrain.main(["--task", "easy", "--scenario", name, "--device",
                       "cpu", "--rounds", "2", "--num-clients", "20",
                       "--participation", "0.2", "--batch", "128"])
    # C = 4 updates against M = 8: round 0 holds what it buffered
    assert out.state.round == 2
    assert float(out.history[0]["buffer_fill"]) > 0
    assert float(out.history[0]["flushed"]) == 0.0
    for row in out.history:
        assert {"stale_mean", "stale_max", "buffer_fill",
                "flushed"} <= set(row)


@pytest.mark.parametrize("name", ["fleet_uniform", "fleet_zipf"])
def test_cli_exits_on_fleet_presets(name):
    """The fleet presets run the fleet loop at their own scale: 100,000
    registered clients, participation 0.0005, so C = 50."""
    out = ttrain.main(["--task", "easy", "--scenario", name, "--device",
                       "cpu", "--rounds", "2", "--num-clients", "20",
                       "--batch", "256"])
    assert out.state.round == 2
    for row in out.history:
        assert row["cohort_ids"].shape == (50,)
        assert row["cohort_ids"].max() < 100_000
        assert {"revisit_frac", "realized_stale_mean",
                "eta_carry_mean"} <= set(row)


def test_ef_state_crosses_over_from_the_reference():
    state0_np = _reference("b_int8_ef21")[0]
    state = interop.fl_state_from_numpy(state0_np)
    C = cohort_size(0.2, CLIENTS)
    for a, b in zip(jax.tree_util.tree_leaves(state0_np.ef),
                    tree_leaves(state.ef)):
        assert b.shape[0] == C and b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the async buffer crosses too (test_torch_async.py fills one)
    from repro.federation import buffer_init as r_buffer_init
    with_buf = state0_np._replace(buffer=jax.device_get(r_buffer_init(
        jax.tree.map(jnp.asarray, state0_np.params))))
    back = interop.fl_state_to_numpy(interop.fl_state_from_numpy(with_buf))
    assert int(back.buffer.count) == 0 and back.buffer.count.dtype == np.int32
    for a, b in zip(jax.tree_util.tree_leaves(with_buf.buffer),
                    jax.tree_util.tree_leaves(tuple(back.buffer))):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_cli_runs_scenario_compression_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--task", "easy", "--model", "mlp", "--rounds", "2",
           "--rounds-per-call", "2", "--scenario", "dirichlet_dropouts",
           "--compression", "int8", "--error-feedback", "--robust-agg",
           "trimmed"]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert [l.split()[1] for l in lines[:2]] == ["0", "1"]
    assert all(" valid " in l and " wire " in l for l in lines[:2])
    assert lines[-1].startswith("final test-acc")


def test_scenario_round_reports_cohort_and_wire_fields():
    """The draws the round reports are the draws the pipeline used."""
    scn = get_scenario("bandwidth_tiered", seed=3, quorum=1)
    assert dataclasses.replace(scn, draws=None) == scn
    args = ttrain.build_parser().parse_args(
        ["--device", "cpu", "--task", "easy", "--model", "mlp", "--rounds",
         "2", "--rounds-per-call", "2", "--num-clients", "20", "--scenario",
         "bandwidth_tiered", "--quorum", "1"])
    pt = ttrain.setup_paper_task(args)
    run = ttrain.BlockRunner(pt, args)
    fstate = flatten_fl_state(ttrain.init_state(pt), run.layout)
    _, mets = run(fstate, run.stage(0, 2))
    _, _, ids = pt.fed.sample_block(pt.participation, pt.local_steps,
                                    args.batch, round0=0, rounds=2)
    np.testing.assert_array_equal(mets["cohort_ids"].numpy(), ids)
    levels = [pt.scenario.draw_compression_levels(t, pt.cohort)
              for t in range(2)]
    table = pt.compression.level_wire_bytes(run.layout.size)
    np.testing.assert_array_equal(mets["wire_bytes"].numpy(),
                                  [table[lv].sum() for lv in levels])
