"""Port parity for slice 4: the telemetry plane.

  * the plain versions of ``lane_histogram`` / ``lane_quantiles`` against
    the reference's kernels in interpret mode (NaN, ±0, ties, C not a
    multiple of 128), and the sort against ``jnp.sort`` bit for bit;
  * ``TelemetrySpec``, the schema registry, ``EventLog``, ``SpanTimer``
    and the scenario report against the reference's;
  * a live reference run of the golden fixtures' federation
    (``tests/_golden_common.py``) with ``telemetry=True``, against the
    port with the reference's params, cohorts and scenario draws: the
    histogram and counts exactly, the deciles within 1e-5, and the
    port's ``round_telemetry`` fed the reference's own round-end η and
    losses exactly the reference's block;
  * telemetry on and off bitwise equal (host round and fused loop), its
    own launch namespace, no host transfer inside a fused block, and the
    train CLI's event log.
"""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.telemetry.spec as r_spec
from repro.configs.paper_tasks import MLP_SMALL
from repro.core import get_client_opt as r_copt
from repro.core import get_server_opt as r_sopt
from repro.core import init_fl_state as r_init
from repro.core import make_fl_round as r_round
from repro.core import make_loss as r_make_loss
from repro.data.pipeline import FederatedDataset as RFed
from repro.data.synthetic import get_task as r_task
from repro.federation import get_scenario as r_scenario
from repro.kernels.telemetry import ref as r_tref
from repro.kernels.telemetry import telemetry as r_tk
from repro.launch import report as r_report
from repro.models.small import make_small_model as r_model
from repro.models.small import softmax_ce as r_ce
from repro.telemetry import TelemetrySpec as RSpec
from repro.telemetry import schema as r_schema
from repro_torch import interop
from repro_torch.configs import paper_tasks as tcfg
from repro_torch.core import (arena_gather, flatten_fl_state,
                              get_client_opt, get_server_opt, init_fl_state,
                              make_fl_loop, make_fl_round, make_loss,
                              unflatten_fl_state)
from repro_torch.data.pipeline import FederatedDataset
from repro_torch.data.synthetic import get_task
from repro_torch.federation import cohort_size, get_scenario
from repro_torch.kernels.delta_sgd import delta_sgd as tk
from repro_torch.kernels.telemetry import ref as tref
from repro_torch.kernels.telemetry import telemetry as tt
from repro_torch.launch import report, train
from repro_torch.models.small import make_small_model, softmax_ce
from repro_torch.telemetry import (EventLog, SpanTimer, TelemetrySpec,
                                   config_hash, kernel_launch_snapshot,
                                   load_events, reset_kernel_launches,
                                   resolve_telemetry, round_telemetry,
                                   schema, static_telemetry)
from repro_torch.telemetry.events import to_host
from repro_torch.utils.tree import tree_leaves
from test_torch_slice import ReplayScheduler

# the golden fixtures' federation (tests/_golden_common.py)
CLIENTS, BATCH, K, SEED, ALPHA, R = 20, 8, 3, 7, 0.5, 3
# case -> (scenario preset or None, overrides, participation)
LIVE = {"plain": (None, {}, 0.2),
        "dropouts": ("dirichlet_dropouts", dict(nan_rate=0.3), 0.5)}
TELE_KEYS = ("eta_hist", "loss_deciles", "eta_clip_count",
             "nan_guard_count")


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _lanes(C, seed, nan=False):
    """log-spread positive values with ±0, ±inf, ties (and NaN of both
    signs), C not a multiple of 128."""
    r = np.random.default_rng(seed)
    x = (10.0 ** r.uniform(-6.0, 3.0, C)).astype(np.float32)
    x *= np.where(r.uniform(size=C) < 0.3, -1.0, 1.0).astype(np.float32)
    special = [0.0, -0.0, np.inf, -np.inf, 1.0, 1.0, -0.0, 0.0]
    if nan:
        special = [np.nan, -np.nan, np.nan] + special
    n = min(C, len(special))
    x[r.permutation(C)[:n]] = np.asarray(special[:n], np.float32)
    return x


# ------------------------------------------------------------- kernels
@pytest.mark.parametrize("C", [1, 10, 257, 1000])
def test_lane_histogram_matches_the_reference_kernel(C):
    x = np.abs(_lanes(C, C, nan=True))
    edges = RSpec(eta_bins=16).eta_edges()
    want = np.asarray(r_tk.lane_histogram(jnp.asarray(x), jnp.asarray(edges),
                                          interpret=True))
    got = tt.lane_histogram(torch.from_numpy(x), torch.from_numpy(edges))
    assert got.dtype == torch.float32 and got.shape == (16,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(r_tref.lane_histogram_ref(jnp.asarray(x),
                                                          edges)))
    # NaN and +inf lanes count in no bin
    assert float(got.sum()) == C - int((~np.isfinite(x)).sum())


def test_lane_histogram_takes_any_edges_like_the_reference():
    x = _lanes(300, 5, nan=True)
    edges = np.asarray([-1.0, 5.0, 0.5, 0.5, np.nan, 2.0, np.inf],
                       np.float32)
    want = np.asarray(r_tk.lane_histogram(jnp.asarray(x), jnp.asarray(edges),
                                          interpret=True))
    got = tt.lane_histogram(torch.from_numpy(x), edges)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("Q", [2, 5, 11])
@pytest.mark.parametrize("C", [1, 2, 10, 77, 130, 1000])
def test_lane_quantiles_match_the_reference_kernel(C, Q):
    x = _lanes(C, 100 + C)
    want = r_tk.lane_quantiles(jnp.asarray(x), Q, interpret=True)
    got = tt.lane_quantiles(torch.from_numpy(x), Q)
    assert got.shape == (Q,)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("C", [3, 77, 1000])
def test_lane_quantiles_with_nan_lanes_match_the_reference_ref(C):
    """NaN sorts after +inf, as in jnp.sort; the reference's kernel pads
    with +inf, which sorts before the NaN lanes, so there its top
    quantile is +inf where ref.py (and the port) give NaN."""
    x = _lanes(C, 7 + C, nan=True)
    got = tt.lane_quantiles(torch.from_numpy(x))
    want = np.asarray(r_tref.lane_quantiles_ref(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert np.isnan(got[-1].item())
    kernel = np.asarray(r_tk.lane_quantiles(jnp.asarray(x), interpret=True))
    assert kernel[-1] == np.inf


@pytest.mark.parametrize("C", [16385, 100000])
def test_lane_quantiles_past_one_tile_match_the_reference(C):
    """Cohorts the CUDA kernel ranks across tiles of QUANTILE_TILE lanes:
    with NaN of both signs against ref.py (NaN after +inf), without NaN
    against the reference's kernel in interpret mode; ±0, ±inf and ties
    in both."""
    assert C > tt.QUANTILE_TILE
    x = _lanes(C, 300 + C, nan=True)
    got = tt.lane_quantiles(torch.from_numpy(x))
    want = np.asarray(r_tref.lane_quantiles_ref(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert np.isnan(got[-1].item())
    x = _lanes(C, 400 + C)
    got = tt.lane_quantiles(torch.from_numpy(x), 21)
    want = r_tk.lane_quantiles(jnp.asarray(x), 21, interpret=True)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _ordered_keys(x):
    """The CUDA kernel's 64-bit keys: the order-preserving bits of each
    lane's canonical value (zeros +0.0, NaN one NaN) above the lane."""
    u = np.where(x == 0.0, np.float32(0.0), x).view(np.uint32)
    u = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint64)
    u = np.where(np.isnan(x), np.uint64(0xffc00000), u)
    return (u << np.uint64(32)) | np.arange(x.size, dtype=np.uint64)


@pytest.mark.parametrize("C", [2049, 16385, 100000])
def test_multi_block_selection_is_the_sort(C):
    """The two launches of the CUDA path, emulated: each tile of
    QUANTILE_TILE keys sorted alone (padded with all-ones keys), then
    every key ranked by its place in its tile plus a binary search of
    every other tile. The ranks are a permutation, and the keys at the
    requested ranks give ref.py's quantiles bit for bit."""
    T = tt.QUANTILE_TILE
    x = _lanes(C, 500 + C, nan=True)
    tiles = -(-C // T)
    keys = np.full(tiles * T, np.iinfo(np.uint64).max, np.uint64)
    keys[:C] = _ordered_keys(x)
    srt = np.sort(keys.reshape(tiles, T), axis=1)
    rank = np.tile(np.arange(T), (tiles, 1))
    for j in range(tiles):
        below = np.searchsorted(srt[j], srt, side="left")
        below[j] = 0
        rank += below
    real = srt != np.iinfo(np.uint64).max
    assert np.array_equal(np.sort(rank[real]), np.arange(C))
    lane_at = np.empty(C, np.int64)
    lane_at[rank[real]] = (srt[real] & np.uint64(0xffffffff)).astype(np.int64)
    got = x[lane_at[list(tref.quantile_indices(C, 11))]]
    want = tref.lane_quantiles_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_sort_is_bitwise_jnp_sort():
    r = np.random.default_rng(0)
    for n in (1, 5, 64, 333):
        pool = np.asarray([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5,
                           -1.5, 2.0], np.float32)
        x = pool[r.integers(0, len(pool), n)]
        mix = r.uniform(size=n) < 0.3
        x[mix] = r.normal(size=int(mix.sum())).astype(np.float32)
        got = tref.sort_like_jnp(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(_bits(got),
                                      _bits(jnp.sort(jnp.asarray(x))))


def test_quantile_indices_are_the_references():
    for C in (1, 2, 3, 9, 10, 11, 77, 1000, 16384, 16385, 100000, 1 << 17):
        for Q in (2, 3, 5, 11, 21):
            assert tref.quantile_indices(C, Q) == r_tref.quantile_indices(C, Q)
    with pytest.raises(ValueError):
        tref.quantile_indices(0)


def test_wrappers_check_their_inputs():
    with pytest.raises(TypeError):
        tt.lane_quantiles(torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="vector"):
        tt.lane_histogram(torch.zeros(2, 2), [0.0, 1.0])
    with pytest.raises(ValueError, match=f"at most {tt.MAX_LANES} lanes"):
        tt.lane_quantiles(torch.zeros(tt.MAX_LANES + 1))
    with pytest.raises(ValueError, match="edges"):
        tt.lane_histogram(torch.zeros(3), [0.0])


def test_telemetry_counts_in_its_own_namespace():
    reset_kernel_launches()
    x = torch.from_numpy(np.abs(_lanes(64, 1)))
    tt.lane_histogram(x, TelemetrySpec().eta_edges())
    tt.lane_quantiles(x)
    snap = kernel_launch_snapshot()
    assert snap == {"telemetry/lane_histogram": 1,
                    "telemetry/lane_quantiles": 1}
    assert kernel_launch_snapshot("cuda") == {}
    assert tk.launch_count() == 0


# --------------------------------------------------- spec and registry
@pytest.mark.parametrize("kw", [{}, dict(eta_bins=3), dict(eta_bins=8),
                                dict(eta_bins=33, eta_lo=1e-6, eta_hi=3.0)])
def test_eta_edges_are_the_references_bits(kw):
    got, want = TelemetrySpec(**kw).eta_edges(), RSpec(**kw).eta_edges()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    with pytest.raises(ValueError):
        TelemetrySpec(eta_bins=2).eta_edges()


def test_resolve_and_disabled_round_telemetry():
    assert not resolve_telemetry(None).enabled
    assert not resolve_telemetry(False).enabled
    assert resolve_telemetry(True) == TelemetrySpec(enabled=True)
    spec = TelemetrySpec(enabled=True, eta_bins=8)
    assert resolve_telemetry(spec) is spec
    with pytest.raises(ValueError):
        resolve_telemetry("yes")
    assert round_telemetry(TelemetrySpec(), torch.ones(4),
                           torch.ones(4, 2)) == {}


def test_schema_registry_is_the_references():
    assert list(schema.REGISTRY) == list(r_schema.REGISTRY)
    assert len(schema.REGISTRY) == 39
    for name, spec in schema.REGISTRY.items():
        assert tuple(spec) == tuple(r_schema.REGISTRY[name]), name
    assert schema.markdown_table() == r_schema.markdown_table()
    assert schema.is_scalar("loss") and not schema.is_scalar("eta_hist")
    with pytest.raises(ValueError):
        schema.register("zz_bad", summaries=(("x", "median"),))


def test_warn_unregistered_warns_once():
    schema._warned.discard("zz_bogus_metric")
    with pytest.warns(UserWarning, match="zz_bogus_metric"):
        schema.warn_unregistered("zz_bogus_metric", producer="test")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        schema.warn_unregistered("zz_bogus_metric", producer="test")


# ------------------------------------------------------------ artifacts
def test_event_log_header_and_one_conversion_per_flush(tmp_path):
    path = tmp_path / "sub" / "events.jsonl"
    cfg = {"task": "easy", "rounds": 4}
    with EventLog(str(path), config=cfg, device="cpu") as ev:
        header, events = load_events(str(path))
        assert events == [] and header["kind"] == "header"
        assert header["config_hash"] == config_hash(cfg)
        assert header["torch_version"] == torch.__version__
        assert header["cuda_version"] == torch.version.cuda
        assert header["device_name"] == "cpu"
        assert header["device_count"] == torch.cuda.device_count()
        assert header["mesh"] is None and header["config"] == cfg
        ev.emit("round", t=0, loss=torch.tensor(1.5),
                eta_hist=torch.arange(3, dtype=torch.float32),
                ids=torch.tensor([3, 1], dtype=torch.int64),
                ok=torch.tensor(True), half=torch.tensor(0.5).bfloat16())
        assert ev.flush() == 1
        ev.emit("round", t=1, loss=np.float32(0.5))
    _, events = load_events(str(path))
    assert [e["kind"] for e in events] == ["round", "round"]
    assert events[0] == {"kind": "round", "t": 0, "loss": 1.5,
                         "eta_hist": [0.0, 1.0, 2.0], "ids": [3, 1],
                         "ok": True, "half": 0.5}
    assert events[1]["loss"] == 0.5 and ev.events_written == 2
    # a mesh (ported since the multi-device slice) is recorded as
    # {axis: size}, as the reference records it
    class Mesh:
        shape = {"data": 2, "model": 2}
    with EventLog(str(tmp_path / "m.jsonl"), mesh=Mesh(), device="cpu"):
        header, _ = load_events(str(tmp_path / "m.jsonl"))
    assert header["mesh"] == {"data": 2, "model": 2}


def test_event_log_rejects_headerless(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"kind": "round", "t": 0}\n')
    with pytest.raises(ValueError, match="header"):
        load_events(str(p))


def test_to_host_keeps_shapes_and_kinds():
    vals = [torch.tensor(2.5), torch.arange(6, dtype=torch.int32).view(2, 3),
            torch.tensor([True, False])]
    a, b, c = to_host(vals)
    assert isinstance(a, np.float32) and a == 2.5
    assert b.dtype == np.int32 and b.shape == (2, 3)
    assert c.dtype == np.bool_ and c.tolist() == [True, False]


def test_span_timer():
    st = SpanTimer()
    with st.span("pack"):
        pass
    with st.span("pack"):
        pass
    st.add("stage", 0.5)
    s = st.summary()
    assert s["pack"]["n"] == 2 and s["pack"]["s"] >= 0.0
    assert s["stage"] == {"s": 0.5, "n": 1}
    assert "pack" in str(st) and "stage" in str(st)


def test_static_telemetry_row():
    row = static_telemetry(rounds=2, launches={"telemetry/lane_histogram": 2,
                                               "delta_sgd/batched_norms": 14})
    assert row == {"rounds": 2,
                   "kernel_launches": {"telemetry/lane_histogram": 2,
                                       "delta_sgd/batched_norms": 14},
                   "kernel_launches_per_round": {
                       "telemetry/lane_histogram": 1.0,
                       "delta_sgd/batched_norms": 7.0}}


def test_scenario_summary_and_render_match_the_reference():
    r = np.random.default_rng(3)
    rows = [{"stale_mean": float(i), "wire_bytes": 100.0 * (i + 1),
             "loss": 0.5, "valid_count": 3.0 + i,
             "eta_hist": r.integers(0, 4, 16).astype(np.float64),
             "loss_deciles": np.sort(r.normal(size=11))} for i in range(3)]
    ids = [r.integers(0, 12, 4) for _ in range(3)]
    got = report.scenario_summary("sync_iid", ids, 12, rows)
    want = r_report.scenario_summary("sync_iid", ids, 12, rows)
    assert got == want
    assert len(got["eta_hist_edges"]) == 17
    edges = TelemetrySpec(eta_bins=16).eta_edges()
    assert report.eta_hist_render(got["eta_hist"], edges) == \
        r_report.eta_hist_render(want["eta_hist"], edges)
    assert report.eta_hist_render([0, 0], [0.0, 1.0, np.inf]).startswith(
        "(empty")
    np.testing.assert_array_equal(report.cohort_histogram(ids, 12),
                                  r_report.cohort_histogram(ids, 12))


def test_scenario_stats_route_through_the_schema():
    schema._warned.discard("zz_new_metric")
    stats = train._ScenarioStats(None, num_clients=4)
    with pytest.warns(UserWarning, match="zz_new_metric"):
        stats.update(np.asarray([0, 1]),
                     {"stale_mean": np.float32(1.5), "zz_new_metric": 2.0,
                      "eta_hist": np.asarray([1.0, 2.0], np.float32)})
    assert stats.metrics[0]["zz_new_metric"] == 2.0
    np.testing.assert_array_equal(stats.metrics[0]["eta_hist"], [1.0, 2.0])
    rep = stats.report()
    assert rep["stale_mean"] == 1.5 and rep["eta_hist"] == [1.0, 2.0]
    assert rep["cohort_histogram"] == [1, 1, 0, 0]


# ------------------------------------------------ live reference parity
def _loss(logits_fn, ce):
    return lambda q, bt: (ce(logits_fn(q, bt["x"]), bt["y"]), {})


def _reference_run(case):
    """R host rounds of the reference's flat round with telemetry on,
    with its round_telemetry spied on -> (initial state, cohort ids,
    draws, metrics, [(etas, losses, clips, valid)] per round)."""
    name, over, part = LIVE[case]
    spied = []
    real = r_spec.round_telemetry

    def spy(tele, etas, losses, clips=None, valid=None, **kw):
        spied.append(tuple(np.asarray(a) for a in (etas, losses, clips,
                                                   valid)))
        return real(tele, etas, losses, clips, valid, **kw)

    with pytest.MonkeyPatch.context() as mp, \
            jax.threefry_partitionable(False):
        mp.setattr(r_spec, "round_telemetry", spy)
        scn = r_scenario(name, seed=SEED, **over) if name else None
        fed = RFed.build(r_task("easy", seed=SEED), num_clients=CLIENTS,
                         alpha=ALPHA, seed=SEED, scenario=scn)
        init_fn, logits_fn = r_model(MLP_SMALL)
        sopt = r_sopt("fedavg")
        rnd = r_round(r_make_loss(_loss(logits_fn, r_ce)),
                      r_copt("delta_sgd"), sopt, num_rounds=10, flat="xla",
                      scenario=scn, num_clients=CLIENTS,
                      client_sizes=fed.client_sizes() if scn else None,
                      telemetry=True)
        C = cohort_size(part, CLIENTS)
        state = r_init(init_fn(jax.random.key(SEED)), sopt, scn)
        state0 = jax.device_get(state)
        ids, mets, draws = [], [], {}
        for t in range(R):
            bat, _, rid = fed.sample_round(part, K, BATCH, round_idx=t)
            state, m, _ = rnd(state, {"x": jnp.asarray(bat["x"]),
                                      "y": jnp.asarray(bat["y"])})
            ids.append(np.asarray(rid))
            mets.append(jax.device_get(m))
            d = {"cohort_ids": rid}
            if scn is not None:
                d.update(step_counts=scn.draw_step_counts(t, C, K),
                         levels=scn.draw_compression_levels(t, C),
                         faults=scn.draw_faults(t, C, K))
            draws[t] = jax.device_get(d)
    assert len(spied) == R
    return state0, ids, draws, mets, spied


@pytest.fixture(scope="module")
def live():
    return {case: _reference_run(case) for case in LIVE}


def _port_setup(case, live):
    name, over, part = LIVE[case]
    state0, ids, draws, _, _ = live[case]
    scn = (get_scenario(name, seed=SEED, draws=interop.draws_from_numpy(
        draws), **over) if name else None)
    fed = FederatedDataset.build(
        get_task("easy", seed=SEED), num_clients=CLIENTS, alpha=ALPHA,
        seed=SEED, scenario=scn,
        scheduler=None if scn else ReplayScheduler(np.stack(ids)))
    _, logits_fn = make_small_model(tcfg.MLP_SMALL)
    kw = dict(scenario=scn, num_clients=CLIENTS,
              client_sizes=fed.client_sizes() if scn else None)
    return fed, make_loss(_loss(logits_fn, softmax_ce)), kw, part, state0


def _port_host(case, live, telemetry=True):
    fed, loss, kw, part, state0 = _port_setup(case, live)
    sopt = get_server_opt("fedavg")
    rnd = make_fl_round(loss, get_client_opt("delta_sgd"), sopt,
                        num_rounds=10, flat=True, telemetry=telemetry, **kw)
    state = init_fl_state(interop.params_from_numpy(state0.params), sopt,
                          kw["scenario"])
    rows = []
    for t in range(R):
        batches, _, _ = fed.sample_round(part, K, BATCH, round_idx=t)
        state, m, _ = rnd(state, {k: torch.from_numpy(v)
                                  for k, v in batches.items()})
        rows.append(m)
    return state, rows


def _port_fused(case, live, telemetry=True):
    fed, loss, kw, part, state0 = _port_setup(case, live)
    sopt = get_server_opt("fedavg")
    state = init_fl_state(interop.params_from_numpy(state0.params), sopt,
                          kw["scenario"])
    loop = make_fl_loop(loss, get_client_opt("delta_sgd"), sopt,
                        params_like=state.params, num_rounds=10,
                        rounds_per_call=R, gather=arena_gather,
                        telemetry=telemetry, **kw)
    idx, _, _ = fed.sample_block(part, K, BATCH, round0=0, rounds=R)
    arena = {k: torch.from_numpy(v) for k, v in fed.arena().items()}
    fst, mets = loop(flatten_fl_state(state, loop.layout),
                     torch.from_numpy(idx), arena=arena)
    return unflatten_fl_state(fst, loop.layout), mets


@pytest.mark.parametrize("case", sorted(LIVE))
def test_telemetry_matches_a_live_reference_run(case, live):
    _, _, _, rmets, spied = live[case]
    reset_kernel_launches()
    _, rows = _port_host(case, live)
    assert kernel_launch_snapshot("cpu") == {
        "delta_sgd/batched_norms": K * R, "delta_sgd/batched_apply": K * R,
        "telemetry/lane_histogram": R, "telemetry/lane_quantiles": R}
    for t, (m, rm, args) in enumerate(zip(rows, rmets, spied)):
        for k in ("eta_hist", "eta_clip_count", "nan_guard_count"):
            np.testing.assert_array_equal(m[k].numpy(), np.asarray(rm[k]),
                                          err_msg=f"round {t} {k}")
        np.testing.assert_allclose(m["loss_deciles"].numpy(),
                                   np.asarray(rm["loss_deciles"]),
                                   rtol=1e-5, err_msg=f"round {t}")
        for k in ("loss", "eta_mean"):
            np.testing.assert_allclose(m[k].numpy(), np.asarray(rm[k]),
                                       rtol=1e-5, err_msg=f"round {t} {k}")
        # the reference's own round-end η, losses and guard latches
        # through the port's round_telemetry: its block exactly
        etas, losses, clips, valid = (torch.from_numpy(np.array(a))
                                      for a in args)
        block = round_telemetry(TelemetrySpec(enabled=True), etas, losses,
                                clips, valid)
        assert sorted(block) == sorted(TELE_KEYS)
        for k in TELE_KEYS:
            np.testing.assert_array_equal(block[k].numpy(),
                                          np.asarray(rm[k]),
                                          err_msg=f"round {t} {k}")
    if case == "dropouts":
        assert max(float(m["nan_guard_count"]) for m in rows) > 0


@pytest.mark.parametrize("case", sorted(LIVE))
def test_telemetry_on_and_off_are_bitwise_equal(case, live):
    for run in (_port_host, _port_fused):
        off_state, off = run(case, live, telemetry=False)
        on_state, on = run(case, live, telemetry=True)
        if run is _port_host:
            off, on = ({k: torch.stack([m[k] for m in rows]) for k in rows[0]}
                       for rows in (off, on))
        assert set(on) - set(off) == set(TELE_KEYS)
        for k in off:
            assert torch.equal(off[k], on[k]), (run.__name__, k)
        for a, b in zip(tree_leaves(off_state.params),
                        tree_leaves(on_state.params)):
            assert torch.equal(a, b)
        B = TelemetrySpec().eta_bins
        assert on["eta_hist"].shape == (R, B)
        assert on["loss_deciles"].shape == (R, 11)
        C = cohort_size(LIVE[case][2], CLIENTS)
        assert on["eta_hist"].sum(dim=1).tolist() == [float(C)] * R
        assert bool((on["loss_deciles"].diff(dim=1) >= 0).all())


def test_a_fused_block_makes_no_host_transfer(monkeypatch):
    """With telemetry on and a scenario without a quorum (drops, NaN
    lanes, the trimmed mean, int8 + EF21), nothing inside a fused block
    reads a tensor on the host."""
    from repro_torch.compression import CompressionSpec
    scn = get_scenario("dirichlet_dropouts", seed=SEED, quorum=0,
                       robust_agg="trimmed")
    fed = FederatedDataset.build(get_task("easy", seed=SEED),
                                 num_clients=CLIENTS, alpha=ALPHA, seed=SEED,
                                 scenario=scn)
    init_fn, logits_fn = make_small_model(tcfg.MLP_SMALL)
    params = init_fn(SEED)
    sopt = get_server_opt("fedavg")
    comp = CompressionSpec("int8", error_feedback=True)
    C = cohort_size(0.5, CLIENTS)
    loop = make_fl_loop(make_loss(_loss(logits_fn, softmax_ce)),
                        get_client_opt("delta_sgd"), sopt,
                        params_like=params, num_rounds=10,
                        rounds_per_call=R, scenario=scn, num_clients=CLIENTS,
                        client_sizes=fed.client_sizes(), compression=comp,
                        gather=arena_gather, telemetry=True)
    fst = flatten_fl_state(init_fl_state(params, sopt, scn, compression=comp,
                                         cohort=C), loop.layout)
    idx = torch.from_numpy(fed.sample_block(0.5, K, BATCH, round0=0,
                                            rounds=R)[0])
    arena = {k: torch.from_numpy(v) for k, v in fed.arena().items()}

    def refuse(*a, **kw):
        raise AssertionError("a host transfer inside a fused block")

    for name in ("item", "cpu", "tolist", "numpy", "__float__", "__int__",
                 "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    fst, mets = loop(fst, idx, arena=arena)
    monkeypatch.undo()
    assert mets["eta_hist"].shape == (R, 16)
    assert float(mets["nan_guard_count"].sum()) > 0


# ------------------------------------------------------------------ CLI
CLI = ["--device", "cpu", "--task", "easy", "--model", "mlp", "--rounds",
       "4", "--num-clients", "20", "--batch", "128", "--telemetry"]


def test_cli_writes_the_event_log_and_a_profile(tmp_path, capsys):
    ev = tmp_path / "e.jsonl"
    fused = train.main(CLI + ["--rounds-per-call", "2", "--events", str(ev),
                              "--profile", "1", "--profile-dir",
                              str(tmp_path / "prof"), "--out",
                              str(tmp_path / "report.json")])
    out = capsys.readouterr().out
    assert "static telemetry:" in out and "scenario report:" in out
    header, events = load_events(str(ev))
    assert header["device_name"] == "cpu" and header["config"]["telemetry"]
    kinds = [e["kind"] for e in events]
    assert kinds.count("round") == 4 and kinds[-1] == "spans"
    (static,) = [e for e in events if e["kind"] == "static"]
    assert static["rounds"] == 2
    per_round = static["kernel_launches_per_round"]
    assert per_round["telemetry/lane_histogram"] == 1
    assert per_round["telemetry/lane_quantiles"] == 1
    # one local epoch of 500 examples at batch 128: K = 3
    assert per_round["delta_sgd/batched_norms"] == 3
    assert per_round["delta_sgd/batched_apply"] == 3
    spans = events[-1]
    assert {"pack", "stage", "block_execute", "convert", "eval"} <= set(spans)
    rounds = [e for e in events if e["kind"] == "round"]
    assert [e["round"] for e in rounds] == [0, 1, 2, 3]
    assert all(len(e["eta_hist"]) == 16 and len(e["loss_deciles"]) == 11
               for e in rounds)
    assert (tmp_path / "prof" / "trace.json").exists()
    rep = json.loads((tmp_path / "report.json").read_text())
    assert sum(rep["eta_hist"]) == 4 * cohort_size(0.1, 20)

    host = train.main(CLI + ["--flat", "--log-every", "3", "--events",
                             str(tmp_path / "h.jsonl")])
    _, hevents = load_events(str(tmp_path / "h.jsonl"))
    assert [e["kind"] for e in hevents].count("round") == 4
    for a, b in zip(fused.history, host.history):
        assert a.keys() == b.keys()
        for k in a:
            assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes()
    with pytest.raises(SystemExit):
        train.main(CLI + ["--profile", "1"])
