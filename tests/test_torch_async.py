"""Port parity for the FedBuff async buffer (``federation/buffer.py``)
and the two async tails of the flat round.

The buffer's functions are held against the reference's on the same
inputs. The async presets run R = 3 rounds of the port's fused loop
against live runs of the reference's ``make_fl_loop(flat="xla")`` on the
golden fixtures' small MLP federation, with the reference's initial
params, cohorts, step counts, staleness and fault lanes injected
(``repro_torch.interop``): per-round ``loss``/``eta_*``, the final
params and the buffer's delta within 1e-5 relative, every async and
count metric equal. The port's fused loop equals its host loop bitwise.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from repro.federation import buffer as rbuf
from repro.federation import get_scenario as r_scenario
from repro.models.small import make_small_model as r_model
from repro.models.small import softmax_ce as r_ce
from repro_torch import interop
from repro_torch.configs import paper_tasks as tcfg
from repro_torch.core import (arena_gather, flatten_fl_state,
                              get_client_opt, get_server_opt, init_fl_state,
                              make_fl_loop, make_fl_round, make_loss,
                              unflatten_fl_state)
from repro_torch.data.pipeline import FederatedDataset
from repro_torch.data.synthetic import get_task
from repro_torch.federation import (AsyncBufferState, buffer_init,
                                    buffer_merge, buffer_step, cohort_size,
                                    get_scenario, staleness_weights)
from repro_torch.kernels.delta_sgd import delta_sgd as tk
from repro_torch.models.small import make_small_model, softmax_ce
from repro_torch.utils.tree import tree_leaves

# the golden fixtures' federation (tests/_golden_common.py)
CLIENTS, BATCH, K, SEED, ALPHA, R = 20, 8, 3, 7, 0.5, 3

# name -> (preset, overrides, server optimizer, participation). C = 4 or
# 5 against M = 8: the buffer holds, flushes and holds again
CASES = {
    "zipf_async": ("zipf_async", {}, "fedavg", 0.2),
    "byzantine_async": ("byzantine_async", {}, "fedavg", 0.25),
    "zipf_async_fedadam": ("zipf_async", {}, "fedadam", 0.2),
    # more over-stale lanes, a higher quorum and M = 6: a held round, a
    # flush, then a round below quorum (frozen buffer, params and state)
    "byzantine_async_overstale": ("byzantine_async", dict(
        overstale_rate=0.5, quorum=3, buffer_size=6), "fedavg", 0.25),
}
FLOAT = ("loss", "loss_last_step", "eta_mean", "eta_min", "eta_max",
         "agg_clip_rate")
EXACT = ("stale_mean", "stale_max", "buffer_fill", "flushed",
         "overstale_frac", "valid_count", "round_skipped", "byz_frac",
         "k_eff_mean", "k_eff_min", "k_eff_max", "cohort_ids",
         "nan_guard_rate", "eta_clip_rate")


def _loss(logits_fn, ce):
    return lambda q, bt: (ce(logits_fn(q, bt["x"]), bt["y"]), {})


@lru_cache(maxsize=None)
def _reference(case):
    """The reference's fused loop -> (initial FLState, cohort ids, draws,
    metrics, final FLState), all numpy."""
    name, over, server, part = CASES[case]
    scn = r_scenario(name, seed=SEED, **over)
    fed = RFed.build(r_task("easy", seed=SEED), num_clients=CLIENTS,
                     alpha=ALPHA, seed=SEED, scenario=scn)
    init_fn, logits_fn = r_model(MLP_SMALL)
    params = init_fn(jax.random.key(SEED))
    sopt = r_sopt(server)
    loop = r_loop(r_make_loss(_loss(logits_fn, r_ce)), r_copt("delta_sgd"),
                  sopt, params_like=params, num_rounds=10,
                  rounds_per_call=R, flat="xla", scenario=scn,
                  num_clients=CLIENTS, client_sizes=fed.client_sizes(),
                  gather=r_gather)
    C = cohort_size(part, CLIENTS)
    state0 = r_init(params, sopt, scn)
    idx, _, ids = fed.sample_block(part, K, BATCH, round0=0, rounds=R)
    arena = jax.tree.map(jnp.asarray, fed.arena())
    fst, mets = jax.jit(loop)(r_flatten(state0, loop.layout),
                              jnp.asarray(idx), arena=arena)
    draws = {t: jax.device_get({
        "cohort_ids": ids[t], "step_counts": scn.draw_step_counts(t, C, K),
        "staleness": scn.draw_staleness(t, C),
        "faults": scn.draw_faults(t, C, K)}) for t in range(R)}
    return (jax.device_get(state0), ids, draws, jax.device_get(mets),
            jax.device_get(r_unflatten(fst, loop.layout)))


def _port_setup(case, draws):
    name, over, server, part = CASES[case]
    scn = get_scenario(name, seed=SEED, draws=interop.draws_from_numpy(
        draws), **over)
    fed = FederatedDataset.build(get_task("easy", seed=SEED),
                                 num_clients=CLIENTS, alpha=ALPHA,
                                 seed=SEED, scenario=scn)
    _, logits_fn = make_small_model(tcfg.MLP_SMALL)
    kw = dict(scenario=scn, num_clients=CLIENTS,
              client_sizes=fed.client_sizes())
    return (fed, make_loss(_loss(logits_fn, softmax_ce)),
            get_server_opt(server), kw, part)


def _port_fused(case):
    state0_np, _, draws, _, _ = _reference(case)
    fed, loss, sopt, kw, part = _port_setup(case, draws)
    state0 = interop.fl_state_from_numpy(state0_np)
    loop = make_fl_loop(loss, get_client_opt("delta_sgd"), sopt,
                        params_like=state0.params, num_rounds=10,
                        rounds_per_call=R, gather=arena_gather, **kw)
    idx, _, _ = fed.sample_block(part, K, BATCH, round0=0, rounds=R)
    arena = {k: torch.from_numpy(v) for k, v in fed.arena().items()}
    tk.reset_launch_count()
    fst, mets = loop(flatten_fl_state(state0, loop.layout),
                     torch.from_numpy(idx), arena=arena)
    launches = dict(tk.LAUNCHES)
    return mets, unflatten_fl_state(fst, loop.layout), launches


def _port_host(case):
    state0_np, _, draws, _, _ = _reference(case)
    fed, loss, sopt, kw, part = _port_setup(case, draws)
    round_fn = make_fl_round(loss, get_client_opt("delta_sgd"), sopt,
                             num_rounds=10, flat=True, **kw)
    state = interop.fl_state_from_numpy(state0_np)
    rows = []
    for t in range(R):
        batches, _, _ = fed.sample_round(part, K, BATCH, round_idx=t)
        state, m, _ = round_fn(state, {k: torch.from_numpy(v)
                                       for k, v in batches.items()})
        rows.append(m)
    return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_async_loop_matches_reference(case):
    _, _, _, rmets, rfinal = _reference(case)
    mets, state, launches = _port_fused(case)
    assert set(mets) == set(rmets), (sorted(mets), sorted(rmets))
    for k in mets:
        got, want = mets[k].numpy(), np.asarray(rmets[k])
        if k in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            assert k in FLOAT, k
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    port_np = interop.fl_state_to_numpy(state)
    for tree in ("params", "server_state"):
        for a, b in zip(jax.tree_util.tree_leaves(getattr(rfinal, tree)),
                        jax.tree_util.tree_leaves(getattr(port_np, tree))):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5,
                                       atol=1e-6, err_msg=tree)
    rb, pb = rfinal.buffer, port_np.buffer
    for a, b in zip(jax.tree_util.tree_leaves(rb.delta),
                    tree_leaves(pb.delta)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pb.weight, rb.weight, rtol=1e-6)
    for f in ("count", "stale_sum", "stale_max"):
        np.testing.assert_array_equal(getattr(pb, f), getattr(rb, f))
    assert state.round == R
    assert launches == {("batched_norms", "cpu"): K * R,
                        ("batched_apply", "cpu"): K * R}


def test_async_cases_hold_and_flush():
    """The cases reach their branches: held and flushed rounds,
    byzantine and over-stale lanes, and a round below quorum."""
    for case in CASES:
        flushed = np.asarray(_reference(case)[3]["flushed"])
        assert 0.0 < flushed.sum() < R, (case, flushed)
    assert np.asarray(_reference("byzantine_async")[3]["byz_frac"]).max() > 0
    m = _reference("byzantine_async_overstale")[3]
    assert np.asarray(m["overstale_frac"]).max() > 0
    assert np.asarray(m["valid_count"]).min() < 3
    assert np.asarray(m["round_skipped"]).tolist() == [0.0, 0.0, 1.0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_async_fused_loop_equals_host_loop_bitwise(case):
    fmets, fstate, _ = _port_fused(case)
    hstate, hmets = _port_host(case)
    assert set(fmets) == set(hmets)
    for k in fmets:
        assert torch.equal(fmets[k], hmets[k]), k
    for a, b in zip(_leaves(fstate), _leaves(hstate)):
        assert torch.equal(a, b)


def _leaves(state):
    """Every tensor of an FLState: params, server state and buffer."""
    buf = state.buffer
    return (tree_leaves(state.params) + tree_leaves(state.server_state)
            + tree_leaves(buf.delta)
            + [buf.weight, buf.count, buf.stale_sum, buf.stale_max])


@pytest.mark.parametrize("server", ["fedavg", "fedadam"])
def test_buffer_merge_and_step_match_the_reference(server):
    """Merge, hold, merge, flush on the same inputs through both
    packages' functions: the same counts, weights, params and reset."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(6, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    deltas = [{k: rng.normal(size=v.shape).astype(np.float32)
               for k, v in params.items()} for _ in range(2)]
    stale = [np.asarray([0, 3, 1], np.int32), np.asarray([2, 4, 0],
                                                          np.int32)]
    rs, ps = r_sopt(server), get_server_opt(server)
    rp = jax.tree.map(jnp.asarray, params)
    pp = interop.params_from_numpy(params)
    rstate, pstate = rs.init(rp), ps.init(pp)
    rb, pb = rbuf.buffer_init(rp), buffer_init(pp)
    for d, s in zip(deltas, stale):
        rw = rbuf.staleness_weights(jnp.asarray(s), 0.5)
        pw = staleness_weights(torch.from_numpy(s), 0.5)
        np.testing.assert_allclose(pw.numpy(), np.asarray(rw), rtol=1e-6)
        rb = rbuf.buffer_merge(rb, jax.tree.map(jnp.asarray, d),
                               jnp.sum(rw), 3, jnp.asarray(s))
        pb = buffer_merge(pb, interop.params_from_numpy(d), pw.sum(), 3,
                          torch.from_numpy(s))
        rp, rstate, rb, rfl = rbuf.buffer_step(rp, rstate, rb, rs, 6)
        pp, pstate, pb, pfl = buffer_step(pp, pstate, pb, ps, 6)
        assert float(pfl) == float(rfl)
        assert int(pb.count) == int(rb.count)
        np.testing.assert_array_equal(pb.stale_sum.numpy(),
                                      np.asarray(rb.stale_sum))
        np.testing.assert_array_equal(pb.stale_max.numpy(),
                                      np.asarray(rb.stale_max))
        np.testing.assert_allclose(pb.weight.numpy(), np.asarray(rb.weight),
                                   rtol=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(rp), tree_leaves(pp)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)
    # the second merge reached M = 6: flushed, and the buffer reset
    assert float(pfl) == 1.0 and int(pb.count) == 0
    assert float(pb.weight) == 0.0
    assert all(float(v.abs().max()) == 0.0 for v in tree_leaves(pb.delta))


def _quad_setup(C=4, K_=3, D=24, seed=1):
    rng = np.random.default_rng(seed)

    def quad(p, batch):
        r = batch["A"] @ p["x"] - batch["b"]
        return 0.5 * torch.mean(r * r), {}
    batches = {"A": torch.from_numpy(rng.normal(size=(C, K_, 4, D)).astype(
                   np.float32)),
               "b": torch.from_numpy(rng.normal(size=(C, K_, 4)).astype(
                   np.float32))}
    x0 = torch.from_numpy(rng.normal(size=D).astype(np.float32))
    return make_loss(quad), batches, {"x": x0}


def test_async_degenerate_equals_sync_fedavg():
    """staleness ≡ 0 and M = C: a flush every round with unit weights,
    which is synchronous FedAvg (x + Σ Δ / C against mean x_c)."""
    loss, batches, params = _quad_setup()
    C = 4
    copt, sopt = get_client_opt("delta_sgd"), get_server_opt("fedavg")
    sync = make_fl_round(loss, copt, sopt, num_rounds=10, flat=True)
    scn = get_scenario("zipf_async", staleness_max=0, buffer_size=C,
                       speed="fixed")
    asy = make_fl_round(loss, copt, sopt, num_rounds=10, flat=True,
                        scenario=scn)
    st_s = init_fl_state(params, sopt)
    st_a = init_fl_state(params, sopt, scn)
    for _ in range(3):
        st_s, _, _ = sync(st_s, batches)
        st_a, ma, _ = asy(st_a, batches)
        assert float(ma["flushed"]) == 1.0
        assert float(ma["stale_max"]) == 0.0
    torch.testing.assert_close(st_a.params["x"], st_s.params["x"],
                               rtol=1e-6, atol=1e-6)


def test_async_held_round_keeps_params():
    loss, batches, params = _quad_setup(C=2, K_=2)
    sopt = get_server_opt("fedavg")
    scn = get_scenario("zipf_async", buffer_size=8)
    rnd = make_fl_round(loss, get_client_opt("delta_sgd"), sopt,
                        num_rounds=10, flat=True, scenario=scn)
    st = init_fl_state(params, sopt, scn)
    st, m, _ = rnd(st, batches)
    assert float(m["flushed"]) == 0.0
    assert torch.equal(st.params["x"], params["x"])
    assert float(m["buffer_fill"]) == 2.0
    assert int(st.buffer.count) == 2
    assert float(st.buffer.delta["x"].abs().max()) > 0.0


@pytest.mark.parametrize("server", ["fedavg", "fedadam"])
def test_async_round_buffers_and_flushes(server):
    """M = 2C: the server holds a round, then steps, with any ServerOpt;
    a held FedAdam round leaves its moments and step count alone."""
    loss, batches, params = _quad_setup(C=3, K_=2)
    sopt = get_server_opt(server)
    scn = get_scenario("zipf_async", buffer_size=6)
    rnd = make_fl_round(loss, get_client_opt("delta_sgd"), sopt,
                        num_rounds=10, flat=True, scenario=scn,
                        num_clients=12)
    st = init_fl_state(params, sopt, scn)
    flushes = []
    for _ in range(4):
        before = st
        st, m, _ = rnd(st, batches)
        flushes.append(float(m["flushed"]))
        assert 0.0 <= float(m["stale_mean"]) <= scn.staleness_max
        assert m["cohort_ids"].shape == (3,)
        if flushes[-1] == 0.0:
            for a, b in zip(tree_leaves(before.server_state),
                            tree_leaves(st.server_state)):
                assert torch.equal(a, b)
    assert flushes == [0.0, 1.0, 0.0, 1.0]
    if server == "fedadam":
        assert int(st.server_state["t"]) == 2
    assert bool(torch.isfinite(st.params["x"]).all())


def test_async_needs_the_flat_engine():
    loss, _, _ = _quad_setup()
    with pytest.raises(ValueError, match="flat engine"):
        make_fl_round(loss, get_client_opt("delta_sgd"),
                      get_server_opt("fedavg"), num_rounds=1,
                      scenario=get_scenario("zipf_async"))


def test_async_buffer_crosses_between_the_packages():
    """A reference FLState with a filled buffer -> the port -> back: the
    same bits, the round a Python int in the port."""
    state0_np, _, _, _, rfinal = _reference("zipf_async")
    port = interop.fl_state_from_numpy(rfinal)
    assert isinstance(port.buffer, AsyncBufferState)
    assert port.round == R and port.buffer.count.dtype == torch.int32
    back = interop.fl_state_to_numpy(port)
    for a, b in zip(jax.tree_util.tree_leaves(rfinal),
                    jax.tree_util.tree_leaves(tuple(back))):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_staleness_draw_is_keyed_on_the_round_and_replays():
    """U{0..staleness_max} from the (seed, round, 2) stream, the same on
    every call; staleness_max 0 draws zeros; a replay source wins."""
    scn = get_scenario("zipf_async", seed=3)
    a, b = scn.draw_staleness(5, 1000), scn.draw_staleness(5, 1000)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.int32 and a.min() == 0
    assert a.max() == scn.staleness_max
    assert not np.array_equal(a, scn.draw_staleness(6, 1000))
    assert not np.array_equal(a, get_scenario(
        "zipf_async", seed=4).draw_staleness(5, 1000))
    np.testing.assert_array_equal(get_scenario(
        "zipf_async", staleness_max=0).draw_staleness(0, 7), np.zeros(7))
    rec = np.asarray([4, 0, 2], np.int32)
    replay = get_scenario("zipf_async", draws=interop.draws_from_numpy(
        {0: {"staleness": rec}}))
    np.testing.assert_array_equal(replay.draw_staleness(0, 3), rec)
