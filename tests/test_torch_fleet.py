"""Port parity for the fleet: the client arena (``federation/arena.py``),
``make_fleet_loop``, the data pipeline's registered regime and the
train CLI's fleet path.

  * ``arena_take`` is row indexing; ``arena_update`` writes exactly the
    sampled rows, so a never-sampled client keeps its bits
    (property tests, as the reference's ``tests/test_fleet.py``).
  * With ``num_registered`` equal to the data's client count and no η
    carry the fleet loop IS ``make_fl_loop``: bitwise the same state.
  * The arena's bookkeeping replays from the scheduler's draw; the η
    carry warm-starts returning clients; EF21 lives in the arena.
  * A live reference ``make_fleet_loop`` run with its cohort ids
    injected: metrics, params and arena within 1e-5 (counts exact).
  * The schedulers over 100,000 candidates; a cut and resumed fleet CLI
    run equals the uninterrupted one bitwise, arena included.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import flatten_fl_state as r_flatten
from repro.core import get_client_opt as r_copt
from repro.core import get_server_opt as r_sopt
from repro.core import init_fl_state as r_init
from repro.core import make_fleet_loop as r_fleet_loop
from repro.core import make_loss as r_make_loss
from repro.federation import arena_init as r_arena_init
from repro.federation import make_scheduler as r_make_scheduler
from repro_torch import interop
from repro_torch.checkpoint import restore
from repro_torch.compression import CompressionSpec
from repro_torch.core import (arena_gather, flatten_fl_state,
                              get_client_opt, get_server_opt, init_fl_state,
                              make_fl_loop, make_fleet_loop, make_loss)
from repro_torch.data.pipeline import FederatedDataset
from repro_torch.data.synthetic import get_task
from repro_torch.federation import (ClientArena, arena_init, arena_take,
                                    arena_update, get_scenario,
                                    make_scheduler)
from repro_torch.kernels.delta_sgd import delta_sgd as tk
from repro_torch.launch import train as ttrain
from repro_torch.utils.tree import tree_leaves

R, C, K, D, E = 4, 8, 3, 96, 18
M_BIG = 100_000


def _rand_arena(r, m, with_ef):
    return ClientArena(
        torch.from_numpy(r.normal(size=m).astype(np.float32)),
        torch.from_numpy(r.integers(0, 5, size=m).astype(np.int32)),
        torch.from_numpy(r.integers(-1, 7, size=m).astype(np.int32)),
        torch.from_numpy(r.normal(size=(m, 6)).astype(np.float32))
        if with_ef else None)


def _clone(arena):
    return ClientArena(*(None if a is None else a.clone() for a in arena))


def _fields(arena):
    return [a for a in arena if a is not None]


@settings(max_examples=25, deadline=None)
@given(m=st.integers(4, 64), k=st.integers(1, 8),
       seed=st.integers(0, 10_000), ef=st.integers(0, 1))
def test_arena_take_update_round_trip_property(m, k, seed, ef):
    k = min(k, m)
    r = np.random.default_rng(seed)
    ids = torch.from_numpy(r.choice(m, size=k, replace=False).astype(
        np.int32))
    arena = _rand_arena(r, m, bool(ef))
    ref = _clone(arena)
    rows = arena_take(arena, ids)
    for a, b in zip(_fields(rows), _fields(arena)):
        assert torch.equal(a, b[ids.long()])
    # an identity write-back changes no bit
    arena_update(arena, ids, rows)
    for a, b in zip(_fields(arena), _fields(ref)):
        assert torch.equal(a, b)
    # a changed write-back touches exactly the sampled rows
    arena_update(arena, ids, ClientArena(*(None if a is None else a + 1
                                            for a in rows)))
    touched = np.zeros(m, bool)
    touched[ids.numpy()] = True
    for a, b in zip(_fields(arena), _fields(ref)):
        np.testing.assert_array_equal(a.numpy()[~touched],
                                      b.numpy()[~touched])
        np.testing.assert_array_equal(a.numpy()[touched],
                                      b.numpy()[touched] + 1)


@settings(max_examples=15, deadline=None)
@given(m=st.integers(8, 48), rounds=st.integers(1, 6),
       seed=st.integers(0, 10_000))
def test_arena_never_sampled_rows_keep_their_bits_property(m, rounds, seed):
    r = np.random.default_rng(seed)
    arena = _rand_arena(r, m, with_ef=True)
    ref = _clone(arena)
    ever = np.zeros(m, bool)
    for _ in range(rounds):
        k = int(r.integers(1, max(2, m // 3)))
        ids = r.choice(m, size=k, replace=False).astype(np.int32)
        ever[ids] = True
        rows = arena_take(arena, torch.from_numpy(ids))
        arena_update(arena, torch.from_numpy(ids),
                     ClientArena(*(a * 2 + 1 for a in rows)))
    for a, b in zip(_fields(arena), _fields(ref)):
        np.testing.assert_array_equal(a.numpy()[~ever], b.numpy()[~ever])


def test_arena_init_shapes():
    a = arena_init(5, eta0=0.2)
    assert a.ef is None and a.eta.tolist() == [np.float32(0.2)] * 5
    assert a.rounds_seen.dtype == a.last_round.dtype == torch.int32
    assert a.last_round.tolist() == [-1] * 5
    assert arena_init(5, eta0=0.2, ef_width=256).ef.shape == (5, 256)


# ------------------------------------------------- fleet loop, quadratic
def _problem(rng, rounds=R):
    """Quadratic FL problem, a mixed f32/bf16 tree, stacked rounds (the
    reference's ``tests/test_fleet.py`` problem), as numpy."""
    batches = {"A": rng.normal(size=(rounds, C, K, 4, D)).astype(np.float32),
               "b": rng.normal(size=(rounds, C, K, 4)).astype(np.float32)}
    params = {"x": rng.normal(size=D).astype(np.float32),
              "e": rng.normal(size=E).astype(np.float32)}
    return params, batches


def _quad(p, batch):
    x32, e32 = p["x"].to(torch.float32), p["e"].to(torch.float32)
    r = batch["A"] @ x32 - batch["b"] + e32.sum() * 0.01
    return 0.5 * torch.mean(r * r) + 0.05 * torch.mean(e32 * e32), {}


def _r_quad(params, batch):
    x32 = params["x"].astype(jnp.float32)
    e32 = params["e"].astype(jnp.float32)
    r = batch["A"] @ x32 - batch["b"] + jnp.sum(e32) * 0.01
    return 0.5 * jnp.mean(r * r) + 0.05 * jnp.mean(e32 * e32), {}


def _port_params(params):
    p = interop.params_from_numpy(params)
    return {"x": p["x"], "e": p["e"].to(torch.bfloat16)}


def _setup(m, *, rounds=R, **kw):
    params_np, batches_np = _problem(np.random.default_rng(0), rounds)
    params = _port_params(params_np)
    batches = {k: torch.from_numpy(v) for k, v in batches_np.items()}
    copt, sopt = get_client_opt("delta_sgd"), get_server_opt("fedavg")
    loop = make_fleet_loop(make_loss(_quad), copt, sopt, params_like=params,
                           num_rounds=100, num_registered=m, **kw)
    f0 = flatten_fl_state(init_fl_state(params, sopt), loop.layout)
    return params, batches, copt, sopt, loop, f0


def _uniform_ids(m, seed, rounds=R):
    """(rounds, C) int32 ids of the uniform scheduler over m clients:
    the data pipeline's draw without a scenario."""
    sch = make_scheduler("uniform", num_clients=m, cohort=C)
    return np.stack([sch.sample(seed, t) for t in range(rounds)]).astype(
        np.int32)


def test_fleet_loop_without_eta_carry_is_make_fl_loop_bitwise():
    params, batches, copt, sopt, loop, f0 = _setup(500)
    tk.reset_launch_count()
    (ff, car), mf = loop((f0, arena_init(500, eta0=loop.eta0)), batches,
                         cohort_ids=torch.from_numpy(_uniform_ids(500, 7)))
    assert tk.LAUNCHES == {("batched_norms", "cpu"): K * R,
                           ("batched_apply", "cpu"): K * R}
    ref_loop = make_fl_loop(make_loss(_quad), copt, sopt,
                            params_like=params, num_rounds=100)
    fr, mr = ref_loop(f0, batches)
    assert torch.equal(ff.P, fr.P) and ff.round == fr.round == R
    for k in mr:
        assert torch.equal(mf[k], mr[k]), k
    assert ff.ef is None and ff.buffer is None


def test_fleet_loop_with_num_registered_equal_to_the_clients_is_fused():
    """Through the data pipeline: a fleet of num_clients registered
    clients, given the pipeline's cohorts, trains the fused loop's
    params bitwise."""
    from repro_torch.configs import paper_tasks as tcfg
    from repro_torch.models.small import make_small_model, softmax_ce
    task = get_task("easy", seed=3)
    init_fn, logits_fn = make_small_model(tcfg.MLP_SMALL)
    loss = make_loss(lambda q, b: (softmax_ce(logits_fn(q, b["x"]),
                                              b["y"]), {}))
    params = init_fn(3)
    copt, sopt = get_client_opt("delta_sgd"), get_server_opt("fedavg")
    out = {}
    for m in (None, 20):
        fed = FederatedDataset.build(task, num_clients=20, alpha=0.5,
                                     seed=3, num_registered=m)
        idx, _, ids = fed.sample_block(0.2, 2, 8, round0=0, rounds=3)
        arena = {k: torch.from_numpy(v) for k, v in fed.arena().items()}
        f0 = flatten_fl_state(init_fl_state(params, sopt),
                              make_fl_loop(loss, copt, sopt,
                                           params_like=params,
                                           num_rounds=10).layout)
        if m is None:
            loop = make_fl_loop(loss, copt, sopt, params_like=params,
                                num_rounds=10, gather=arena_gather)
            out[m] = loop(f0, torch.from_numpy(idx), arena=arena)
        else:
            loop = make_fleet_loop(loss, copt, sopt, params_like=params,
                                   num_rounds=10, num_registered=m,
                                   gather=arena_gather)
            (fst, car), mets = loop((f0, arena_init(m, eta0=loop.eta0)),
                                    torch.from_numpy(idx), arena=arena,
                                    cohort_ids=torch.from_numpy(ids))
            np.testing.assert_array_equal(mets["cohort_ids"].numpy(), ids)
            out[m] = (fst, mets)
    (fa, ma), (fb, mb) = out[None], out[20]
    assert torch.equal(fa.P, fb.P)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


def test_fleet_arena_bookkeeping_replays_from_the_scheduler():
    m = 200
    _, batches, _, _, loop, f0 = _setup(m)
    host_ids = _uniform_ids(m, 11)
    (_, ar), mets = loop((f0, arena_init(m, eta0=loop.eta0)), batches,
                         cohort_ids=torch.from_numpy(host_ids))
    np.testing.assert_array_equal(mets["cohort_ids"].numpy(), host_ids)
    counts = np.bincount(host_ids.ravel(), minlength=m)
    np.testing.assert_array_equal(ar.rounds_seen.numpy(), counts)
    last = np.full(m, -1, np.int32)
    for t in range(R):
        last[host_ids[t]] = t
    np.testing.assert_array_equal(ar.last_round.numpy(), last)
    never = counts == 0
    assert never.any()
    np.testing.assert_array_equal(ar.eta.numpy()[never],
                                  np.float32(loop.eta0))
    assert float(mets["revisit_frac"][0]) == 0.0
    assert 0.0 <= float(mets["revisit_frac"][-1]) <= 1.0


def test_fleet_eta_carry_warm_starts_returning_clients():
    """A small fleet: every client returns, and the warm-started η₀
    changes the trajectory; the arena keeps round-end η."""
    m, rounds = 12, 6
    ids = torch.from_numpy(_uniform_ids(m, 7, rounds))
    _, batches, _, _, loop_c, f0 = _setup(m, eta_carry=True, rounds=rounds)
    _, _, _, _, loop_n, _ = _setup(m, eta_carry=False, rounds=rounds)
    (fc, ac), mc = loop_c((f0, arena_init(m, eta0=loop_c.eta0)), batches,
                          cohort_ids=ids)
    (fn, _), _ = loop_n((f0, arena_init(m, eta0=loop_n.eta0)), batches,
                        cohort_ids=ids)
    assert float((fc.P - fn.P).abs().max()) > 0.0
    sampled = ac.rounds_seen.numpy() > 0
    assert np.any(ac.eta.numpy()[sampled] != np.float32(loop_c.eta0))
    assert bool(torch.isfinite(mc["eta_carry_mean"]).all())
    # round 0's cohort is cold: its carry is η₀ (the cohort mean is the
    # sum times f32(1/C), as XLA takes the reference's jnp.mean)
    np.testing.assert_allclose(float(mc["eta_carry_mean"][0]), loop_c.eta0,
                               rtol=1e-6)


def test_fleet_ef_lives_in_the_arena():
    m = 64
    scn = get_scenario("bandwidth_tiered")
    comp = CompressionSpec(kind="int8", error_feedback=True)
    _, batches, _, _, loop, f0 = _setup(m, rounds=2, scenario=scn,
                                        compression=comp)
    ids = torch.from_numpy(np.stack([scn.draw_cohort(t, m, C)
                                     for t in range(2)]))
    (ff, ar), _ = loop((f0, arena_init(m, eta0=loop.eta0,
                                       ef_width=loop.layout.padded_size)),
                       batches, cohort_ids=ids)
    assert ff.ef is None
    ef = ar.ef.numpy()
    sampled = ar.rounds_seen.numpy() > 0
    assert np.abs(ef[sampled]).max() > 0.0
    np.testing.assert_array_equal(ef[~sampled], 0.0)
    with pytest.raises(ValueError, match="EF slab"):
        loop((f0, arena_init(m, eta0=loop.eta0)), batches, cohort_ids=ids)


# --------------------------------------------- live reference parity
M_LIVE, ROUNDS_LIVE = 12, 5


@lru_cache(maxsize=None)
def _reference_fleet():
    """The reference's fleet loop with η carry on the quadratic (a small
    fleet, so clients return) -> (numpy ids, metrics, final P, arena)."""
    params_np, batches_np = _problem(np.random.default_rng(0), ROUNDS_LIVE)
    params = {"x": jnp.asarray(params_np["x"]),
              "e": jnp.asarray(params_np["e"], jnp.bfloat16)}
    batches = jax.tree.map(jnp.asarray, batches_np)
    copt = r_copt("delta_sgd", gamma=2.0, eta0=0.2, theta0=1.0, delta=0.1)
    sopt = r_sopt("fedavg")
    loop = r_fleet_loop(r_make_loss(_r_quad), copt, sopt,
                        params_like=params, num_rounds=100,
                        num_registered=M_LIVE, flat="xla", seed=7,
                        eta_carry=True)
    f0 = r_flatten(r_init(params, sopt), loop.layout)
    car = r_arena_init(M_LIVE, eta0=loop.eta0)
    (ff, ar), mets = jax.jit(loop)((f0, car), batches)
    return jax.device_get((mets, ff.P, ar))


def test_fleet_loop_matches_a_live_reference_run():
    mets, rP, rar = _reference_fleet()
    ids = torch.from_numpy(np.array(mets["cohort_ids"]))
    _, batches, _, _, loop, f0 = _setup(M_LIVE, rounds=ROUNDS_LIVE,
                                        eta_carry=True)
    (ff, ar), pm = loop((f0, arena_init(M_LIVE, eta0=loop.eta0)), batches,
                        cohort_ids=ids)
    assert set(pm) == set(mets)
    for k in pm:
        got, want = pm[k].numpy(), np.asarray(mets[k])
        if k in ("cohort_ids", "revisit_frac", "realized_stale_mean"):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=k)
    np.testing.assert_allclose(ff.P.numpy(), np.asarray(rP), rtol=1e-5,
                               atol=1e-6)
    port = interop.arena_to_numpy(ar)
    np.testing.assert_allclose(port.eta, rar.eta, rtol=1e-5)
    np.testing.assert_array_equal(port.rounds_seen, rar.rounds_seen)
    np.testing.assert_array_equal(port.last_round, rar.last_round)
    assert rar.ef is None and port.ef is None
    assert (np.asarray(rar.rounds_seen) > 1).any()   # clients returned


def test_arena_crosses_between_the_packages():
    _, _, rar = _reference_fleet()
    port = interop.arena_from_numpy(rar)
    assert port.rounds_seen.dtype == torch.int32 and port.ef is None
    back = interop.arena_to_numpy(port)
    for a, b in zip(jax.tree_util.tree_leaves(rar),
                    jax.tree_util.tree_leaves(tuple(back))):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


# --------------------------------------------- schedulers at fleet scale
@pytest.mark.parametrize("kind", ["uniform", "zipf", "cyclic",
                                  "size_weighted"])
def test_scheduler_over_100k_is_deterministic_and_distinct(kind):
    sizes = np.ones((M_BIG,), np.float32) if kind == "size_weighted" \
        else None
    sch = make_scheduler(kind, num_clients=M_BIG, cohort=64, sizes=sizes)
    a, b, c = sch.sample(3, 5), sch.sample(3, 5), sch.sample(3, 6)
    np.testing.assert_array_equal(a, b)
    assert len(np.unique(a)) == 64
    assert a.min() >= 0 and a.max() < M_BIG
    assert not np.array_equal(a, c)


def test_zipf_over_100k_is_skewed_as_the_reference_bounds_it():
    """The reference's bounds (tests/test_fleet.py), and the reference's
    own draw inside them, on 30 rounds of 64."""
    sch = make_scheduler("zipf", num_clients=M_BIG, cohort=64)
    ids = np.concatenate([sch.sample(0, t) for t in range(30)])
    assert np.mean(ids < M_BIG // 10) > 0.5
    assert ids.mean() < M_BIG / 4
    rsch = r_make_scheduler("zipf", num_clients=M_BIG, cohort=64)
    key = jax.random.key(0)
    rids = np.concatenate([np.asarray(rsch.sample(key, t))
                           for t in range(30)])
    assert np.mean(rids < M_BIG // 10) > 0.5 and rids.mean() < M_BIG / 4


def test_pipeline_maps_registered_ids_onto_partitions():
    fed = FederatedDataset.build(get_task("easy", seed=0), num_clients=8,
                                 alpha=0.5, seed=0, num_registered=32)
    assert fed.registered_clients == 32
    sizes = fed.registered_sizes()
    np.testing.assert_array_equal(sizes, np.tile(fed.client_sizes(), 4))
    take, w, ids = fed.sample_round_indices(0.25, 2, 4, round_idx=3)
    assert take.shape == (8, 2, 4) and ids.max() < 32
    for t, i in zip(take, ids):
        assert set(t.ravel()) <= set(fed.clients[i % 8])
    np.testing.assert_array_equal(w, fed.client_sizes()[ids % 8])
    with pytest.raises(ValueError, match="num_registered"):
        FederatedDataset.build(get_task("easy", seed=0), num_clients=8,
                               alpha=0.5, num_registered=4
                               ).registered_clients


# ------------------------------------------------------------ the CLI
def _fleet_cli(ckpt, rounds, *extra):
    return ttrain.main(["--device", "cpu", "--task", "easy", "--rounds",
                        str(rounds), "--rounds-per-call", "2",
                        "--num-clients", "8", "--num-registered", "32",
                        "--participation", "0.25", "--eta-carry", "--batch",
                        "128", "--ckpt-dir", ckpt, "--ckpt-every", "2",
                        "--seed", "0", *extra])


def test_fleet_cli_resume_equals_an_uninterrupted_run(tmp_path):
    ref, cut = str(tmp_path / "ref"), str(tmp_path / "cut")
    straight = _fleet_cli(ref, 4)
    _fleet_cli(cut, 2)
    resumed = _fleet_cli(cut, 2, "--resume")
    assert straight.state.round == resumed.state.round == 4
    for a, b in zip(tree_leaves(straight.state.params),
                    tree_leaves(resumed.state.params)):
        assert torch.equal(a, b)
    like = arena_init(32, eta0=0.2)
    ar, _ = restore(str(tmp_path / "ref" / "arena"), like=like, step=4)
    ac, _ = restore(str(tmp_path / "cut" / "arena"), like=like, step=4)
    for a, b in zip(_fields(ar), _fields(ac)):
        assert torch.equal(a, b)
    assert int(ac.rounds_seen.sum()) == 4 * 8


def test_fleet_cli_resume_without_an_arena_warns_and_starts_cold(tmp_path):
    """A checkpoint of a non-fleet run resumed as a fleet: a cold arena,
    with a warning."""
    d = str(tmp_path)
    ttrain.main(["--device", "cpu", "--task", "easy", "--rounds", "2",
                 "--num-clients", "8", "--participation", "0.25",
                 "--batch", "128", "--ckpt-dir", d, "--flat"])
    (tmp_path / "arena" / "step_00000001").mkdir(parents=True)
    with pytest.warns(UserWarning, match="cold arena"):
        out = _fleet_cli(d, 1, "--resume")
    assert out.state.round == 3


def test_fleet_runner_trains_the_cohorts_the_pipeline_drew():
    """The train CLI's block runner hands the fleet loop the ids the data
    pipeline gathered the block's batches for, whichever draw the
    pipeline makes: here a scheduler set on the dataset, which the
    scenario does not know."""
    args = ttrain.build_parser().parse_args(
        ["--device", "cpu", "--task", "easy", "--num-clients", "8",
         "--num-registered", "32", "--participation", "0.25", "--batch",
         "128", "--rounds", "2", "--rounds-per-call", "2"])
    pt = ttrain.setup_paper_task(args)
    pt.fed.scheduler = make_scheduler("zipf", num_clients=32, cohort=8)
    run = ttrain.BlockRunner(pt, args)
    fs = flatten_fl_state(ttrain.init_state(pt), run.layout)
    _, mets = run(fs, run.stage(0, 2))
    want = np.stack([pt.fed.scheduler.sample(pt.fed.seed, t)
                     for t in range(2)])
    np.testing.assert_array_equal(mets["cohort_ids"].numpy(), want)
    np.testing.assert_array_equal(run.clients.rounds_seen.numpy(),
                                  np.bincount(want.ravel(), minlength=32))


def test_fleet_batch_index_fn_computes_the_gather_from_the_drawn_ids():
    """``batch_index_fn(ids, round)`` builds each round's (C, K, b)
    indices from the cohort's ids on the device: the same run as staging
    those indices by hand."""
    m, rows_per_client = 40, 6
    rng = np.random.default_rng(5)
    arena = {"A": torch.from_numpy(rng.normal(size=(
                 m * rows_per_client, 4, D)).astype(np.float32)),
             "b": torch.from_numpy(rng.normal(size=(
                 m * rows_per_client, 4)).astype(np.float32))}

    def index_fn(ids, rnd):
        base = ids.long()[:, None, None] * rows_per_client
        step = torch.arange(K)[None, :, None]
        return base + (step + rnd) % rows_per_client

    params, _, copt, sopt, _, f0 = _setup(m)
    kw = dict(params_like=params, num_rounds=100, num_registered=m)
    by_fn = make_fleet_loop(make_loss(_quad), copt, sopt,
                            batch_index_fn=index_fn, **kw)
    staged = make_fleet_loop(make_loss(_quad), copt, sopt,
                             gather=arena_gather, **kw)
    ids = torch.from_numpy(_uniform_ids(m, 3))
    idx = torch.stack([index_fn(ids[r], r) for r in range(R)])
    (fa, aa), ma = by_fn((f0, arena_init(m, eta0=by_fn.eta0)), None,
                         arena=arena, cohort_ids=ids)
    (fb, ab), mb = staged((f0, arena_init(m, eta0=staged.eta0)), idx,
                          arena=arena, cohort_ids=ids)
    assert torch.equal(fa.P, fb.P)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for x, y in zip(_fields(aa), _fields(ab)):
        assert torch.equal(x, y)
