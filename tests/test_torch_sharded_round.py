"""Port parity for the multi-device federation: gloo ranks on the CPU.

Four ranks of ``torch.distributed`` (gloo, one torch thread each) over a
(data 2, model 2) mesh run every case once, in one spawn for the module
(``tests/_torch_dist_worker.py``, torch only). Each case is held
against the reference's SHARDED engine on a (data 2, model 2) mesh of 4
of the conftest's 8 CPU devices, built here with Auto axis types
(jax 0.9's ``jax.make_mesh`` defaults to Explicit axes, which the
reference's ``with_sharding_constraint`` refuses). The configurations
are the reference's own sharded tests': ``tests/test_flat.py`` (the step
and the cross_device / cross_silo rounds), ``tests/test_compression.py``
(int8 and top-k with EF21 on bandwidth_tiered), ``tests/test_faults.py``
(the faulty robust round; trimmed, median and clip),
``tests/test_federation.py`` (stragglers, zipf_async) and
``tests/test_fed_loop.py`` (the fused loop; here the block path).
The reference's scenario draws are replayed into the port
(``interop.draws_from_numpy``). Tolerances: 1e-5 for params, the loss
and η; counts exact; the block path equals the per-round path bitwise.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.compression import CompressionSpec as RSpec
from repro.core import flat as rflat
from repro.core import flatten_fl_state as r_flatten
from repro.core import get_client_opt as r_copt
from repro.core import get_server_opt as r_sopt
from repro.core import init_fl_state as r_init
from repro.core import make_fl_loop as r_loop
from repro.core import make_fl_round as r_round
from repro.core import make_loss as r_make_loss
from repro.core.delta_sgd import flat_delta_sgd_init as r_sinit
from repro.core.delta_sgd import flat_delta_sgd_step_sharded as r_step
from repro.federation import get_scenario as r_scenario
from repro.sharding.spec import FederationSpec as RFed
from repro.sharding.spec import get_federation_spec as r_fed
from repro_torch.core import flat as tflat
from repro_torch.core.sharded import round_collectives
from repro_torch.sharding import dist
from repro_torch.sharding.spec import FederationSpec, get_federation_spec

needs8 = pytest.mark.skipif(jax.device_count() < 8,
                            reason="needs >= 8 host devices "
                                   "(XLA_FLAGS=--xla_force_host_platform"
                                   "_device_count=8)")
pytestmark = needs8

GAMMA, DELTA, ETA0, THETA0 = 2.0, 0.1, 0.2, 1.0
MESH = ((2, 2), ("data", "model"))
C, K = 8, 3
TOL = dict(rtol=1e-5, atol=1e-5)


class ShapeMesh:
    """The (data 2, model 2) mesh's sizes, for the port's spec functions
    in this process."""
    shape = {"data": 2, "model": 2}


def _rmesh():
    return jax.make_mesh(MESH[0], MESH[1],
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])


def _rquad(params, batch):
    x32 = params["x"].astype(jnp.float32)
    if "e" not in params:
        r = batch["A"] @ x32 - batch["b"]
        return 0.5 * jnp.mean(r * r), {}
    e32 = params["e"].astype(jnp.float32)
    r = batch["A"] @ x32 - batch["b"] + jnp.sum(e32) * 0.01
    return 0.5 * jnp.mean(r * r) + 0.05 * jnp.mean(e32 * e32), {}


def _problem(seed, R, D, E, rows, same_batches):
    """numpy params and (R, C, K, rows, ...) batches of the reference
    tests' quadratic problem (bf16 leaf e when E > 0)."""
    rng = np.random.default_rng(seed)
    shape = (1 if same_batches else R, C, K, rows)
    A = rng.normal(size=shape + (D,)).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    if same_batches:
        A, b = np.repeat(A, R, 0), np.repeat(b, R, 0)
    params = {"x": rng.normal(size=D).astype(np.float32)}
    if E:
        params["e"] = np.asarray(jnp.asarray(rng.normal(size=E),
                                             jnp.bfloat16))
    return params, {"A": A, "b": b}


def _draws(scn, R, num_clients):
    rounds = {}
    for t in range(R):
        d = {}
        if scn.heterogeneous:
            d["step_counts"] = scn.draw_step_counts(t, C, K)
        if scn.bandwidth_heterogeneous:
            d["levels"] = scn.draw_compression_levels(t, C)
        if scn.faulty:
            d["faults"] = tuple(scn.draw_faults(t, C, K))
        if scn.is_async:
            d["staleness"] = scn.draw_staleness(t, C)
        if num_clients is not None:
            d["cohort_ids"] = scn.make_scheduler(num_clients, C).sample(
                jax.random.key(scn.seed), t)
        rounds[t] = jax.device_get(d)
    return rounds


FLAT = dict(D=300, E=40, rows=8, same_batches=True)        # test_flat
FAULTS = dict(D=48, E=0, rows=4, same_batches=False)       # test_faults
LOOP = dict(D=96, E=18, rows=4, same_batches=False)        # test_fed_loop
FAULTY = dict(drop_rate=0.3, nan_rate=0.1, byzantine_rate=0.2,
              trim_frac=0.3, quorum=2)

# name -> (federation, problem, rounds, scenario (name, overrides),
# compression, num_clients, telemetry)
ROUNDS = {
    "cross_device": ("cross_device", FLAT, 2, None, None, None, False),
    "cross_silo": ("cross_silo", FLAT, 2, None, None, None, False),
    "telemetry": ("cross_device", FLAT, 1, None, None, None, True),
    "int8_ef21": ("cross_device", FLAT, 2, ("bandwidth_tiered", {}),
                  dict(kind="int8", error_feedback=True), None, False),
    "topk_ef21": ("cross_device", FLAT, 2, ("bandwidth_tiered", {}),
                  dict(kind="topk", error_feedback=True), None, False),
    "trimmed": ("cross_device", FAULTS, 2,
                ("sync_iid", dict(FAULTY, robust_agg="trimmed")), None, None,
                False),
    "median": ("cross_device", FAULTS, 2,
               ("sync_iid", dict(FAULTY, robust_agg="median")), None, None,
               False),
    "clip": ("cross_device", FAULTS, 2,
             ("sync_iid", dict(FAULTY, robust_agg="clip")), None, None,
             False),
    "stragglers": ("cross_device", FLAT, 3, ("dirichlet_stragglers", {}),
                   None, 20, False),
    "zipf_async": ("cross_device", FLAT, 3, ("zipf_async", {}), None, 20,
                   False),
}
# block path: clients over (data, model), N whole
LOOPS = {
    "plain": (None, None, None),
    "stragglers": (("dirichlet_stragglers", {}), None, 20),
    "zipf_async": (("zipf_async", {}), None, 20),
    "int8_ef21": (("bandwidth_tiered", {}),
                  dict(kind="int8", error_feedback=True), 20),
    "telemetry": (None, None, None),
}
LOOP_R = 4


def _mixed_tree(rng):
    return {"emb": np.asarray(jnp.asarray(rng.normal(size=(33, 7)),
                                          jnp.bfloat16)),
            "w": rng.normal(size=(129,)).astype(np.float32),
            "b": rng.normal(size=(5, 3, 2)).astype(np.float32)}


def _step_inputs(masked):
    """Global (C, N) params and 3 gradients packed with the reference's
    sharded layout (test_flat's sharded-step configuration)."""
    rng = np.random.default_rng(3 if masked else 4)
    tree = _mixed_tree(rng)
    if not masked:
        tree["emb"] = tree["emb"].astype(np.float32)
    jt = jax.tree.map(jnp.asarray, tree)
    lay = rflat.layout_of(jt, shards=2)
    P0 = np.asarray(jnp.stack([rflat.pack(jt, lay)] * C))
    Gs = []
    for _ in range(3):
        gt = jax.tree.map(lambda l: jnp.asarray(
            rng.normal(size=(C,) + l.shape), l.dtype), jt)
        Gs.append(np.asarray(rflat.pack_batched(
            gt, rflat.layout_of(gt, batched=True, shards=2))))
    mask = rflat.round_mask(lay)
    return dict(kind="step", fed="cross_device", P0=P0, Gs=Gs,
                mask=None if mask is None else np.asarray(mask),
                hyper=(GAMMA, DELTA, ETA0, THETA0))


def _round_case(name):
    fed, prob, R, scn, comp, ncl, tele = ROUNDS[name]
    params, batches = _problem(11, R, **prob)
    case = dict(kind="round", fed=fed, C=C, params=params, batches=batches,
                rounds=R, scenario=scn, compression=comp, num_clients=ncl,
                telemetry=tele)
    if scn is not None:
        case["draws"] = _draws(r_scenario(scn[0], **scn[1]), R, ncl)
    return case


def _loop_case(name):
    scn, comp, ncl = LOOPS[name]
    params, batches = _problem(17, LOOP_R, **LOOP)
    case = dict(kind="loop", fed="clients_only", C=C, params=params,
                batches=batches, rounds=LOOP_R, scenario=scn,
                compression=comp, num_clients=ncl,
                telemetry=name == "telemetry")
    if scn is not None:
        case["draws"] = _draws(r_scenario(scn[0], **scn[1]), LOOP_R, ncl)
    return case


@pytest.fixture(scope="module")
def cases():
    out = {"step_masked": _step_inputs(True),
           "step_f32": _step_inputs(False)}
    out.update({f"round_{n}": _round_case(n) for n in ROUNDS})
    out.update({f"loop_{n}": _loop_case(n) for n in LOOPS})
    params, batches = _problem(5, 1, **FLAT)
    out["refusals"] = dict(kind="refusals", params=params, batches=batches)
    return out


@pytest.fixture(scope="module")
def port(cases, tmp_path_factory):
    """Every case on 4 gloo ranks, one spawn: {case: [rank results]}
    and the ranks' mesh coordinates."""
    from _torch_dist_worker import run_rank
    tmp = tmp_path_factory.mktemp("ranks")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"mesh": MESH, "cases": cases}, f)
    dist.spawn(run_rank, 4, (str(tmp / "in.pkl"), str(tmp)), device="cpu",
               threads=1)
    ranks = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {name: [(rk["coord"], rk["cases"][name]) for rk in ranks]
            for name in cases}


def _gather(rows, key, fed):
    """The ranks' local blocks of ``key`` -> the global array."""
    fspec = (FederationSpec(("data", "model"), (), ())
             if fed == "clients_only" else get_federation_spec(fed,
                                                               ShapeMesh))
    return tflat.gather_slab({c: torch.from_numpy(np.asarray(res[key]))
                              for c, res in rows}, ShapeMesh,
                             fspec).numpy()


# ----------------------------------------------------------------- step
@pytest.fixture(scope="module")
def ref_step(cases):
    mesh = _rmesh()
    spec = r_fed("cross_device", mesh)
    out = {}
    for name in ("step_masked", "step_f32"):
        cs = cases[name]
        N = cs["P0"].shape[1]
        lay = rflat.FlatLayout(None, (), N, N, 2)
        P, S = jnp.asarray(cs["P0"]), r_sinit(C, lay, eta0=ETA0,
                                              theta0=THETA0)
        mask = None if cs["mask"] is None else jnp.asarray(cs["mask"])
        for G in cs["Gs"]:
            P, S = r_step(P, jnp.asarray(G), S, gamma=GAMMA, delta=DELTA,
                          eta0=ETA0, mesh=mesh, pspec=spec.flat_spec(mesh),
                          mask=mask, backend="xla")
        out[name] = (np.asarray(P), np.asarray(S.eta))
    return out


@pytest.mark.parametrize("name", ["step_masked", "step_f32"])
def test_sharded_step_matches_reference(name, port, ref_step):
    rows = port[name]
    P = _gather(rows, "P", "cross_device")
    want_P, want_eta = ref_step[name]
    np.testing.assert_allclose(P, want_P, **TOL)
    eta = np.zeros(C, np.float32)
    for coord, res in rows:
        eta[coord[0] * 4:(coord[0] + 1) * 4] = res["eta"]
    np.testing.assert_allclose(eta, want_eta, rtol=1e-5)


@pytest.mark.parametrize("name", ["step_masked", "step_f32"])
def test_sharded_step_one_norms_all_reduce_a_step(name, port):
    """Per step and rank: one (2, C_loc) sum over ``model``, and the
    kernel pair on the local slab (2 launches)."""
    for _, res in port[name]:
        assert [o[:5] for o in res["ops"]] == [
            ("all-reduce", 2 * 4, ("model",), "sum", False)] * 3
        assert all(o[5] == (2, 4) for o in res["ops"])
        assert sum(res["launches"].values()) == 2 * 3


# ---------------------------------------------------------------- rounds
@pytest.fixture(scope="module")
def ref_rounds(cases):
    mesh = _rmesh()
    out = {}
    loss = r_make_loss(_rquad)
    copt, sopt = r_copt("delta_sgd"), r_sopt("fedavg")
    for name in ROUNDS:
        cs = cases[f"round_{name}"]
        fed = r_fed(cs["fed"], mesh)
        scn = (r_scenario(cs["scenario"][0], **cs["scenario"][1])
               if cs["scenario"] else None)
        comp = RSpec(**cs["compression"]) if cs["compression"] else None
        rnd = jax.jit(r_round(loss, copt, sopt, num_rounds=10, flat="xla",
                              mesh=mesh, federation=fed, scenario=scn,
                              num_clients=cs["num_clients"],
                              compression=comp, telemetry=cs["telemetry"]))
        params = jax.tree.map(jnp.asarray, cs["params"])
        st = r_init(params, sopt, scn, compression=comp, cohort=C)
        mets = []
        for t in range(cs["rounds"]):
            st, m, loc = rnd(st, jax.tree.map(
                lambda x, t=t: jnp.asarray(x[t]), cs["batches"]))
            mets.append(jax.device_get(m))
        lay = rflat.layout_of(params, shards=fed.flat_shards(mesh))
        out[name] = dict(
            params=jax.device_get(st.params), metrics=mets,
            loc=np.asarray(rflat.pack_batched(loc, lay)),
            ef=(None if st.ef is None
                else np.asarray(rflat.pack_batched(st.ef, lay))))
    return out


FLOAT_METRICS = ("loss", "loss_last_step", "eta_mean", "eta_min", "eta_max",
                 "wire_bytes", "comp_ratio", "agg_clip_rate", "stale_mean",
                 "loss_deciles")
EXACT_METRICS = ("cohort_ids", "valid_count", "round_skipped", "drop_frac",
                 "byz_frac", "k_eff_mean", "k_eff_min", "k_eff_max",
                 "nan_guard_rate", "eta_clip_rate", "comp_level_mean",
                 "eta_hist", "eta_clip_count", "nan_guard_count",
                 "buffer_fill", "flushed", "stale_max")


def _check_metrics(got, want, what):
    for k in want:
        assert k in got, f"{what}: metric {k} missing"
        g = np.asarray(got[k], np.float64)
        w = np.asarray(want[k], np.float64)
        if k in EXACT_METRICS:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        else:
            assert k in FLOAT_METRICS, k
            np.testing.assert_allclose(g, w, **TOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", list(ROUNDS))
def test_sharded_round_matches_reference(name, port, ref_rounds):
    rows = port[f"round_{name}"]
    want = ref_rounds[name]
    fed = ROUNDS[name][0]
    for _, res in rows:
        # params and metrics are whole on every rank
        for k in want["params"]:
            np.testing.assert_allclose(
                np.asarray(res["params"][k], np.float32),
                np.asarray(want["params"][k], np.float32), **TOL)
        for t, (g, w) in enumerate(zip(res["metrics"], want["metrics"])):
            _check_metrics(g, w, f"{name} round {t}")
    np.testing.assert_allclose(_gather(rows, "loc", fed), want["loc"], **TOL)
    if want["ef"] is not None:
        np.testing.assert_allclose(_gather(rows, "ef", fed), want["ef"],
                                   **TOL)


def _flat_n(case):
    params = case["params"]
    n = sum(int(np.prod(v.shape)) for v in params.values())
    return n, tflat._padded(n, 2 if case["fed"] == "cross_device" else 4)


@pytest.mark.parametrize("name", list(ROUNDS))
def test_sharded_round_collectives(name, port, cases):
    """Each round's recorded collectives: the count the round's shape
    gives (``round_collectives``), one norms all_reduce per local step
    over the N-shard axes, and no (C, N) payload and no (C_loc, N_loc)
    f32 payload across the client axes."""
    from repro_torch.sharding import hlo
    cs = cases[f"round_{name}"]
    fed = get_federation_spec(cs["fed"], ShapeMesh)
    ca, na = fed.flat_axes(ShapeMesh)
    c_loc, S = C // fed.clients_on(ShapeMesh), fed.flat_shards(ShapeMesh)
    scn = r_scenario(*cs["scenario"][:1], **cs["scenario"][1]) \
        if cs["scenario"] else None
    robust = None
    if scn is not None and (scn.faulty or scn.robust or scn.quorum > 0):
        robust = scn.robust_model.kind
    _, N = _flat_n(cs)
    for _, res in port[f"round_{name}"]:
        for t, ops_t in enumerate(res["ops"]):
            skipped = bool(res["metrics"][t].get("round_skipped", 0.0))
            ops = [hlo.CollectiveOp(k, e * 4, g, a, "float32", sh, o, st)
                   for k, e, a, o, st, sh, g in ops_t]
            assert len(ops) == round_collectives(
                c_loc, K, S, client_axes=bool(ca), robust=robust,
                skipped=skipped, deciles=bool(cs["telemetry"])), (
                    name, t, ops_t)
            norms = [o for o in ops if o.shape == (2, c_loc)]
            assert len(norms) == K and all(o.axes == na for o in norms)
            hlo.assert_flat_buffer_sharded(ops, C, N)
            if c_loc >= 2 and ca:
                hlo.assert_no_fullprec_delta_collective(
                    ops, C, N, mesh=ShapeMesh, federation=fed)


# ------------------------------------------------------------ block path
@pytest.fixture(scope="module")
def ref_loops(cases):
    mesh = _rmesh()
    fed = RFed(client_axes=("data", "model"), fsdp_axes=(), tp_axes=())
    loss = r_make_loss(_rquad)
    copt, sopt = r_copt("delta_sgd"), r_sopt("fedavg")
    out = {}
    for name in LOOPS:
        cs = cases[f"loop_{name}"]
        scn = (r_scenario(cs["scenario"][0], **cs["scenario"][1])
               if cs["scenario"] else None)
        comp = RSpec(**cs["compression"]) if cs["compression"] else None
        params = jax.tree.map(jnp.asarray, cs["params"])
        loop = r_loop(loss, copt, sopt, params_like=params, num_rounds=10,
                      rounds_per_call=LOOP_R, flat="xla", mesh=mesh,
                      federation=fed, scenario=scn,
                      num_clients=cs["num_clients"], compression=comp,
                      block_sharded=True, telemetry=cs["telemetry"])
        st = r_init(params, sopt, scn, compression=comp, cohort=C)
        f, m = jax.jit(loop)(r_flatten(st, loop.layout),
                             jax.tree.map(jnp.asarray, cs["batches"]))
        out[name] = (np.asarray(f.P), jax.device_get(m))
    return out


@pytest.mark.parametrize("name", list(LOOPS))
def test_block_path_equals_per_round_path_bitwise(name, port):
    for _, res in port[f"loop_{name}"]:
        np.testing.assert_array_equal(res["block_P"], res["host_P"])
        if res["block_ef"] is not None:
            np.testing.assert_array_equal(res["block_ef"], res["host_ef"])
        for t, m in enumerate(res["host_metrics"]):
            # the block path reports no loss_deciles, as the reference's
            assert set(m) - set(res["block_metrics"]) == (
                {"loss_deciles"} if "eta_hist" in m else set())
            assert set(res["block_metrics"]) <= set(m)
            for k, v in res["block_metrics"].items():
                np.testing.assert_array_equal(
                    np.asarray(v[t]), np.asarray(m[k]),
                    err_msg=f"round {t} {k}")


@pytest.mark.parametrize("name", list(LOOPS))
def test_block_path_matches_reference_block(name, port, ref_loops):
    want_P, want_m = ref_loops[name]
    for _, res in port[f"loop_{name}"]:
        np.testing.assert_allclose(res["block_P"], want_P, **TOL)
        for t in range(LOOP_R):
            _check_metrics({k: v[t] for k, v in res["block_metrics"].items()},
                           {k: v[t] for k, v in want_m.items()},
                           f"{name} round {t}")


@pytest.mark.parametrize("name", list(LOOPS))
def test_block_path_two_collectives_a_round(name, port, cases):
    """One packed sum of (N + 5,) elements ((N + 5 + B,) with telemetry)
    and one (2,) min a round; 2·K kernel launches a round."""
    cs = cases[f"loop_{name}"]
    n = sum(int(np.prod(v.shape)) for v in cs["params"].values())
    N = tflat._padded(n)
    B = 16 if cs["telemetry"] else 0
    for _, res in port[f"loop_{name}"]:
        want = [("all-reduce", N + 5 + B, ("data", "model"), "sum", False),
                ("all-reduce", 2, ("data", "model"), "min", False)]
        assert [o[:5] for o in res["block_ops"]] == want * LOOP_R
        assert sum(res["launches"].values()) == 2 * K * LOOP_R


# -------------------------------------------------------------- refusals
REFUSALS = {
    "block_without_mesh": "block_sharded=True requires mesh= and federation=",
    "block_flat_shards": "flat_shards == 1, got 2",
    "block_robust": "not supported on the block-sharded path",
    "mesh_without_federation": "mesh and federation must be given together",
    "mesh_vmap_engine": "requires the flat engine",
    "eta0_c_under_mesh": "the fleet loop runs un-meshed",
    "layout_shards": "layout has shards=1, the mesh needs shards=2",
    "cohort_split": "cohort C=7 must divide the 2 client shards",
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_sharded_refusals(what, port):
    for _, res in port["refusals"]:
        msg = res[what]
        assert msg is not None and msg.startswith("ValueError"), msg
        assert REFUSALS[what] in msg, msg
