"""Port parity for the sharded flat round on the ranks' tensor-parallel
blocks: gloo ranks on the CPU.

Four ranks of ``torch.distributed`` (gloo, one torch thread each) over a
(data 2, model 2) mesh run every case once, in one spawn for the module
(``tests/_torch_flat_tp_worker.py``, torch only): ``make_train_step``'s
flat round on the mesh (Δ-SGD, K = 2, FedAvg) under the training rules,
its local steps on each rank's TP slab (``core.sharded``), on reduced
TinyLlama (2 layers, d_model 64, vocab 512: its KV heads split over
``model``) and OLMoE (2 layers, d_model 64, 4 experts over ``model``),
from the reference's params and with the reference's scenario draws.
``cross_device`` puts C = 4 clients on the data ranks (2 a rank, N over
``model``); ``cross_silo`` puts C = 2 on every rank, N over ``data`` ×
``model``, each client's 4 rows split over ``data``.

Every scenario of the flat engine runs under both federations: plain,
heterogeneous K, async (FedBuff), int8 and top-k with EF21 under the
bandwidth-tiered levels, dropouts with NaN and byzantine lanes under the
trimmed mean and the median with quorum 2, and the R = 2 fused block.
Each is held against the reference's sharded flat round (its
``make_train_step`` with ``mesh`` and ``federation``, jitted on an
Auto-axes (data 2, model 2) mesh of 4 of the conftest's 8 CPU devices;
it gathers each client's model whole) and against the port's unsharded
flat round: loss and η within 1e-5 relative, the params (whole on every
rank) within 1e-5·max|p| of each leaf; under compression an element
may exceed that by its flip bound (``_flip_bound``: one code step of
each client's chunk, over C) on at most ``FLIP_SHARE`` of the model's
elements. The collectives by role are
``flat_train_collectives``', no local-step collective holds a client's
whole N, a local step makes the kernel pair's 2 launches, and the fused
block equals the per-round path bitwise. MOON on the paper's CNN (no
placement: the round's unplaced route) runs 2 rounds under both
federations, the second with the first's local params, against the
reference's sharded round and the unsharded port at the same bounds.
"""
import functools
import pickle
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.compression import CompressionSpec as RSpec
from repro.configs import FLConfig as JFLConfig
from repro.configs.paper_tasks import CNN_PAPER as R_CNN
from repro.configs import get_config as jget_config
from repro.core import get_client_opt as r_copt
from repro.core import get_server_opt as r_sopt
from repro.core import init_fl_state as r_init
from repro.core import make_fl_round as r_round
from repro.core import make_loss as r_make_loss
from repro.federation import get_scenario as r_scenario
from repro.launch.steps import make_train_step as r_make_train_step
from repro.models import build_model as jbuild_model
from repro.models.small import make_small_model as r_small
from repro.models.small import softmax_ce as r_ce
from repro.sharding.spec import get_federation_spec as r_fed
from repro_torch import interop
from repro_torch.compression import CompressionSpec
from repro_torch.configs import FLConfig
from repro_torch.configs.paper_tasks import CNN_PAPER
from repro_torch.core import flat as tflat
from repro_torch.core import (get_client_opt, get_server_opt, init_fl_state,
                              make_fl_round, make_loss)
from repro_torch.core.sharded import tp_slab
from repro_torch.federation import get_scenario
from repro_torch.launch.steps import make_train_step, train_rules
from repro_torch.models.model import build_model
from repro_torch.models.small import make_small_model, softmax_ce
from repro_torch.sharding import dist, hlo
from repro_torch.sharding.spec import FederationSpec, get_federation_spec
from repro_torch.utils.tree import tree_map

from _torch_flat_tp_worker import MESH, tp_config

needs8 = pytest.mark.skipif(jax.device_count() < 8,
                            reason="needs >= 8 host devices "
                                   "(XLA_FLAGS=--xla_force_host_platform"
                                   "_device_count=8)")
pytestmark = needs8

SHAPE = (2, 64, 512)             # layers, d_model, vocab
K, B, S = 2, 4, 16
REL = 1e-5
CLIENTS = {"cross_device": 4, "cross_silo": 2}
FAULTY = dict(quorum=2, byzantine_rate=0.1)
# scenario name -> (scenario (preset, overrides), compression, rounds,
# fused)
SCENARIOS = {
    "plain": (None, None, 1, False),
    "hetero": (("dirichlet_stragglers", {}), None, 1, False),
    "async": (("zipf_async", {}), None, 2, False),
    "int8_ef21": (("bandwidth_tiered", {}),
                  dict(kind="int8", error_feedback=True), 1, False),
    "topk_ef21": (("bandwidth_tiered", {}),
                  dict(kind="topk", error_feedback=True), 1, False),
    "trimmed": (("dirichlet_dropouts", dict(FAULTY, robust_agg="trimmed")),
                None, 1, False),
    "median": (("dirichlet_dropouts", dict(FAULTY, robust_agg="median")),
               None, 1, False),
    "fused": (None, None, 2, True),
    "fused_int8": (("bandwidth_tiered", {}),
                   dict(kind="int8", error_feedback=True), 2, True),
}
CASES = {f"tinyllama_{s}_{f}": ("tinyllama-1.1b", f, s)
         for s in SCENARIOS for f in CLIENTS}
CASES.update({f"olmoe_{s}_{f}": ("olmoe-1b-7b", f, s)
              for s in ("plain", "trimmed") for f in CLIENTS})
FUSED = [n for n, c in CASES.items() if SCENARIOS[c[2]][3]]
# MOON on the paper's CNN: case name -> federation
MOON = {f"moon_{f}": f for f in CLIENTS}
MOON_MU, MOON_R = 1.0, 2
METRICS = ("loss", "loss_last_step", "eta_mean", "eta_min", "eta_max")
EXACT = ("cohort_ids", "k_eff_mean", "valid_count", "round_skipped",
         "buffer_fill", "flushed", "comp_level_mean")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one CPU thread while this module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ShapeMesh:
    shape = {"data": 2, "model": 2}


def _rmesh():
    return jax.make_mesh(MESH[0], MESH[1], axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])


@functools.lru_cache(maxsize=None)
def _inputs(arch, fed, scenario):
    """The reference's params, R rounds of batches and the reference's
    scenario draws of one case."""
    scn, _, R, _ = SCENARIOS[scenario]
    cfg = jget_config(arch).reduced(*SHAPE)
    params = jax.device_get(jbuild_model(cfg).init(jax.random.key(7)))
    C = CLIENTS[fed]
    rng = np.random.default_rng(len(arch) + 3 * C + len(scenario))
    toks = rng.integers(0, cfg.vocab_size,
                        (R, C, K, B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    draws = None
    if scn is not None:
        rs = r_scenario(scn[0], **scn[1])
        sch = rs.make_scheduler(JFLConfig().num_clients, C)
        draws = {}
        for t in range(R):
            d = {"cohort_ids": np.asarray(sch.sample(
                jax.random.key(rs.seed), t))}
            if rs.heterogeneous:
                d["step_counts"] = np.asarray(rs.draw_step_counts(t, C, K))
            if rs.bandwidth_heterogeneous:
                d["levels"] = np.asarray(rs.draw_compression_levels(t, C))
            if rs.faulty:
                d["faults"] = tuple(np.asarray(x)
                                    for x in rs.draw_faults(t, C, K))
            if rs.is_async:
                d["staleness"] = np.asarray(rs.draw_staleness(t, C))
            draws[t] = d
    return params, batch, draws


def _case(name):
    arch, fed, scenario = CASES[name]
    scn, comp, R, fused = SCENARIOS[scenario]
    params, batch, draws = _inputs(arch, fed, scenario)
    return dict(kind="round", cfg=(arch,) + SHAPE, federation=fed,
                params=params, batch=batch, K=K, C=CLIENTS[fed], rounds=R,
                scenario=scn, draws=draws, compression=comp, fused=fused)


@functools.lru_cache(maxsize=None)
def _moon_inputs(fed):
    """The reference CNN's params and MOON_R rounds of (C, K, b) images."""
    init, _ = r_small(R_CNN)
    params = jax.device_get(init(jax.random.key(11)))
    C = CLIENTS[fed]
    rng = np.random.default_rng(29 + C)
    x = rng.normal(size=(MOON_R, C, K, B, R_CNN.image_size,
                         R_CNN.image_size, R_CNN.channels))
    y = rng.integers(0, R_CNN.num_classes, (MOON_R, C, K, B))
    return params, {"x": x.astype(np.float32), "y": y.astype(np.int32)}


def _moon_case(name):
    params, batch = _moon_inputs(MOON[name])
    return dict(kind="moon", federation=MOON[name], params=params,
                batch=batch, C=CLIENTS[MOON[name]], rounds=MOON_R,
                mu=MOON_MU)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case on 4 gloo ranks, one spawn: {name: [rank results]}."""
    from _torch_flat_tp_worker import run_rank
    tmp = tmp_path_factory.mktemp("flat_tp_ranks")
    cases = {n: _case(n) for n in CASES}
    cases.update({n: _moon_case(n) for n in MOON})
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"mesh": MESH, "cases": cases}, f)
    dist.spawn(run_rank, 4, (str(tmp / "in.pkl"), str(tmp)), device="cpu",
               threads=1)
    ranks = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {n: [rk["cases"][n] for rk in ranks] for n in cases}


@functools.lru_cache(maxsize=None)
def _reference_step(arch, fed, scn_key, comp_key):
    """The reference's jitted sharded flat round of one program (cases
    that differ only in their rounds share it): (step, sopt, scenario,
    compression)."""
    scn, comp = dict(scn_key)["scn"], dict(comp_key)["comp"]
    mesh = _rmesh()
    model = jbuild_model(jget_config(arch).reduced(*SHAPE))
    rscn = r_scenario(scn[0], **dict(scn[1])) if scn else None
    rcomp = RSpec(**dict(comp)) if comp else None
    step, sopt, rscn, rcomp = r_make_train_step(
        model, JFLConfig(local_steps=K, flat_engine=True), flat=True,
        mesh=mesh, federation=r_fed(fed, mesh), scenario=rscn,
        compression=rcomp)
    return jax.jit(step), sopt, rscn, rcomp


def _key(x):
    """A hashable form of a scenario or compression entry."""
    if isinstance(x, dict):
        return tuple(sorted(x.items()))
    if isinstance(x, tuple):
        return tuple(_key(v) for v in x)
    return x


@functools.lru_cache(maxsize=None)
def _reference(arch, fed, scenario):
    """The reference's sharded flat round, round after round: (metrics
    of each round, round-end params)."""
    scn, comp, R, _ = SCENARIOS[scenario]
    params, batch, draws = _inputs(arch, fed, scenario)
    run, sopt, rscn, rcomp = _reference_step(
        arch, fed, (("scn", _key(scn)),), (("comp", _key(comp)),))
    state = r_init(jax.tree.map(jnp.asarray, params), sopt, rscn, rcomp,
                   cohort=CLIENTS[fed])
    mets = []
    for t in range(R):
        state, m = run(state, jax.tree.map(lambda x: jnp.asarray(x[t]),
                                           batch))
        mets.append(jax.device_get(m))
    return mets, jax.device_get(state.params)


@functools.lru_cache(maxsize=None)
def _unsharded(arch, fed, scenario):
    """The port's unsharded flat round on the same inputs."""
    scn, comp, R, _ = SCENARIOS[scenario]
    params, batch, draws = _inputs(arch, fed, scenario)
    model = build_model(tp_config(arch, *SHAPE))
    pscn = (get_scenario(scn[0], draws=interop.draws_from_numpy(draws),
                         **scn[1]) if scn else None)
    pcomp = CompressionSpec(**comp) if comp else None
    step, sopt, pscn, pcomp = make_train_step(
        model, FLConfig(local_steps=K, flat_engine=True), flat=True,
        scenario=pscn, compression=pcomp)
    state = init_fl_state(interop.params_from_numpy(params), sopt, pscn,
                          pcomp, cohort=CLIENTS[fed])
    mets, params_t = [], []
    for t in range(R):
        state, m = step(state, interop.params_from_numpy(
            {k: v[t] for k, v in batch.items()}))
        mets.append({k: interop._to_numpy(v) for k, v in m.items()})
        params_t.append(interop.params_to_numpy(state.params))
    return mets, params_t


# a compressed round: the share of the model's elements that may lie
# beyond REL·max|p| of their leaf, where a client's int8 code or top-k
# choice fell the other way (its f32 sums differ in their last bits
# from the other program's); each such element within its flip bound
# (``_flip_bound``). These cases flip at most 37 of TinyLlama's 147,776
# (2.5e-4: fused_int8 under cross_device against the reference)
FLIP_SHARE = 1e-3


def _flip_bound(name, ranks):
    """Per round, the (N,) most the clients' flips may move the server's
    params at each element: a flip moves a client's shipped delta by
    one step of its 128-lane chunk, max|sent| / 127 under int8, the
    chunk's smallest kept |sent| under top-k (the swapped elements sit
    at the threshold), 0 uncompressed; ``sent`` is the change of the
    client's EF21 state in the round. Summed over the clients and the
    rounds so far (EF21 re-sends a flip the round after), over C."""
    arch, fed, scenario = CASES[name]
    draws = _inputs(arch, fed, scenario)[2]
    spec = get_federation_spec(fed, ShapeMesh)
    C = CLIENTS[fed]
    prev, total, out = 0.0, 0.0, []
    for t, efs in enumerate(zip(*(r["ef_t"] for r in ranks))):
        ef = tflat.gather_slab(
            [(r["coord"], torch.from_numpy(e)) for r, e in zip(ranks, efs)],
            ShapeMesh, spec).numpy()
        sent = np.abs(ef - prev).reshape(C, -1, tflat.LANES)
        kept = np.where(sent > 0, sent, np.inf).min(-1)
        level = draws[t]["levels"][:, None]
        step = np.where(level == 1, sent.max(-1) / 127.0,
                        np.where((level == 2) & np.isfinite(kept), kept,
                                 0.0))
        total = total + step.sum(0) / C
        out.append(np.repeat(total, tflat.LANES).astype(np.float32))
        prev = ef
    return out


def _held(got, want, bound=None):
    """Each leaf within REL·max|p|; with a flip ``bound`` ((N,) in the
    flat layout) each element within REL·max|p| plus its bound, and at
    most a ``FLIP_SHARE`` of the model's elements beyond REL·max|p|.
    Returns the count beyond."""
    bounds = None
    if bound is not None:
        like = interop.params_from_numpy(want)
        layout = tflat.layout_of(like, shards=1)
        bounds = _paths(tflat.unpack(torch.from_numpy(bound[:layout.size]),
                                     layout, cast=False))
    off = total = 0
    for path, w in _paths(want).items():
        g = np.asarray(_paths(got)[path], np.float32)
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max())
        err = np.abs(g - w)
        if bounds is None:
            assert float(err.max()) <= REL * scale, (
                f"{path}: {float(err.max())} > {REL * scale}")
            continue
        b = bounds[path].numpy().reshape(err.shape)
        assert bool((err <= REL * scale + b).all()), (
            f"{path}: {float((err - b).max())} beyond its flip bound")
        off += int((err > REL * scale).sum())
        total += err.size
    assert off <= FLIP_SHARE * max(total, 1), f"{off} of {total} off"
    return off


def _compressed(name):
    return SCENARIOS[CASES[name][2]][1] is not None


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{pre}/{k}" if pre else k))
        return out
    return {pre: tree}


def _metrics_held(got, want, what):
    for k in METRICS:
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) <= REL * abs(w), f"{what} {k}: {g} vs {w}"
    for k in EXACT:
        if k in want:
            np.testing.assert_array_equal(
                np.asarray(got[k], np.float64),
                np.asarray(want[k], np.float64), err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_flat_tp_round_matches_the_references_sharded_round(name, port):
    mets, params = _reference(*CASES[name])
    bound = _flip_bound(name, port[name])[-1] if _compressed(name) else None
    for res in port[name]:
        for t, (g, w) in enumerate(zip(res["metrics"], mets)):
            _metrics_held(g, w, f"{name} round {t}")
        _held(res["params"], params, bound)


# the sharded robust ladder takes its trimmed mean or median on each
# client shard and then the mean over the shards, as the reference's
# sharded round does: with clients on 2 data ranks the unsharded
# round's ladder is another function (the reference's round holds
# those cases)
UNSHARDED = [n for n, c in CASES.items()
             if not (c[1] == "cross_device"
                     and c[2] in ("trimmed", "median"))]


@pytest.mark.parametrize("name", UNSHARDED)
def test_flat_tp_round_matches_the_unsharded_port(name, port):
    """Each round against the port's unsharded flat round. Under
    compression the params are held after the first round only, within
    its flip bound: the unsharded round's f32 sums differ from the
    sharded one's in their last bits, so its clients' codes flip
    elsewhere than the reference's sharded round's, and the next round
    starts from other params everywhere (its local steps move every
    element a little, beyond any code step where no client sent one)."""
    mets, params_t = _unsharded(*CASES[name])
    bound = _flip_bound(name, port[name])[0] if _compressed(name) else None
    for res in port[name]:
        for t, (g, w) in enumerate(zip(res["metrics"], mets)):
            _metrics_held(g, w, f"{name} round {t}")
        for t, (g, w) in enumerate(zip(res["params_t"], params_t)):
            if t and bound is not None:
                break
            _held(g, w, bound)


@pytest.mark.parametrize("name", list(CASES))
def test_flat_tp_collectives_by_role(name, port):
    """Each round's collectives by role are ``flat_train_collectives``'
    (a quorum skip makes no ``flat_params`` gather), and every rank of
    the N-shard group holds each element once: the ranks' valid
    elements add up to the layout's."""
    for res in port[name]:
        for t, ops in enumerate(res["ops"]):
            want = dict(res["want_ops"])
            if float(res["metrics"][t].get("round_skipped", 0.0)):
                want.pop("flat_params")
            assert dict(Counter(op[1] for op in ops)) == want, (name, t)
    fed = CASES[name][1]
    per_group = {}
    for res in port[name]:
        c = res["coord"]
        key = c["data"] if fed == "cross_device" else 0
        per_group.setdefault(key, 0)
        per_group[key] += res["slab"]["valid"]
    for n in per_group.values():
        assert n == port[name][0]["slab"]["size"]


@pytest.mark.parametrize("name", list(CASES))
def test_no_local_step_collective_holds_a_clients_whole_n(name, port):
    C = CLIENTS[CASES[name][1]]
    for res in port[name]:
        size, N = res["slab"]["size"], res["slab"]["N"]
        for ops in res["ops"]:
            rec = [hlo.CollectiveOp(k, 0, 2, a, dt, sh, role=r, backward=b)
                   for k, r, a, sh, b, dt in ops]
            rep = hlo.assert_flat_buffer_sharded(rec, C, N, client_n=size)
            assert rep["client_whole_n"] == 0


@pytest.mark.parametrize("name", list(CASES))
def test_flat_tp_local_step_launches_two_kernels(name, port):
    for res in port[name]:
        for launches in res["launches"]:
            assert launches == {("batched_norms", "cpu"): K,
                                ("batched_apply", "cpu"): K}


@pytest.mark.parametrize("name", FUSED)
def test_fused_block_equals_the_per_round_path_bitwise(name, port):
    for res in port[name]:
        np.testing.assert_array_equal(res["fused_P"], res["host_P"])
        for k, v in res["fused_metrics"].items():
            for t in range(len(res["metrics"])):
                np.testing.assert_array_equal(
                    np.asarray(v[t]), np.asarray(res["metrics"][t][k]),
                    err_msg=f"round {t} {k}")


# ---------------------------------------------------------------- MOON
@functools.lru_cache(maxsize=None)
def _moon_reference(fed):
    """The reference's sharded flat round under MOON: (metrics, params)
    of each round, each round's prev the previous round's locals."""
    params, batch = _moon_inputs(fed)
    _, logits = r_small(R_CNN)
    loss = r_make_loss(lambda q, bt: (r_ce(logits(q, bt["x"]), bt["y"]), {}),
                       moon_mu=MOON_MU, repr_fn=lambda q, bt: logits(
                           q, bt["x"]))
    mesh, sopt = _rmesh(), r_sopt("fedavg")
    rnd = jax.jit(r_round(loss, r_copt("delta_sgd"), sopt, num_rounds=10,
                          flat="xla", mesh=mesh, federation=r_fed(fed, mesh)))
    state = r_init(jax.tree.map(jnp.asarray, params), sopt,
                   cohort=CLIENTS[fed])
    mets, params_t, prev = [], [], None
    for t in range(MOON_R):
        state, m, prev = rnd(state, jax.tree.map(
            lambda x: jnp.asarray(x[t]), batch), prev_local_params=prev)
        mets.append(jax.device_get(m))
        params_t.append(jax.device_get(state.params))
    return mets, params_t


@functools.lru_cache(maxsize=None)
def _moon_unsharded(fed):
    """The port's unsharded flat round under MOON on the same inputs."""
    params, batch = _moon_inputs(fed)
    _, logits = make_small_model(CNN_PAPER)
    loss = make_loss(lambda q, bt: (softmax_ce(logits(q, bt["x"]),
                                               bt["y"]), {}),
                     moon_mu=MOON_MU, repr_fn=lambda q, bt: logits(
                         q, bt["x"]))
    sopt = get_server_opt("fedavg")
    rnd = make_fl_round(loss, get_client_opt("delta_sgd"), sopt,
                        num_rounds=10, flat=True)
    state = init_fl_state(interop.params_from_numpy(params), sopt)
    mets, params_t, prev = [], [], None
    for t in range(MOON_R):
        state, m, prev = rnd(state, interop.params_from_numpy(
            {k: v[t] for k, v in batch.items()}), prev_local_params=prev)
        mets.append({k: interop._to_numpy(v) for k, v in m.items()})
        params_t.append(interop.params_to_numpy(state.params))
    return mets, params_t


@pytest.mark.parametrize("name", list(MOON))
def test_flat_moon_round_without_rules_matches_the_references(name, port):
    """MOON on the sharded flat round with no placement, each round
    against the reference's sharded round and the unsharded port."""
    for want in (_moon_reference(MOON[name]), _moon_unsharded(MOON[name])):
        for res in port[name]:
            for t, (g, w) in enumerate(zip(res["metrics"], want[0])):
                _metrics_held(g, w, f"{name} round {t}")
            for g, w in zip(res["params_t"], want[1]):
                _held(g, w)


def test_flat_moon_round_under_rules_is_refused():
    """Under training rules MOON stays refused on the sharded flat
    round, as on the vmap round."""
    from repro_torch.models.common import logical_rules
    model = build_model(tp_config("tinyllama-1.1b", *SHAPE))
    params = model.init(torch.Generator().manual_seed(0))
    mesh = dist.AbstractMesh({"data": 2, "model": 2})
    spec = get_federation_spec("cross_device", mesh)
    rules = train_rules(model, mesh, params, spec=spec)
    sopt = get_server_opt("fedavg")
    rnd = make_fl_round(make_loss(lambda q, bt: (q["final_norm"].sum(), {})),
                        get_client_opt("delta_sgd"), sopt, num_rounds=10,
                        flat=True, mesh=mesh, federation=spec)
    state = init_fl_state(params, sopt, cohort=4, mesh=mesh, federation=spec)
    prev = tree_map(lambda x: x[None].expand(2, *x.shape), params)
    with logical_rules(rules), pytest.raises(ValueError, match="MOON"):
        rnd(state, {"tokens": torch.zeros((2, K, B, S), dtype=torch.int32)},
            prev_local_params=prev)


# ---------------------------------------------------------------- the slab
def _slabs(arch, fed):
    """Every rank's TPSlab of a model's layout, on the abstract mesh."""
    model = build_model(tp_config(arch, *SHAPE))
    params = model.init(torch.Generator().manual_seed(0))
    out = []
    for d in range(2):
        for m in range(2):
            mesh = dist.AbstractMesh({"data": 2, "model": 2},
                                     {"data": d, "model": m})
            spec = get_federation_spec(fed, mesh)
            layout = tflat.layout_of(params, shards=spec.flat_shards(mesh))
            rules = train_rules(model, mesh, params, spec=spec,
                                coords={"data": d, "model": m})
            out.append(tp_slab(layout, mesh, spec, rules))
    return params, out


def test_an_unplaced_model_keeps_the_layouts_columns():
    """With no placement every leaf is in one group over every N-shard
    axis, whose pieces are the layout's contiguous (N_loc,) columns: the
    rank's TP slab is its ``local_slab``."""
    params = {"w": torch.randn(300), "b": torch.randn(7, 3)}
    for fed in CLIENTS:
        for d in range(2):
            for m in range(2):
                mesh = dist.AbstractMesh({"data": 2, "model": 2},
                                         {"data": d, "model": m})
                spec = get_federation_spec(fed, mesh)
                layout = tflat.layout_of(params,
                                         shards=spec.flat_shards(mesh))
                slab = tp_slab(layout, mesh, spec)
                P = tflat.pack(params, layout)
                want = tflat.local_slab(P, mesh, spec)
                assert slab.width == want.numel()
                torch.testing.assert_close(slab.cut(P), want, rtol=0,
                                           atol=0)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
@pytest.mark.parametrize("fed", list(CLIENTS))
def test_tp_slab_holds_each_element_once(arch, fed):
    """The ranks of an N-shard group cut their slabs from the whole
    params; put back by their shares, every element of the layout is
    held by exactly one rank, with its value, and each slab's width is
    a multiple of the kernels' lane width."""
    params, slabs = _slabs(arch, fed)
    layout = slabs[0].layout
    P = tflat.pack(params, layout)
    groups = ({d: slabs[2 * d:2 * d + 2] for d in range(2)}
              if fed == "cross_device" else {0: slabs})
    for group in groups.values():
        seen = torch.zeros(layout.padded_size, dtype=torch.int32)
        for slab in group:
            assert slab.width % tflat.LANES == 0
            row = slab.cut(P)
            idx = torch.arange(layout.padded_size, dtype=torch.float64)
            where = slab.cut(idx)
            for s in slab.slots:
                got = row[s.at:s.at + s.length]
                pos = where[s.at:s.at + s.length].long()
                seen[pos] += 1
                torch.testing.assert_close(got, P[pos], rtol=0, atol=0)
                assert not bool(row[s.at + s.length:s.at + s.piece].any())
        assert bool((seen[:layout.size] == 1).all())


def test_a_placement_over_a_client_axis_is_refused():
    """``expert_2d`` under ``cross_device`` cuts the experts over
    ``data``, a client axis of the flat round: refused."""
    model = build_model(tp_config("olmoe-1b-7b", *SHAPE))
    params = model.init(torch.Generator().manual_seed(0))
    mesh = dist.AbstractMesh({"data": 2, "model": 2})
    spec = FederationSpec(("data",), (), ("model",), expert_2d=True)
    layout = tflat.layout_of(params, shards=spec.flat_shards(mesh))
    rules = train_rules(model, mesh, params, spec=spec)
    with pytest.raises(ValueError, match="not N-shard axes"):
        tp_slab(layout, mesh, spec, rules)
