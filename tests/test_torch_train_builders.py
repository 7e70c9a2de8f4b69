"""The training step builders, ``abstract_fl_state``, the dry run's
``train_4k`` and its ``--scenario-smoke``.

The port's ``launch/steps.py`` builders resolve the scenario, the
compression and the engine from an ``FLConfig`` exactly as the
reference's do (both packages' ``make_fl_round`` calls captured);
``abstract_fl_state`` has the reference's shapes and dtypes for the
plain, async and EF21 states. TinyLlama-1.1B's ``train_4k`` round runs
for one rank of the abstract (data 32, model 8) mesh on fake tensors:
its ``analytic_memory`` is the reference's function on the reference's
placements, its counted FLOPs are within 1 % of the forward, backward
and remat recompute terms derived here for the rank's blocks, and its
collectives are ``train_collectives``'. ``--scenario-smoke`` runs the
reference's five sharded flat variants on 8 gloo CPU ranks.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import INPUT_SHAPES as R_SHAPES
from repro.configs import FLConfig as RFL
from repro.configs import get_config as jget_config
from repro.launch import steps as rsteps
from repro.launch.dryrun import analytic_memory as r_analytic
from repro.models import build_model as jbuild_model
from repro.sharding import spec as rspec
from repro_torch import core
from repro_torch.configs import FLConfig, get_config
from repro_torch.launch import dryrun, steps
from repro_torch.launch.specs import params_struct
from repro_torch.models.model import build_model
from repro_torch.sharding import dist

ARCH = "tinyllama-1.1b"
SMALL = (2, 64, 512)
FLS = {
    "plain": {},
    "flat": {"flat_engine": True},
    "async": {"scenario": "zipf_async"},
    "hetero": {"scenario": "dirichlet_stragglers"},
    "trimmed": {"robust_agg": "trimmed"},
    "quorum": {"quorum": 2, "scenario": "dirichlet_dropouts"},
    "int8_ef": {"compression": "int8", "error_feedback": True},
    "topk_tiered": {"compression": "topk", "compression_k_frac": 0.5,
                    "scenario": "bandwidth_tiered"},
    "weighted": {"weighted_agg": True, "client_opt": "adam"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spy(monkeypatch, module, name):
    seen = {}

    def fake(loss_fn, copt, sopt, **kw):
        seen.update(kw, client_opt=copt.name, server_opt=sopt.name)
        return lambda *a, **k: None

    monkeypatch.setattr(module, name, fake)
    return seen


def _resolved(seen):
    scn, comp = seen["scenario"], seen["compression"]
    return {"flat": seen["flat"], "weighted": seen["weighted"],
            "num_clients": seen["num_clients"],
            "mesh": seen["mesh"], "federation": seen["federation"],
            "scenario": None if scn is None else (
                scn.name, scn.robust_agg, scn.quorum, scn.is_async),
            "compression": (comp.kind, comp.k_frac, comp.error_feedback),
            "client_opt": seen["client_opt"]}


@pytest.mark.parametrize("name", list(FLS))
def test_make_train_step_resolves_as_the_reference(name, monkeypatch):
    r_seen = _spy(monkeypatch, rsteps, "make_fl_round")
    p_seen = _spy(monkeypatch, core, "make_fl_round")
    kw = FLS[name]
    rmodel = jbuild_model(jget_config(ARCH).reduced(*SMALL))
    pmodel = build_model(get_config(ARCH).reduced(*SMALL))
    for use_pallas in (False, True):
        _, rs, rscn, rcomp = rsteps.make_train_step(
            rmodel, RFL(**kw), use_pallas=use_pallas)
        _, ps, pscn, pcomp = steps.make_train_step(
            pmodel, FLConfig(**kw), use_pallas=use_pallas)
        assert _resolved(p_seen) == _resolved(r_seen)
        assert ps.name == rs.name
        assert (None if pscn is None else pscn.name) == \
            (None if rscn is None else rscn.name)
        assert (pcomp.kind, pcomp.error_feedback) == (rcomp.kind,
                                                      rcomp.error_feedback)


def test_builders_refuse_as_the_reference():
    pmodel = build_model(get_config(ARCH).reduced(*SMALL))
    rmodel = jbuild_model(jget_config(ARCH).reduced(*SMALL))
    bad = {"client_opt": "adam", "flat_engine": True}
    for mk, model, fl in ((rsteps.make_train_step, rmodel, RFL(**bad)),
                          (steps.make_train_step, pmodel, FLConfig(**bad))):
        with pytest.raises(ValueError, match="client_opt='delta_sgd'"):
            mk(model, fl)
    with pytest.raises(ValueError, match="fleet regime"):
        steps.make_fleet_train_loop(pmodel, FLConfig())
    fleet = FLConfig(num_clients=10, num_registered_clients=100)
    with pytest.raises(ValueError, match="cohort_ids"):
        steps.make_fleet_train_loop(pmodel, fleet, seed=3)
    loop, _, _, _ = steps.make_fleet_train_loop(pmodel, fleet)
    assert fleet.clients_per_round == RFL(
        num_clients=10, num_registered_clients=100).clients_per_round
    loop, sopt, scn, comp = steps.make_train_loop(pmodel, FLConfig(),
                                                  rounds_per_call=2)
    assert loop.layout.size == sum(p.numel() for p in
                                   torch.utils._pytree.tree_leaves(
                                       params_struct(pmodel)))


@pytest.mark.parametrize("kind", ["plain", "async", "ef21"])
def test_abstract_fl_state_is_the_references(kind):
    from repro.compression import CompressionSpec as RComp
    from repro.core import get_server_opt as r_sopt
    from repro.federation import get_scenario as r_scn
    from repro_torch.compression import CompressionSpec
    from repro_torch.core import get_server_opt
    from repro_torch.federation import get_scenario
    scn = rs = comp = rc = None
    if kind == "async":
        scn, rs = get_scenario("zipf_async"), r_scn("zipf_async")
    if kind == "ef21":
        comp = CompressionSpec(kind="int8", error_feedback=True)
        rc = RComp(kind="int8", error_feedback=True)
    rmodel = jbuild_model(jget_config(ARCH).reduced(*SMALL), jnp.bfloat16)
    pmodel = build_model(get_config(ARCH).reduced(*SMALL), torch.bfloat16)
    want = rsteps.abstract_fl_state(rmodel, r_sopt("fedadam"), rs, rc, 4)
    got = steps.abstract_fl_state(pmodel, get_server_opt("fedadam"), scn,
                                  comp, 4)
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = {}
    from repro_torch.utils.tree import tree_flatten
    for field, sub in zip(got._fields, got):
        if field == "round" or sub is None:
            continue
        subs = sub._asdict() if hasattr(sub, "_asdict") else {"": sub}
        for f2, s2 in subs.items():
            leaves, treedef = tree_flatten(s2)
            for path, leaf in zip(treedef, leaves):
                gl[(field, f2) + path] = (tuple(leaf.shape),
                                          str(leaf.dtype).split(".")[-1])
    assert got.round == 0
    shapes = sorted(v for v in gl.values())
    ref = sorted((tuple(l.shape), str(l.dtype)) for p, l in wl
                 if not (len(p) == 1 and getattr(p[0], "name", "")
                         == "round"))
    assert shapes == ref


@pytest.fixture(scope="module")
def train_4k():
    return dryrun.lower_one(ARCH, "train_4k", False, verbose=False)


def _train_flops(cfg):
    """One rank's matmul FLOPs of a train_4k round at (data 32, model 8),
    K = 2, remat on: a client's 8 rows of 4,096 tokens through its
    block of every layer (query heads, MLP units; the 4 KV heads whole)
    and the plain route's full S×S attention, forward (F), again in the
    backward (remat's recompute) and twice for the backward's two
    products; the head's vocab block at every position once forward and
    twice back."""
    D, L, hd = cfg.d_model, cfg.num_layers, cfg.head_dim
    h, f, v = cfg.num_heads // 8, cfg.d_ff // 8, cfg.padded_vocab // 8
    b, S = 256 // 32, 4096
    tokens = b * S
    n_layer = D * h * hd + 2 * D * cfg.num_kv_heads * hd + h * hd * D \
        + 3 * D * f
    blocks = L * (2 * n_layer * tokens + 2 * 2 * b * h * S * S * hd)
    head = 2 * D * v * tokens
    return 2 * (4 * blocks + 3 * head)


def test_train_4k_runs_on_fake_tensors_and_counts_its_work(train_4k):
    res, cfg = train_4k, get_config(ARCH)
    assert (res["mesh"], res["chips"], res["federation"], res["clients"],
            res["step_kind"], res["remat"], res["local_steps"]) == (
        "32x8", 256, "cross_device", 32, "train", True, 2)
    want = _train_flops(cfg)
    assert abs(res["roofline"]["flops"] - want) <= 0.01 * want
    model = build_model(cfg, torch.bfloat16)
    mesh = dist.AbstractMesh({"data": 32, "model": 8})
    rules = steps.train_rules(model, mesh, params_struct(model))
    assert res["collectives"] == steps.train_collectives(
        model, rules, local_steps=2, remat=True)
    assert res["memory"]["argument_size_in_bytes"] > \
        res["analytic_memory"]["params_dev"] > 0


def test_train_4k_memory_is_the_references(train_4k):
    rm = AbstractMesh((32, 8), ("data", "model"))
    jmodel = jbuild_model(jget_config(ARCH), jnp.bfloat16)
    pstruct = jax.eval_shape(jmodel.init, jax.random.key(0))
    spec = rspec.get_federation_spec("cross_device", rm)
    psh = rspec.make_param_shardings(spec, rm, pstruct)
    want = r_analytic(jmodel.cfg, R_SHAPES["train_4k"], spec, rm, pstruct,
                      psh, RFL())
    assert train_4k["analytic_memory"] == want


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "xlstm-1.3b"])
def test_train_4k_refuses_the_other_archs(arch):
    # the MoE decoders lower since their TP slice, Zamba2 since its
    # own, xLSTM since its own; heads that do not split over 8 ranks
    # stay out
    dryrun.check_lowerable(arch, "train_4k", False)
    if arch == "olmoe-1b-7b":
        dryrun.check_lowerable("zamba2-7b", "train_4k", False)
    with pytest.raises(dryrun.Refused, match="heads do not split"):
        dryrun.check_lowerable("whisper-tiny", "train_4k", False)
    dryrun.check_lowerable("granite-20b", "train_4k", True)


def test_scenario_smoke_passes_all_five_variants():
    rows = dryrun.scenario_smoke(verbose=False)
    assert [r["variant"] for r in rows] == [
        "flat_fed_hetero", "flat_fed_async", "flat_fed_compressed",
        "flat_fed_rounds_fused", "flat_fed_faults"]
    assert [r["C"] for r in rows] == [4, 4, 8, 4, 16]
    assert all(r["full_shape"] == 0 and r["loss_finite"] for r in rows)
    assert [r.get("fullprec") for r in rows] == [None, None, 0, None, 0]
