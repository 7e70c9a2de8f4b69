"""Port parity for tensor-parallel training: gloo ranks on the CPU.

Four ranks of ``torch.distributed`` (gloo, one torch thread each) over a
(data 2, model 2) mesh run every case once, in one spawn for the module
(``tests/_torch_tp_train_worker.py``, torch only): one round of
``launch.steps.make_train_step``'s vmap engine (Δ-SGD, K = 2, FedAvg)
under the training rules, on reduced TinyLlama (its KV heads split over
``model``), Granite (MQA: the one KV head whole on every rank; the GELU
MLP's biases) and Qwen2.5 (QKV biases), 2 layers at d_model 64, from the
reference's params, with the reference's scenario draws where the case
has a scenario. ``cross_device`` puts one client on each data rank
(C = 2); ``cross_silo`` (one client, FSDP over ``data``) splits the
client's 4 rows over ``data``.

Each round is held against the reference's sharded ``make_train_step``,
jitted with ``make_param_shardings``, ``batch_shardings`` and
``_state_shardings`` under ``LogicalRules(serve=False)`` on an Auto-axes
(data 2, model 2) mesh of 4 of the conftest's 8 CPU devices (jax 0.9's
Explicit axes break the reference's sharded runs), and against the
port's unsharded round: loss and η within 1e-5 relative, the ranks'
round-end params, put together, within 1e-5·max|p| of each leaf. The
``model`` replicas of every replicated leaf are bitwise equal, the
collectives by role are ``train_collectives``', a ``cross_device``
round moves no param, and the kernel route launches 2·K kernels a rank.
"""
import functools
import pickle
from collections import Counter
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import FLConfig as JFLConfig
from repro.configs import get_config as jget_config
from repro.core import get_server_opt as r_sopt
from repro.core import init_fl_state as r_init
from repro.federation import get_scenario as r_scenario
from repro.launch.dryrun import _state_shardings as r_state_sh
from repro.launch.steps import make_train_step as r_make_train_step
from repro.models import build_model as jbuild_model
from repro.models.common import logical_rules as r_logical_rules
from repro.sharding.spec import LogicalRules as RRules
from repro.sharding.spec import batch_shardings as r_batch_sh
from repro.sharding.spec import get_federation_spec as r_fed
from repro.sharding.spec import make_param_shardings as r_param_sh
from repro_torch import interop
from repro_torch.configs import FLConfig
from repro_torch.core import init_fl_state
from repro_torch.federation import get_scenario
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build_model
from repro_torch.sharding import dist, hlo
from repro_torch.sharding.spec import get_federation_spec, local_block
from repro_torch.utils.tree import tree_flatten

from _torch_tp_train_worker import MESH, tp_config

needs8 = pytest.mark.skipif(jax.device_count() < 8,
                            reason="needs >= 8 host devices "
                                   "(XLA_FLAGS=--xla_force_host_platform"
                                   "_device_count=8)")
pytestmark = needs8

SHAPE = (2, 64, 512)             # layers, d_model, vocab
K, B, S = 2, 4, 16
REL = 1e-5
# name -> (arch, federation, remat, Δ-SGD kernel route, scenario)
CASES = {
    "tinyllama": ("tinyllama-1.1b", "cross_device", False, False, None),
    "tinyllama_remat": ("tinyllama-1.1b", "cross_device", True, False,
                        None),
    "tinyllama_kernel": ("tinyllama-1.1b", "cross_device", False, True,
                         None),
    "tinyllama_hetero": ("tinyllama-1.1b", "cross_device", False, False,
                         "dirichlet_stragglers"),
    "granite": ("granite-20b", "cross_device", False, False, None),
    "granite_silo": ("granite-20b", "cross_silo", True, False, None),
    "qwen_silo": ("qwen2.5-14b", "cross_silo", False, False, None),
}
CROSS_DEVICE = [n for n, c in CASES.items() if c[1] == "cross_device"]
OTHER_ARCHS = ("xlstm-1.3b",)
REFUSED_FL = {"sps": {"client_opt": "sps"},
              "fedprox": {"fedprox_mu": 0.1}}
METRICS = ("loss", "loss_last_step", "eta_mean", "eta_min", "eta_max")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one CPU thread while this module runs (its ops are
    small; eight threads a worker contend with the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ShapeMesh:
    shape = {"data": 2, "model": 2}


def _rmesh():
    return jax.make_mesh(MESH[0], MESH[1], axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])


def _clients(fed):
    return 2 if fed == "cross_device" else 1


@functools.lru_cache(maxsize=None)
def _inputs(arch, fed, scenario):
    """The reference's params, a round's batches and its scenario
    draws (cohort ids and step counts) for one case's inputs."""
    cfg = jget_config(arch).reduced(*SHAPE)
    params = jax.device_get(jbuild_model(cfg).init(jax.random.key(11)))
    C = _clients(fed)
    rng = np.random.default_rng(len(arch) + C)
    toks = rng.integers(0, cfg.vocab_size, (C, K, B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    draws = None
    if scenario is not None:
        scn = r_scenario(scenario)
        sch = scn.make_scheduler(JFLConfig().num_clients, C)
        draws = {0: {"step_counts": np.asarray(scn.draw_step_counts(0, C, K)),
                     "cohort_ids": np.asarray(sch.sample(
                         jax.random.key(scn.seed), 0))}}
    return params, batch, draws


def _case(name):
    arch, fed, remat, kern, scenario = CASES[name]
    params, batch, draws = _inputs(arch, fed, scenario)
    # the reference's initial FLState, as plain fields (the worker
    # imports nothing of the reference)
    state = jax.device_get(r_init(params, r_sopt("fedavg")))
    return dict(kind="round", cfg=(arch,) + SHAPE, federation=fed,
                params=params, state=SimpleNamespace(**state._asdict()),
                batch=batch, K=K, remat=remat, use_pallas=kern,
                scenario=scenario, draws=draws)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case on 4 gloo ranks, one spawn: {name: [rank results]}."""
    from _torch_tp_train_worker import run_rank
    tmp = tmp_path_factory.mktemp("tp_train_ranks")
    cases = {n: _case(n) for n in CASES}
    cases["refusals"] = dict(kind="refusals", archs=OTHER_ARCHS,
                             fl=REFUSED_FL)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"mesh": MESH, "cases": cases}, f)
    dist.spawn(run_rank, 4, (str(tmp / "in.pkl"), str(tmp)), device="cpu",
               threads=1)
    ranks = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    out = {n: [rk["cases"][n] for rk in ranks] for n in CASES}
    out["refusals"] = [rk["cases"]["refusals"] for rk in ranks]
    return out


@functools.lru_cache(maxsize=None)
def _reference_round(arch, fed, remat, scenario):
    """The reference's sharded round: (metrics, round-end params)."""
    params, batch, _ = _inputs(arch, fed, scenario)
    mesh = _rmesh()
    model = jbuild_model(jget_config(arch).reduced(*SHAPE))
    spec = r_fed(fed, mesh)
    step, sopt, scn, comp = r_make_train_step(
        model, JFLConfig(local_steps=K), remat=remat, scenario=scenario)
    state = r_init(params, sopt, scn, comp, _clients(fed))
    batch = jax.tree.map(jnp.asarray, batch)
    psh = r_param_sh(spec, mesh, state.params)
    ssh = r_state_sh(mesh, spec, state, psh)
    bsh = r_batch_sh(spec, mesh, batch)
    with mesh, r_logical_rules(RRules(spec, mesh, serve=False)):
        new, metrics = jax.jit(step, in_shardings=(ssh, bsh))(state, batch)
    return (jax.device_get(metrics), jax.device_get(new.params))


@pytest.fixture(scope="module")
def ref():
    return {n: _reference_round(c[0], c[1], c[2], c[4])
            for n, c in CASES.items()}


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded round on the same inputs: (metrics, params)."""
    out = {}
    for name, (arch, fed, remat, kern, scenario) in CASES.items():
        params, batch, draws = _inputs(arch, fed, scenario)
        model = build_model(tp_config(arch, *SHAPE))
        scn = (get_scenario(scenario, draws=interop.draws_from_numpy(draws))
               if scenario else None)
        step, sopt, scn, comp = make_train_step(
            model, FLConfig(local_steps=K), remat=remat, use_pallas=kern,
            scenario=scn)
        state = init_fl_state(interop.params_from_numpy(params), sopt, scn,
                              comp)
        new, metrics = step(state, interop.params_from_numpy(batch))
        out[name] = ({k: interop._to_numpy(v) for k, v in metrics.items()},
                     interop.params_to_numpy(new.params))
    return out


def _whole(name, results):
    """The ranks' round-end blocks of case ``name`` put together:
    ({path: whole leaf}, number of replica blocks that differ from the
    first in any bit)."""
    arch, fed, _, _, scenario = CASES[name]
    leaves0, treedef = tree_flatten(_inputs(arch, fed, scenario)[0])
    whole, differ = {}, 0
    for i, path in enumerate(treedef):
        leaf = torch.full(leaves0[i].shape, float("nan"))
        seen = torch.zeros(leaves0[i].shape, dtype=torch.bool)
        for res in results:
            ax = tree_flatten(res["axes"])[0][i]
            blk = torch.from_numpy(tree_flatten(res["params"])[0][i])
            view = local_block(leaf, ax, ShapeMesh, res["coord"])
            mark = local_block(seen, ax, ShapeMesh, res["coord"])
            if bool(mark.all()):
                differ += not torch.equal(view, blk)
            else:
                view.copy_(blk)
                mark.fill_(True)
        assert bool(seen.all()), path
        whole["/".join(path)] = leaf.numpy()
    return whole, differ


def _held(whole, params):
    want = dict(zip(("/".join(p) for p in tree_flatten(params)[1]),
                    tree_flatten(params)[0]))
    assert set(whole) == set(want)
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        tol = REL * float(np.abs(w).max())
        err = float(np.abs(whole[path] - w).max())
        assert err <= tol, f"{path}: {err} > {tol}"


def _metrics_held(got, want):
    for k in METRICS:
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) <= REL * abs(w), f"{k}: {g} vs {w}"
    for k in ("cohort_ids", "k_eff_mean"):
        if k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))


@pytest.mark.parametrize("name", list(CASES))
def test_tp_round_matches_the_references_sharded_step(name, port, ref):
    metrics, params = ref[name]
    for res in port[name]:
        _metrics_held(res["metrics"], metrics)
    whole, _ = _whole(name, port[name])
    _held(whole, params)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_round_matches_the_unsharded_port(name, port, unsharded):
    metrics, params = unsharded[name]
    for res in port[name]:
        _metrics_held(res["metrics"], metrics)
    whole, _ = _whole(name, port[name])
    _held(whole, params)


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_are_bitwise_equal_across_ranks(name, port):
    """Every replica of a leaf (the ``model`` ranks of a replicated
    leaf; the data ranks too under ``cross_device``, after FedAvg)
    holds the same bits: a replicated leaf read in part whose gradient
    were not summed over ``model`` would drift here."""
    _, differ = _whole(name, port[name])
    assert differ == 0


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_by_role_are_train_collectives(name, port):
    for res in port[name]:
        got = Counter(op[1] for op in res["ops"])
        assert dict(got) == res["want_ops"]
        # one op a stacked cohort: no op carries a per-client shape twice
        assert all(op[1] in hlo.TRAIN_ROLES for op in res["ops"])
        assert any(op[4] for op in res["ops"])     # backward ops recorded


@pytest.mark.parametrize("name", CROSS_DEVICE)
def test_cross_device_round_moves_no_param(name, port):
    spec = get_federation_spec("cross_device", ShapeMesh)
    for res in port[name]:
        ops = [hlo.CollectiveOp("all-reduce", 4, 2, op[2], role=op[1])
               for op in res["ops"]]
        rep = hlo.assert_no_param_gather(ops, spec, train=True)
        assert rep["roles"]["fedavg"] == 1 and rep["roles"]["metrics"] == 1


def test_kernel_route_launches_two_kernels_a_step(port):
    """The Δ-SGD kernel route on each rank's blocks: one batched_norms
    and one batched_apply a local step (their plain versions on the
    CPU), and one ``norms`` sum a step."""
    for res in port["tinyllama_kernel"]:
        assert res["launches"] == {("batched_norms", "cpu"): K,
                                   ("batched_apply", "cpu"): K}
        assert Counter(op[1] for op in res["ops"])["norms"] == K


def test_tp_training_refusals(port):
    for res in port["refusals"]:
        for arch in OTHER_ARCHS:
            # xLSTM trains under rules since its TP slice
            # (tests/test_torch_tp_xlstm.py): admitted
            assert res[arch] is None, (arch, res[arch])
        assert "under training rules" in res["prefill"]
        assert "sps under tensor-parallel rules" in res["sps"]
        assert "FedProx and MOON" in res["fedprox"]


def test_the_vmap_engine_keeps_its_scenario_refusals():
    """The scenarios the vmap engine refuses stay refused under rules:
    the make_fl_round checks run before any rule is read."""
    from repro_torch.core import get_client_opt, get_server_opt
    from repro_torch.core import make_fl_round
    for scn in ("zipf_async", "dirichlet_dropouts"):
        with pytest.raises(ValueError, match="flat engine"):
            make_fl_round(lambda *a: None, get_client_opt("delta_sgd"),
                          get_server_opt("fedavg"), num_rounds=2,
                          scenario=get_scenario(scn, robust_agg="trimmed"))
