"""Port parity for tensor parallelism of the MoE and MLA decoders: gloo
ranks on the CPU.

Four ranks of ``torch.distributed`` (gloo, one torch thread each) over a
(data 2, model 2) mesh run every case once, in one spawn for the module
(``tests/_torch_tp_moe_worker.py``, torch only), on OLMoE-1B-7B and
DeepSeek-V3 at ``reduced()`` (2 layers, d_model 256, 4 experts, top-2;
MLA ranks 64/32/16; DeepSeek's shared expert and MTP block on), the
reference's params, batches and prompts injected:

  * serving: 4 prompts of 16 tokens (2 rows a data rank), 4
    teacher-forced decode steps, 4 greedy ones, held against the
    reference's jitted prefill and decode on an Auto-axes (data 2,
    model 2) mesh of 4 of the conftest's 8 CPU devices (as
    ``tests/test_torch_tp_serve.py`` builds it) and against the port's
    unsharded steps; the collectives by role are ``serve_collectives``';
    DeepSeek's latent cache holds the same bits on both ``model`` ranks;
    one prompt alone stays whole on both data ranks: no capacity count
    crosses ``data``, and every rank's logits are the unsharded
    port's one-row run's (which drops choices at the served capacity);
  * training: one vmap round of Δ-SGD (K = 2) under the training rules
    (``cross_device``: a client a data rank; ``cross_silo``: one client
    whose 4 rows split over ``data``, so the capacity counts and the aux
    loss cross ``data``), held against the reference's sharded
    ``make_train_step`` and the port's unsharded round: loss and η
    within 1e-5 relative, params within 1e-5·max|p| a leaf, every
    replicated leaf's ``model`` replicas bitwise equal, the collectives
    ``train_collectives``';
  * the capacity order: a batch whose router favours one expert, for
    which a per-rank cumsum would keep a choice that the global order
    drops (asserted), and the port's layer output follows the global
    order (the reference's ``apply_moe`` on the whole batch);
  * the aux loss and the gradients of a fixed loss through one MoE
    layer under ``cross_silo`` training rules against the unsharded
    port's; the MTP gather's gradient (``dist.gather_split``) against
    the unsharded port's, and ``gather_from``'s tp times it;
  * the refusal of xLSTM (Zamba2, Whisper and InternVL2 are admitted:
    tests/test_torch_tp_hybrid.py, tests/test_torch_tp_enc.py).
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
from repro.launch.dryrun import _state_shardings as r_state_sh
from repro.launch.steps import make_train_step as r_make_train_step
from repro.models import build_model as jbuild_model
from repro.models import moe as rmoe
from repro.models.common import logical_rules as r_logical_rules
from repro.sharding.spec import LogicalRules as RRules
from repro.sharding.spec import batch_shardings as r_batch_sh
from repro.sharding.spec import cache_shardings as r_cache_sh
from repro.sharding.spec import get_federation_spec as r_fed
from repro.sharding.spec import make_param_shardings as r_param_sh
from repro.sharding.spec import serve_batch_shardings as r_sbatch_sh
from repro_torch import interop
from repro_torch.configs import FLConfig
from repro_torch.core import init_fl_state
from repro_torch.launch import dryrun
from repro_torch.launch.steps import (make_train_step, place_for_rank,
                                      serve_collectives, serve_rules,
                                      train_rules)
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.sharding import dist, hlo
from repro_torch.sharding.spec import get_federation_spec, local_block
from repro_torch.utils.tree import tree_flatten

from _torch_tp_moe_worker import MESH, tp_config

needs8 = pytest.mark.skipif(jax.device_count() < 8,
                            reason="needs >= 8 host devices "
                                   "(XLA_FLAGS=--xla_force_host_platform"
                                   "_device_count=8)")
pytestmark = needs8

SHAPE = (2, 256, 512)            # layers, d_model, vocab: reduced()
B, S, FORCED, GREEDY = 4, 16, 4, 4
K, TB = 2, 4                     # local steps, rows a client
REL = 1e-5
# name -> (arch, federation)
SERVE = {"olmoe": ("olmoe-1b-7b", "cross_device"),
         "deepseek": ("deepseek-v3-671b", "cross_silo")}
# name -> (arch, federation, remat, Δ-SGD kernel route)
ROUNDS = {"olmoe_device": ("olmoe-1b-7b", "cross_device", False, False),
          "olmoe_silo_remat": ("olmoe-1b-7b", "cross_silo", True, False),
          "deepseek_silo": ("deepseek-v3-671b", "cross_silo", False, False),
          "deepseek_device_kernel": ("deepseek-v3-671b", "cross_device",
                                     False, True)}
METRICS = ("loss", "loss_last_step", "eta_mean", "eta_min", "eta_max")
REFUSED = ("xlstm-1.3b",)


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


def _jcfg(arch):
    return jget_config(arch).reduced(*SHAPE)


@functools.lru_cache(maxsize=None)
def _params(arch):
    return jax.device_get(jbuild_model(_jcfg(arch)).init(jax.random.key(3)))


@functools.lru_cache(maxsize=None)
def _prompts(arch):
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, _jcfg(arch).vocab_size,
                        (B, S + FORCED)).astype(np.int32)
    return toks[:, :S], toks[:, S:]


@functools.lru_cache(maxsize=None)
def _round_batch(arch, fed):
    C = 2 if fed == "cross_device" else 1
    rng = np.random.default_rng(len(arch) + C)
    toks = rng.integers(0, _jcfg(arch).vocab_size,
                        (C, K, TB, S + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


@functools.lru_cache(maxsize=None)
def _layer_inputs():
    """OLMoE's params with layer 0's router leaning to expert 0 (every
    token picks it: 64 choices for a capacity of 40), its input (4, 16,
    256) and the fixed cotangent R of the gradient case."""
    params = jax.tree.map(np.array, _params("olmoe-1b-7b"))
    router = params["stack"]["run0"]["moe"]["router"]
    router[0, :, 0] += 0.05
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((B, S, SHAPE[1])) + 0.5).astype(np.float32)
    r = rng.standard_normal((B, S, SHAPE[1])).astype(np.float32)
    return params, x, r


@functools.lru_cache(maxsize=None)
def _split_input():
    rng = np.random.default_rng(9)
    return (rng.standard_normal((B, S, 8)).astype(np.float32),
            rng.standard_normal((B, S, 8)).astype(np.float32))


def _cases():
    cases = {}
    for name, (arch, fed) in SERVE.items():
        p, f = _prompts(arch)
        cases[f"serve_{name}"] = dict(
            kind="serve", cfg=(arch,) + SHAPE, federation=fed,
            params=_params(arch), prompts=p, forced=f, greedy=GREEDY,
            keep_cache=True)
        cases[f"row1_{name}"] = dict(
            kind="serve", cfg=(arch,) + SHAPE, federation=fed,
            params=_params(arch), prompts=p[:1], forced=f[:1],
            greedy=GREEDY)
    for name, (arch, fed, remat, kern) in ROUNDS.items():
        params = _params(arch)
        state = jax.device_get(r_init(params, r_sopt("fedavg")))
        cases[name] = dict(kind="round", cfg=(arch,) + SHAPE,
                           federation=fed, params=params,
                           state=SimpleNamespace(**state._asdict()),
                           batch=_round_batch(arch, fed), K=K, remat=remat,
                           use_pallas=kern, scenario=None, draws=None)
    params, x, r = _layer_inputs()
    for name, serve, fed in (("layer_serve", True, "cross_device"),
                             ("layer_train", False, "cross_silo")):
        cases[name] = dict(kind="layer", cfg=("olmoe-1b-7b",) + SHAPE,
                           federation=fed, serve=serve, params=params, x=x,
                           r=r)
    x, r = _split_input()
    cases["gather_split"] = dict(kind="gather_split", x=x, r=r)
    return cases


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case on 4 gloo ranks, one spawn: {name: [rank results]}."""
    from _torch_tp_moe_worker import run_rank
    tmp = tmp_path_factory.mktemp("tp_moe_ranks")
    cases = _cases()
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"mesh": MESH, "cases": cases}, f)
    dist.spawn(run_rank, 4, (str(tmp / "in.pkl"), str(tmp)), device="cpu",
               threads=1)
    ranks = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {n: [rk["cases"][n] for rk in ranks] for n in cases}


def _rows(results, key, t=None):
    """The whole batch's rows from the ranks' blocks (every model rank
    of a data coordinate holds the same rows)."""
    out = [None, None]
    for res in results:
        v = res[key] if t is None else res[key][t]
        out[res["coord"]["data"]] = v
    return np.concatenate(out)


def _close(got, want, what):
    tol = REL * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"


# ------------------------------------------------------------------ serving
@functools.lru_cache(maxsize=None)
def _reference_serve(name):
    """The reference's sharded prefill, forced decode and greedy serve
    steps: (logits a step, greedy tokens a step)."""
    arch, fed = SERVE[name]
    prompts, forced = _prompts(arch)
    params = _params(arch)
    mesh = _rmesh()
    model = jbuild_model(_jcfg(arch))
    spec = r_fed(fed, mesh)
    psh = r_param_sh(spec, mesh, params)
    batch = {"tokens": jnp.asarray(prompts)}
    bsh = r_sbatch_sh(mesh, batch)
    with mesh, r_logical_rules(RRules(spec, mesh, serve=True)):
        prefill = jax.jit(lambda p, b: model.prefill(
            p, b, cache_len=S + FORCED), in_shardings=(psh, bsh))
        logits, cache0 = prefill(params, batch)
        csh = r_cache_sh(spec, mesh, cache0, batch_size=B)
        cache0 = jax.device_put(cache0, csh)
        tsh = r_sbatch_sh(mesh, {"t": jnp.zeros((B, 1), jnp.int32)})["t"]
        dec = jax.jit(lambda p, c, t: model.decode_step(p, c, t),
                      in_shardings=(psh, csh, tsh))
        steps, cache = [np.asarray(logits[:, 0])], cache0
        for t in range(FORCED):
            logits, cache = dec(params, cache,
                                jnp.asarray(forced[:, t:t + 1]))
            cache = jax.device_put(cache, csh)
            steps.append(np.asarray(logits[:, 0]))
        tok = jnp.argmax(steps[0], -1).astype(jnp.int32)[:, None]
        cache, toks = cache0, []
        for _ in range(GREEDY):
            toks.append(np.asarray(tok[:, 0]))
            logits, cache = dec(params, cache, tok)
            cache = jax.device_put(cache, csh)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return steps, toks


@functools.lru_cache(maxsize=None)
def _unsharded_serve(name, rows=B, capacity=moe.CAPACITY_FACTOR):
    """The port's unsharded prefill, forced decode and greedy steps on
    the first ``rows`` prompts at MoE ``capacity``."""
    arch, _ = SERVE[name]
    prompts, forced = (a[:rows] for a in _prompts(arch))
    model = build_model(tp_config(arch, *SHAPE))
    params = interop.params_from_numpy(_params(arch))
    factor, moe.CAPACITY_FACTOR = moe.CAPACITY_FACTOR, capacity
    try:
        return _decode(model, params, prompts, forced)
    finally:
        moe.CAPACITY_FACTOR = factor


def _decode(model, params, prompts, forced):
    """(logits a step, greedy tokens a step) of ``_unsharded_serve``."""
    logits, cache0 = model.prefill(params,
                                   {"tokens": torch.from_numpy(prompts)},
                                   cache_len=S + FORCED)
    steps, cache = [logits[:, 0].numpy()], cache0
    for t in range(FORCED):
        logits, cache = model.decode_step(
            params, cache, torch.from_numpy(forced[:, t:t + 1]))
        steps.append(logits[:, 0].numpy())
    tok, cache, toks = torch.argmax(torch.from_numpy(steps[0]), -1)[:, None], \
        cache0, []
    for _ in range(GREEDY):
        toks.append(tok[:, 0].numpy())
        logits, cache = model.decode_step(params, cache, tok)
        tok = torch.argmax(logits, -1)
    return steps, toks


@pytest.mark.parametrize("name", list(SERVE))
def test_tp_serve_logits_match_reference_sharded(name, port):
    want, _ = _reference_serve(name)
    for t in range(1 + FORCED):
        _close(_rows(port[f"serve_{name}"], "logits", t), want[t],
               f"{name} step {t}")


@pytest.mark.parametrize("name", list(SERVE))
def test_tp_serve_logits_match_unsharded_port(name, port):
    want, _ = _unsharded_serve(name)
    for t in range(1 + FORCED):
        _close(_rows(port[f"serve_{name}"], "logits", t), want[t],
               f"{name} step {t}")


@pytest.mark.parametrize("name", list(SERVE))
def test_tp_serve_greedy_tokens_match(name, port):
    """Greedy tokens equal the reference's sharded steps and the port's
    unsharded decode, step by step, while the top-two margin of the
    unsharded logits clears the tolerance on every row."""
    steps, want = _unsharded_serve(name)
    _, rwant = _reference_serve(name)
    checked = 0
    for t in range(GREEDY):
        got = _rows(port[f"serve_{name}"], "tokens", t)
        np.testing.assert_array_equal(want[t], rwant[t])
        np.testing.assert_array_equal(got, want[t], err_msg=f"{name} {t}")
        checked += len(got)
    assert checked == B * GREEDY and len(steps) == 1 + FORCED


@pytest.mark.parametrize("name", list(SERVE))
def test_tp_serve_collectives_a_step(name, port):
    """Each step's collectives by role are ``serve_collectives``' (an
    MoE layer's ``moe_counts`` gather included: the prompts split over
    ``data``); ``cross_device`` moves no param."""
    for res in port[f"serve_{name}"]:
        for t, ops in enumerate(res["ops"]):
            want = res["want_ops"]["prefill" if t == 0 else "decode"]
            got = Counter(op[1] for op in ops)
            assert dict(got) == {k: v for k, v in want.items() if v}
            assert got["moe_counts"] == SHAPE[0]
        if SERVE[name][1] == "cross_device":
            spec = get_federation_spec("cross_device", ShapeMesh)
            for ops in res["ops"]:
                hlo.assert_no_param_gather(
                    [hlo.CollectiveOp(k, 0, 2, a, role=r, shape=sh)
                     for k, r, a, sh in ops], spec)
    # 2 layers: OLMoE's 4 KV heads split (a gather a layer), a reduce
    # after attention and after the MoE, the counts, the vocab ops;
    # DeepSeek (cross_silo) gathers each layer's fsdp dims: MLA's wq_a,
    # wkv_a, wo, the router, the experts' three and the shared
    # expert's three, and moves the embedding's rows
    assert port["serve_olmoe"][0]["want_ops"]["decode"] == dict(
        tp_reduce=4, kv_gather=2, moe_counts=2, vocab=2, fsdp_gather=0,
        fsdp_rows=0)
    assert port["serve_deepseek"][0]["want_ops"]["decode"] == dict(
        tp_reduce=4, kv_gather=0, moe_counts=2, vocab=2,
        fsdp_gather=2 * 10, fsdp_rows=4)


@pytest.mark.parametrize("name", list(SERVE))
def test_tp_serve_one_row_is_whole_on_every_data_rank(name, port):
    """One prompt is not split over ``data`` (``serve_batch_shardings``)
    and its rules say so (``batch_size=1``): each rank computes the
    whole row's capacity order, gathers no counts, and its logits and
    tokens are the unsharded port's one-row run's, the data ranks' the
    same bits. At the served capacity that run drops choices (its
    prefill is not the one at 8.0), so a rank that counted the other
    data rank's copy of the row, or took C from two rows, would differ."""
    steps, toks = _unsharded_serve(name, 1)
    undropped, _ = _unsharded_serve(name, 1, 8.0)
    assert float(np.abs(steps[0] - undropped[0]).max()) > 1e-3
    res = port[f"row1_{name}"]
    for r in res:
        assert r["cache_rows"] == 1
        for t in range(1 + FORCED):
            _close(r["logits"][t], steps[t], f"{name} {r['coord']} step {t}")
        for t in range(GREEDY):
            np.testing.assert_array_equal(r["tokens"][t], toks[t])
        for t, ops in enumerate(r["ops"]):
            want = r["want_ops"]["prefill" if t == 0 else "decode"]
            assert dict(Counter(op[1] for op in ops)) == {
                k: v for k, v in want.items() if v}
            assert "moe_counts" not in want
    for a in res:
        for b in res:
            if a["coord"]["model"] == b["coord"]["model"]:
                for x, y in zip(a["logits"], b["logits"]):
                    np.testing.assert_array_equal(x, y)


def test_serving_an_moe_on_data_ranks_needs_the_batch_size():
    """An MoE's capacity order depends on whether the data axes split
    the rows: its serve rules on (data 2, model 2) need the global batch
    (one row: nothing splits the rows; more: ``data`` does), and
    ``place_for_rank`` refuses a batch of another size. On (data 1,
    model 4) nothing splits the rows either way."""
    model = build_model(tp_config("olmoe-1b-7b", *SHAPE))
    params = model.init(torch.Generator().manual_seed(0))
    mesh = dist.AbstractMesh({"data": 2, "model": 2})
    with pytest.raises(ValueError, match="batch_size"):
        serve_rules(model, mesh, params)
    one = serve_rules(model, mesh, params, batch_size=1)
    assert one.batch_axes == () and one.map["batch"] is None
    assert serve_rules(model, mesh, params,
                       batch_size=B).batch_axes == ("data",)
    assert "moe_counts" not in serve_collectives(model, one, 1, S)
    with pytest.raises(ValueError, match="rows under rules"):
        place_for_rank(one, batch={"tokens": torch.zeros((B, S))})
    with pytest.raises(ValueError, match="rows under rules"):
        place_for_rank(one, cache={}, batch_size=B)
    flat = serve_rules(model, dist.AbstractMesh({"data": 1, "model": 4}),
                       params)
    assert flat.batch_axes == ()


def test_mla_latent_cache_is_the_same_on_both_model_ranks(port):
    """The latent cache has no head dim: both ``model`` ranks of a data
    coordinate write the same bits, its rows those of their data rank."""
    res = port["serve_deepseek"]
    by_data = {}
    for r in res:
        by_data.setdefault(r["coord"]["data"], []).append(r["cache"])
    for d, (a, b) in by_data.items():
        for path, x, y in zip(tree_flatten(a)[1], tree_flatten(a)[0],
                              tree_flatten(b)[0]):
            assert np.array_equal(x, y), (d, path)
            assert x.shape[1] == B // 2
    assert {k for k in res[0]["cache"]["run0"]} == {"c_kv", "k_rope"}


# ----------------------------------------------------------------- training
@functools.lru_cache(maxsize=None)
def _reference_round(name):
    arch, fed, remat, _ = ROUNDS[name]
    params, batch = _params(arch), _round_batch(arch, fed)
    mesh = _rmesh()
    model = jbuild_model(_jcfg(arch))
    spec = r_fed(fed, mesh)
    step, sopt, scn, comp = r_make_train_step(
        model, JFLConfig(local_steps=K), remat=remat)
    C = 2 if fed == "cross_device" else 1
    state = r_init(params, sopt, scn, comp, C)
    batch = jax.tree.map(jnp.asarray, batch)
    psh = r_param_sh(spec, mesh, state.params)
    ssh = r_state_sh(mesh, spec, state, psh)
    bsh = r_batch_sh(spec, mesh, batch)
    with mesh, r_logical_rules(RRules(spec, mesh, serve=False)):
        new, metrics = jax.jit(step, in_shardings=(ssh, bsh))(state, batch)
    return jax.device_get(metrics), jax.device_get(new.params)


@functools.lru_cache(maxsize=None)
def _unsharded_round(name):
    arch, fed, remat, kern = ROUNDS[name]
    model = build_model(tp_config(arch, *SHAPE))
    step, sopt, scn, comp = make_train_step(
        model, FLConfig(local_steps=K), remat=remat, use_pallas=kern)
    state = init_fl_state(interop.params_from_numpy(_params(arch)), sopt,
                          scn, comp)
    new, metrics = step(state, interop.params_from_numpy(
        _round_batch(arch, fed)))
    return ({k: interop._to_numpy(v) for k, v in metrics.items()},
            interop.params_to_numpy(new.params))


def _whole(results, params0):
    """The ranks' blocks put together: ({path: whole leaf}, replica
    blocks that differ from the first in any bit)."""
    leaves0, treedef = tree_flatten(params0)
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


@pytest.mark.parametrize("name", list(ROUNDS))
def test_tp_round_matches_the_references_sharded_step(name, port):
    metrics, params = _reference_round(name)
    for res in port[name]:
        _metrics_held(res["metrics"], metrics)
    _held(_whole(port[name], _params(ROUNDS[name][0]))[0], params)


@pytest.mark.parametrize("name", list(ROUNDS))
def test_tp_round_matches_the_unsharded_port(name, port):
    metrics, params = _unsharded_round(name)
    for res in port[name]:
        _metrics_held(res["metrics"], metrics)
    _held(_whole(port[name], _params(ROUNDS[name][0]))[0], params)


@pytest.mark.parametrize("name", list(ROUNDS))
def test_replicated_leaves_are_bitwise_equal_across_ranks(name, port):
    """Every replica of a leaf holds the same bits: the router, the
    norms, MLA's latent projections and norms on both ``model`` ranks
    (a router or latent whose gradient were partial, or counted twice,
    would drift here)."""
    _, differ = _whole(port[name], _params(ROUNDS[name][0]))
    assert differ == 0


@pytest.mark.parametrize("name", list(ROUNDS))
def test_tp_round_collectives_are_train_collectives(name, port):
    arch, fed, _, kern = ROUNDS[name]
    for res in port[name]:
        got = Counter(op[1] for op in res["ops"])
        assert dict(got) == res["want_ops"]
        assert all(op[1] in hlo.TRAIN_ROLES for op in res["ops"])
        # the counts and the aux sums cross data only where the rows do
        split = fed == "cross_silo"
        assert (got["moe_counts"] > 0) == split == (got["moe_aux"] > 0)
        assert (got["mtp_gather"] > 0) == (arch == "deepseek-v3-671b")
        if fed == "cross_device":
            spec = get_federation_spec("cross_device", ShapeMesh)
            hlo.assert_no_param_gather(
                [hlo.CollectiveOp("all-reduce", 4, 2, op[2], role=op[1])
                 for op in res["ops"]], spec, train=True)
        if kern:
            assert res["launches"] == {("batched_norms", "cpu"): K,
                                       ("batched_apply", "cpu"): K}


# --------------------------------------------------------- one MoE layer
def _unsharded_layer(grad: bool):
    params, x, r = _layer_inputs()
    cfg = tp_config("olmoe-1b-7b", *SHAPE)
    p = {k: torch.from_numpy(np.array(v[0])).requires_grad_(grad)
         for k, v in params["stack"]["run0"]["moe"].items()}
    xt = torch.from_numpy(x).requires_grad_(grad)
    out, aux = moe.apply_moe(p, xt, cfg)
    res = {"out": out.detach().numpy(), "aux": float(aux.detach())}
    if grad:
        gs = torch.autograd.grad(aux + (out * torch.from_numpy(r)).sum(),
                                 [xt] + list(p.values()))
        res["grad_x"] = gs[0].numpy()
        res["grads"] = {k: g.numpy() for k, g in zip(p, gs[1:])}
    return res


def test_capacity_order_is_global(port):
    """Expert 0 takes every token's first choice: 64 choices for C = 40.
    A per-rank cumsum would keep the first 40 of each data rank's 32;
    the global order drops the last 24 of data rank 1's. The ranks'
    rows equal the reference's ``apply_moe`` on the whole batch (the
    unsharded port's too), and the reference's own per-half run keeps
    what the global order drops."""
    params, x, _ = _layer_inputs()
    cfg = _jcfg("olmoe-1b-7b")
    rp = jax.tree.map(lambda a: a[0], params["stack"]["run0"]["moe"])
    logits = x.reshape(-1, SHAPE[1]) @ rp["router"]
    idx = np.argsort(-logits, -1)[:, :2].reshape(-1)          # (T·K,)
    C = rmoe._capacity(B * S, 4, 2)
    onehot = idx[:, None] == np.arange(4)
    glob = (np.cumsum(onehot, 0) - 1)[onehot]
    half = len(idx) // 2
    local = np.concatenate([(np.cumsum(onehot[:half], 0) - 1)[onehot[:half]],
                            (np.cumsum(onehot[half:], 0) - 1)[onehot[half:]]])
    assert ((glob >= C) & (local < C)).any()
    want, _ = rmoe.apply_moe(rp, jnp.asarray(x), cfg)
    want = np.asarray(want)
    got = _rows(port["layer_serve"], "out")
    _close(got, want, "TP layer vs the reference")
    _close(got, _unsharded_layer(False)["out"], "TP layer vs unsharded")
    per_half = np.concatenate([np.asarray(rmoe.apply_moe(
        rp, jnp.asarray(x[h * 2:(h + 1) * 2]), cfg)[0]) for h in (0, 1)])
    # a per-rank run: the half's own capacity C(32) = 20 < 40, so it
    # drops more; with the global C its rank 1 would keep more: either
    # way the per-rank order is not the global one
    assert float(np.abs(per_half - want).max()) > 1e-3
    for res in port["layer_serve"]:
        roles = Counter(op[1] for op in res["ops"])
        assert roles == {"moe_counts": 1, "tp_reduce": 1}
        assert res["aux"] == 0.0        # serving drops the aux loss


def test_aux_loss_and_its_gradient_match_the_unsharded(port):
    """Under ``cross_silo`` training rules (rows split over data, params
    gathered at use) one layer's aux, output and the gradients of aux +
    Σ out·R equal the unsharded port's: each rank's rows of ∂/∂x, each
    rank's block of every param's gradient; the router's gradient is
    the same bits on both ``model`` ranks."""
    want = _unsharded_layer(True)
    res = port["layer_train"]
    for r in res:
        assert abs(r["aux"] - want["aux"]) <= REL * abs(want["aux"])
    _close(_rows(res, "out"), want["out"], "out")
    _close(_rows(res, "grad_x"), want["grad_x"], "grad x")
    for r in res:
        for k, ax in r["axes"].items():
            blk = local_block(torch.from_numpy(want["grads"][k]), ax,
                              ShapeMesh, r["coord"]).numpy()
            _close(r["grads"][k], blk, f"grad {k} at {r['coord']}")
    for a in res:
        for b in res:
            if a["coord"]["data"] == b["coord"]["data"] and a is not b:
                assert np.array_equal(a["grads"]["router"],
                                      b["grads"]["router"])
                assert np.array_equal(a["grad_x"], b["grad_x"])
    roles = Counter((op[1], op[4]) for op in res[0]["ops"])
    # the counts and aux sums cross data once; the tokens and the gate
    # values each sum their gradient over model once
    assert roles[("moe_counts", False)] == roles[("moe_aux", False)] == 1
    assert roles[("tp_grad", True)] == 2
    assert roles[("tp_reduce", False)] == 1


def test_mtp_gather_gradient_is_the_ranks_block(port):
    """``gather_split``'s gradient of Σ gathered·R is the rank's block of
    R (the unsharded port's gradient), plain and under ``vmap(grad)``;
    ``gather_from``'s reduce-scatter would count it tp times."""
    x, r = _split_input()
    rt = torch.from_numpy(r)
    want = torch.func.grad(lambda a: (a * rt).sum())(torch.from_numpy(x))
    for res in port["gather_split"]:
        ax = (None, None, "model")
        blk = local_block(want, ax, ShapeMesh, res["coord"]).numpy()
        np.testing.assert_array_equal(res["split"], blk)
        np.testing.assert_array_equal(res["from"], 2 * blk)
        np.testing.assert_array_equal(res["vmap"][0], blk)
        np.testing.assert_array_equal(res["vmap"][1], 3 * blk)


# ----------------------------------------------------------------- refusals
@pytest.mark.parametrize("arch", REFUSED)
def test_the_other_archs_stay_refused(arch):
    """xLSTM, the last arch tensor parallelism refused, runs under both
    rules since its own slice (tests/test_torch_tp_xlstm.py), and the
    dry run admits its shapes; what it still refuses, as every arch,
    is the sequence-sharded rules (ROADMAP A17, with launch/perf.py's
    variants)."""
    from repro_torch.models.common import logical_rules
    model = build_model(tp_config(arch, 2, 64, 512))
    params = model.init(torch.Generator().manual_seed(0))
    mesh = dist.AbstractMesh({"data": 2, "model": 2})
    for rules in (serve_rules, train_rules):
        rules(model, mesh, params)
    for shape in ("train_4k", "decode_32k"):
        dryrun.check_lowerable(arch, shape, False)
    with logical_rules(serve_rules(model, mesh, params, seq_shard=True)), \
            pytest.raises(ValueError, match="ROADMAP A17"):
        model.init_cache(4, 8, device="cpu")
