"""Port parity for tensor parallelism of xLSTM's mLSTM and sLSTM: gloo
ranks on the CPU.

Four ranks of ``torch.distributed`` (gloo, one torch thread each) run
every case once, in one spawn for the module
(``tests/_torch_tp_hybrid_worker.py``, torch only), on xLSTM at
``reduced(4, 64, 512)``: three mLSTM layers and one sLSTM ([m, m, m,
s]), 4 heads; d_in = 128, the sLSTM's hd = 16 and its feed-forward's 85
units (which no tensor axis here divides: whole on every rank). The
reference's params, prompts and round batches are injected. Two meshes:

  * (data 2, model 2): 2 rows a data rank; the reference's placement
    splits ``w_up``'s columns (rank 0 holds all of xi, rank 1 all of z),
    the mLSTM's d_in rows, ``w_x``'s columns and ``r``'s rows of each
    head's hd; the decode caches are whole over ``model``;
  * (data 1, model 4): every row on every rank; the caches' dim after
    the rows is cut over ``model`` (one mLSTM head, 16 sLSTM units a
    rank), the prefill's cache narrowed to it by
    ``place_prefill_cache``.

On each: 4 prompts of 16 tokens, 4 teacher-forced decode steps and 4
greedy ones, held against the reference's jitted sharded prefill and
decode on an Auto-axes mesh of 4 of the conftest's 8 CPU devices and
against the port's unsharded steps at the zoo's rtol = atol = 2e-5;
decode held against the unsharded full forward; the reference's whole
prefill cache placed by ``place_for_rank`` takes the reference's
``cache_shardings`` shapes and decodes as the reference does; the
ranks' prefill states put together are the reference's; each step's
collectives are ``serve_collectives``'. A prefill of 32 and of 64
tokens make the same collectives (none in the sLSTM's time loop).
Training: one vmap round of Δ-SGD (K = 2) on (data 2, model 2) under
``cross_device`` and ``cross_silo`` with remat, and on (data 1, model
4), held against the reference's sharded ``make_train_step`` and the
port's unsharded round within ``XLSTM_RTOL`` (the local steps are
ill-conditioned in f32: tests/test_torch_lm_rounds.py), every
replicated leaf's replicas bitwise equal, the collectives
``train_collectives``'. The dry run admits xLSTM-1.3B on (32, 8) and
lowers its ``decode_32k``; its prefill and round are counted at two
lengths and extrapolated, which the full count at a third length
matches.
"""
import dataclasses
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
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import FLConfig as JFLConfig
from repro.configs import get_config as jget_config
from repro.core import get_server_opt as r_sopt
from repro.core import init_fl_state as r_init
from repro.launch.dryrun import _state_shardings as r_state_sh
from repro.launch.steps import make_train_step as r_make_train_step
from repro.models import build_model as jbuild_model
from repro.models.common import logical_rules as r_logical_rules
from repro.sharding.spec import LogicalRules as RRules
from repro.sharding.spec import batch_shardings as r_batch_sh
from repro.sharding.spec import cache_shardings as r_cache_sh
from repro.sharding.spec import get_federation_spec as r_fed
from repro.sharding.spec import make_param_shardings as r_param_sh
from repro.sharding.spec import serve_batch_shardings as r_sbatch_sh
from repro_torch import interop
from repro_torch.configs import FLConfig, ShapeConfig, get_config
from repro_torch.core import init_fl_state
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_shape
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import build_model, tp_refusal
from repro_torch.sharding import dist, hlo
from repro_torch.sharding.spec import get_federation_spec, local_block
from repro_torch.utils.tree import tree_flatten

from _torch_tp_hybrid_worker import tp_config

needs8 = pytest.mark.skipif(jax.device_count() < 8,
                            reason="needs >= 8 host devices "
                                   "(XLA_FLAGS=--xla_force_host_platform"
                                   "_device_count=8)")
pytestmark = needs8

ARCH = "xlstm-1.3b"
SHAPE = (4, 64, 512)             # layers [m, m, m, s], d_model, vocab
B, S, FORCED, GREEDY = 4, 16, 4, 4
K, TB = 2, 4                     # local steps, rows a client
TOL = dict(rtol=2e-5, atol=2e-5)     # the zoo's (test_torch_lm_zoo.py)
# tests/test_torch_lm_rounds.py's: the local steps are ill-conditioned
# in f32 at this config
XLSTM_RTOL = {"eta": 1e-4, "params": 1e-3}
MESHES = {"two": ((2, 2), ("data", "model")),
          "one": ((1, 4), ("data", "model"))}
# name -> (federation, remat, mesh)
ROUNDS = {"xlstm_device": ("cross_device", False, "two"),
          "xlstm_silo_remat": ("cross_silo", True, "two"),
          "xlstm_one_data": ("cross_device", False, "one")}
METRICS = ("loss", "loss_last_step", "eta_mean", "eta_min", "eta_max")
LONG = (32, 64)                  # the prompts whose prefills' ops match


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one CPU thread while this module runs (its ops are
    small; eight threads a worker contend with the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape_mesh(mesh):
    return type("ShapeMesh", (), {"shape": dict(zip(MESHES[mesh][1],
                                                    MESHES[mesh][0]))})


def _rmesh(mesh):
    return jax.make_mesh(MESHES[mesh][0], MESHES[mesh][1],
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])


def _jcfg():
    return jget_config(ARCH).reduced(*SHAPE)


@functools.lru_cache(maxsize=None)
def _params():
    return jax.device_get(jbuild_model(_jcfg()).init(jax.random.key(3)))


@functools.lru_cache(maxsize=None)
def _prompts(S=S):
    rng = np.random.default_rng(S)
    toks = rng.integers(0, SHAPE[2], (B, S + FORCED)).astype(np.int32)
    return toks[:, :S], toks[:, S:]


@functools.lru_cache(maxsize=None)
def _round_batch(fed, mesh):
    C = MESHES[mesh][0][0] if fed == "cross_device" else 1
    rng = np.random.default_rng(C + len(mesh))
    toks = rng.integers(0, SHAPE[2], (C, K, TB, S + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _cases():
    cases = {}
    for mesh in MESHES:
        prompts, forced = _prompts()
        cases[f"serve_{mesh}"] = dict(
            kind="serve", cfg=(ARCH,) + SHAPE, mesh=MESHES[mesh],
            federation="cross_device", params=_params(), prompts=prompts,
            forced=forced, greedy=GREEDY, narrow=mesh == "one",
            whole_cache=_reference_serve(mesh)[2])
    for n in LONG:
        prompts, forced = _prompts(n)
        cases[f"prefill_{n}"] = dict(
            kind="serve", cfg=(ARCH,) + SHAPE, mesh=MESHES["two"],
            federation="cross_device", params=_params(), prompts=prompts,
            forced=forced[:, :1], greedy=1)
    for name, (fed, remat, mesh) in ROUNDS.items():
        state = jax.device_get(r_init(_params(), r_sopt("fedavg")))
        cases[name] = dict(kind="round", cfg=(ARCH,) + SHAPE,
                           mesh=MESHES[mesh], federation=fed,
                           params=_params(),
                           state=SimpleNamespace(**state._asdict()),
                           batch=_round_batch(fed, mesh), K=K, remat=remat,
                           use_pallas=False, scenario=None, draws=None)
    return cases


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case on 4 gloo ranks, one spawn: {name: [rank results]}."""
    from _torch_tp_hybrid_worker import run_rank
    tmp = tmp_path_factory.mktemp("tp_xlstm_ranks")
    cases = _cases()
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"mesh": MESHES["two"], "cases": cases}, f)
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
    blocks = {}
    for res in results:
        v = res[key] if t is None else res[key][t]
        blocks[res["coord"]["data"]] = v
    return np.concatenate([blocks[d] for d in sorted(blocks)])


def _close(got, want, what, rel):
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"


# ------------------------------------------------------------------ serving
@functools.lru_cache(maxsize=None)
def _reference_serve(mesh_name):
    """The reference's sharded prefill and forced decode steps, and its
    greedy tokens: (logits a step, tokens a step, prefill cache)."""
    prompts, forced = _prompts()
    params = _params()
    mesh = _rmesh(mesh_name)
    model = jbuild_model(_jcfg())
    spec = r_fed("cross_device", mesh)
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
        shards = {"/".join(str(k.key) for k in p): csh_leaf.shard_shape(
            leaf.shape) for (p, leaf), csh_leaf in zip(
            jax.tree_util.tree_flatten_with_path(cache0)[0],
            jax.tree.leaves(csh))}
    return steps, toks, jax.device_get(cache0), shards


@functools.lru_cache(maxsize=None)
def _unsharded_serve():
    """The port's unsharded prefill and forced decode steps, its greedy
    tokens, and the full forward's logits at the forced positions."""
    prompts, forced = _prompts()
    model = build_model(tp_config(ARCH, *SHAPE))
    params = interop.params_from_numpy(_params())
    logits, cache0 = model.prefill(params,
                                   {"tokens": torch.from_numpy(prompts)},
                                   cache_len=S + FORCED)
    steps, cache = [logits[:, 0].numpy()], cache0
    for t in range(FORCED):
        logits, cache = model.decode_step(
            params, cache, torch.from_numpy(forced[:, t:t + 1]))
        steps.append(logits[:, 0].numpy())
    tok = torch.argmax(torch.from_numpy(steps[0]), -1)[:, None]
    cache, toks = cache0, []
    for _ in range(GREEDY):
        toks.append(tok[:, 0].numpy())
        logits, cache = model.decode_step(params, cache, tok)
        tok = torch.argmax(logits, -1)
    full, _ = model.apply(params, {"tokens": torch.from_numpy(
        np.concatenate([prompts, forced], 1))}, use_pallas=False)
    return steps, toks, full[:, S - 1:].numpy()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_serve_logits_match_reference_sharded(mesh, port):
    want = _reference_serve(mesh)[0]
    for t in range(1 + FORCED):
        np.testing.assert_allclose(_rows(port[f"serve_{mesh}"], "logits", t),
                                   want[t], **TOL, err_msg=f"step {t}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_serve_logits_match_unsharded_port(mesh, port):
    want = _unsharded_serve()[0]
    for t in range(1 + FORCED):
        np.testing.assert_allclose(_rows(port[f"serve_{mesh}"], "logits", t),
                                   want[t], **TOL, err_msg=f"step {t}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_serve_greedy_tokens_match(mesh, port):
    """Greedy tokens equal the reference's sharded steps and the port's
    unsharded decode, step by step."""
    want = _unsharded_serve()[1]
    rwant = _reference_serve(mesh)[1]
    for t in range(GREEDY):
        np.testing.assert_array_equal(want[t], rwant[t])
        np.testing.assert_array_equal(
            _rows(port[f"serve_{mesh}"], "tokens", t), want[t],
            err_msg=f"step {t}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_decode_matches_the_full_forward(mesh, port):
    """Each decode step's logits (from the prefill's cache: at one data
    rank the rank's heads and units of it) are the full forward's at
    that position, within 1e-4·max|logits| (the mLSTM's chunked
    prefill and its step recurrence stabilise in different orders)."""
    full = _unsharded_serve()[2]
    for t in range(1 + FORCED):
        _close(_rows(port[f"serve_{mesh}"], "logits", t), full[:, t],
               f"step {t}", 1e-4)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placed_cache_is_the_references(mesh, port):
    """The reference's whole prefill cache placed by ``place_for_rank``
    has the reference's ``cache_shardings`` block shapes (at one data
    rank the mLSTM's heads and the sLSTM's units cut over ``model``) and
    decodes as the reference does; the ranks' own prefill states, put
    together over the axis that cut them, are the reference's."""
    want, _, ref, shards = _reference_serve(mesh)
    for r in port[f"serve_{mesh}"]:
        got = {k: v for k, v in r["placed_shapes"].items()
               if k.startswith("runs/")}
        assert got == {k: tuple(v) for k, v in shards.items()
                       if k.startswith("runs/")}
    if mesh == "one":
        assert port["serve_one"][0]["placed_shapes"]["runs/run0/C"][2] == 1
        assert port["serve_one"][0]["placed_shapes"]["runs/run1/h"][2] == 16
    for t in range(FORCED):
        np.testing.assert_allclose(
            _rows(port[f"serve_{mesh}"], "placed_logits", t), want[1 + t],
            **TOL, err_msg=f"placed step {t}")
    res = port[f"serve_{mesh}"]
    cut = 2 if mesh == "one" else 1           # model cuts dim 2, data 1
    for run, leaves in ref["runs"].items():
        for key, w in leaves.items():
            blocks = {}
            for r in res:
                c = r["cache"]["runs"][run][key]
                idx = r["coord"]["model"] if mesh == "one" \
                    else r["coord"]["data"]
                blocks[idx] = c
            got = np.concatenate([blocks[i] for i in sorted(blocks)],
                                 axis=cut)
            np.testing.assert_allclose(got, w, **TOL,
                                       err_msg=f"{run}/{key}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_serve_collectives_a_step(mesh, port):
    """Each step's collectives by role are ``serve_collectives``': each
    mLSTM gathers its ``w_up`` product, sums its four partial products
    and reduces ``w_out``'s; a decode step's sLSTM sums its partial
    recurrent product with its input's block; at one data rank each
    mLSTM sums its heads' squares and the sLSTM gathers its state.
    ``cross_device`` moves no param (the sLSTM's r only before a
    prefill's time loop)."""
    spec = get_federation_spec("cross_device", _shape_mesh(mesh))
    for res in port[f"serve_{mesh}"]:
        for t, ops in enumerate(res["ops"]):
            want = res["want_ops"]["prefill" if t == 0 else "decode"]
            assert dict(Counter(op[1] for op in ops)) == {
                k: v for k, v in want.items() if v}
            hlo.assert_no_param_gather(
                [hlo.CollectiveOp(k, 0, 2, a, role=r, shape=sh)
                 for k, r, a, sh in ops], spec)
    one = mesh == "one"
    assert port[f"serve_{mesh}"][0]["want_ops"]["decode"] == dict(
        tp_reduce=3, kv_gather=0, fsdp_gather=0, fsdp_rows=0, vocab=2,
        xlstm_up=3, xlstm_qkv=3, xlstm_rec=1,
        **({"xlstm_norm": 3, "xlstm_state": 1} if one else {}))
    assert port[f"serve_{mesh}"][0]["want_ops"]["prefill"] == dict(
        tp_reduce=3, kv_gather=0, fsdp_gather=0, fsdp_rows=0, vocab=2,
        xlstm_up=3, xlstm_qkv=3, xlstm_wx=1, xlstm_r=1)


def test_prefill_collectives_do_not_grow_with_the_sequence(port):
    """A prefill of 32 and one of 64 tokens make the same collectives,
    role by role: the sLSTM's time loop makes none (its input product
    and ``r`` are gathered once, before it)."""
    ops = {n: Counter(op[1] for op in port[f"prefill_{n}"][0]["ops"][0])
           for n in LONG}
    assert ops[32] == ops[64]
    assert ops[32]["xlstm_wx"] == ops[32]["xlstm_r"] == 1
    for n in LONG:
        for r in port[f"prefill_{n}"]:
            assert Counter(op[1] for op in r["ops"][0]) == ops[32]


# ----------------------------------------------------------------- training
@functools.lru_cache(maxsize=None)
def _reference_round(name):
    fed, remat, mname = ROUNDS[name]
    params, batch = _params(), _round_batch(fed, mname)
    mesh = _rmesh(mname)
    model = jbuild_model(_jcfg())
    spec = r_fed(fed, mesh)
    step, sopt, scn, comp = r_make_train_step(
        model, JFLConfig(local_steps=K), remat=remat)
    C = batch["tokens"].shape[0]
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
    fed, remat, mname = ROUNDS[name]
    model = build_model(tp_config(ARCH, *SHAPE))
    step, sopt, scn, comp = make_train_step(
        model, FLConfig(local_steps=K), remat=remat)
    state = init_fl_state(interop.params_from_numpy(_params()), sopt, scn,
                          comp)
    new, metrics = step(state, interop.params_from_numpy(
        _round_batch(fed, mname)))
    return ({k: interop._to_numpy(v) for k, v in metrics.items()},
            interop.params_to_numpy(new.params))


def _whole(results, params0, mname):
    """The ranks' blocks put together: ({path: whole leaf}, replica
    blocks that differ from the first in any bit)."""
    leaves0, treedef = tree_flatten(params0)
    whole, differ = {}, 0
    mesh = _shape_mesh(mname)
    for i, path in enumerate(treedef):
        leaf = torch.full(leaves0[i].shape, float("nan"))
        seen = torch.zeros(leaves0[i].shape, dtype=torch.bool)
        for res in results:
            ax = tree_flatten(res["axes"])[0][i]
            blk = torch.from_numpy(tree_flatten(res["params"])[0][i])
            view = local_block(leaf, ax, mesh, res["coord"])
            mark = local_block(seen, ax, mesh, res["coord"])
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
        _close(whole[path], np.asarray(w, np.float32), path,
               XLSTM_RTOL["params"])


def _metrics_held(got, want):
    for k in METRICS:
        rtol = XLSTM_RTOL["eta"] if k.startswith("eta") else 1e-5
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) <= rtol * abs(w), f"{k}: {g} vs {w}"


@pytest.mark.parametrize("name", list(ROUNDS))
def test_tp_round_matches_the_references_sharded_step(name, port):
    metrics, params = _reference_round(name)
    for res in port[name]:
        _metrics_held(res["metrics"], metrics)
    _held(_whole(port[name], _params(), ROUNDS[name][2])[0], params)


@pytest.mark.parametrize("name", list(ROUNDS))
def test_tp_round_matches_the_unsharded_port(name, port):
    metrics, params = _unsharded_round(name)
    for res in port[name]:
        _metrics_held(res["metrics"], metrics)
    _held(_whole(port[name], _params(), ROUNDS[name][2])[0], params)


@pytest.mark.parametrize("name", list(ROUNDS))
def test_replicated_leaves_are_bitwise_equal_across_ranks(name, port):
    """Every replica of a leaf holds the same bits: ``b_if``, ``b``, the
    norms and the sLSTM's whole feed-forward, which the replicated
    recurrences' gradients reach whole on every rank (a leaf whose
    gradient were partial, or summed twice, would drift here)."""
    _, differ = _whole(port[name], _params(), ROUNDS[name][2])
    assert differ == 0


@pytest.mark.parametrize("name", list(ROUNDS))
def test_tp_round_collectives_are_train_collectives(name, port):
    fed, remat, mname = ROUNDS[name]
    for res in port[name]:
        got = Counter(op[1] for op in res["ops"])
        assert dict(got) == res["want_ops"]
        assert all(op[1] in hlo.TRAIN_ROLES for op in res["ops"])
        # each mLSTM's gather forward (twice under remat) and its
        # reduce-scatter backward; the sLSTM's two gathers only forward
        assert got["xlstm_up"] == 3 * K * (3 if remat else 2)
        assert got["xlstm_r"] == K * (2 if remat else 1)
        assert not [op for op in res["ops"]
                    if op[1] in ("xlstm_wx", "xlstm_r") and op[4]
                    and not remat]
        if fed == "cross_device":
            spec = get_federation_spec("cross_device", _shape_mesh(mname))
            hlo.assert_no_param_gather(
                [hlo.CollectiveOp("all-reduce", 4, 2, op[2], role=op[1])
                 for op in res["ops"]], spec, train=True)


# ------------------------------------------------------------------ dry run
def test_xlstm_is_admitted_on_every_tensor_axis():
    """The reference splits no xLSTM param by heads: its 4 heads do not
    bar a tensor axis of 2, 4 or 8, and the dry run admits its three
    shapes and ``long_500k`` on (data 32, model 8)."""
    cfg = get_config(ARCH)
    for tp in (2, 4, 8):
        assert tp_refusal(cfg, tp) is None
    for shape in ("prefill_32k", "decode_32k", "train_4k", "long_500k"):
        dryrun.check_lowerable(ARCH, shape, False)


def test_xlstm_decode_32k_lowers_on_the_production_mesh():
    res = dryrun.lower_one(ARCH, "decode_32k", False, verbose=False)
    cfg = get_config(ARCH)
    m, s = cfg.layer_types.count("mlstm"), cfg.layer_types.count("slstm")
    assert res["collectives"] == {"tp_reduce": m, "vocab": 2,
                                  "xlstm_up": m, "xlstm_qkv": m,
                                  "xlstm_rec": s}
    assert res["roofline"]["flops"] > 0


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_two_length_count_is_the_full_count(kind, monkeypatch):
    """xLSTM's prefill and round counted at two and three mLSTM chunks
    with the sLSTM loop cut to two cells, and at two chunks with three
    cells, and extrapolated to five chunks and as many cells, are the
    full count at five: FLOPs, bytes, argument bytes and every
    collective's bytes and shape (reduced widths on a rank of (32, 8),
    the chunk cut from 256 to 16 tokens so that the full count
    dispatches the sLSTM loop 80 times, not 1,280)."""
    from repro_torch.models import ssm
    monkeypatch.setattr(ssm, "MLSTM_CHUNK", 16)
    assert dryrun.seq_counts() == (32, 48)
    cfg = get_config(ARCH).reduced(4, 64, 512)
    shape = ShapeConfig(f"{kind}_80", kind, 80,
                        256 if kind == "train" else 32)
    assert dryrun._loop_scaled(cfg, shape)
    mesh = dist.AbstractMesh(production_shape(False))
    spec = get_federation_spec("cross_device", mesh)
    model = build_model(cfg, torch.bfloat16)
    fl = FLConfig(local_steps=1)
    lower, kw = ((dryrun._lower_train, dict(remat=True)) if kind == "train"
                 else (dryrun._lower_serve, {}))
    w1, m1, _ = dryrun._lower_scaled(lower, model, shape, fl, mesh, spec,
                                     FakeTensorMode(), use_pallas=False,
                                     **kw)
    w2, m2, _ = lower(model, shape, fl, mesh, spec, FakeTensorMode(),
                      use_pallas=False, **kw)
    assert w1.flops == pytest.approx(w2.flops, rel=1e-12)
    assert w1.hbm_bytes == pytest.approx(w2.hbm_bytes, rel=1e-12)
    assert m1["argument_size_in_bytes"] == m2["argument_size_in_bytes"]
    assert m1["output_size_in_bytes"] == m2["output_size_in_bytes"]
    assert [dataclasses.astuple(o) for o in w1.collectives] == \
        [dataclasses.astuple(o) for o in w2.collectives]


def test_counted_cells_cuts_the_loop_only_inside_its_context():
    """``ssm.counted_cells(n)`` (the dry run's count): the sLSTM loop runs
    its first n cells, whose h are the full loop's, and every later step
    repeats the n-th h, detached; outside it, and after an error raised
    inside it, the loop runs every cell again."""
    from repro_torch.models import ssm
    cfg = get_config(ARCH).reduced(*SHAPE)
    gen = torch.Generator().manual_seed(0)
    params = ssm.init_slstm(gen, cfg, torch.float32)
    x = torch.randn((2, 6, cfg.d_model), generator=gen, requires_grad=True)
    full, _ = ssm.slstm_full(params, x, cfg)
    with ssm.counted_cells(2):
        cut, _ = ssm.slstm_full(params, x, cfg)
    # the feed-forward acts on each step alone: its first two steps are
    # the full loop's, and the rest repeat the second (within f32's
    # rounding: the GEMM blocks rows apart)
    torch.testing.assert_close(cut[:, :2], full[:, :2])
    for t in range(2, 6):
        torch.testing.assert_close(cut[:, t], cut[:, 1])
    cut.sum().backward()
    grad = x.grad.clone()
    assert grad[:, 2:].abs().max() == 0 and grad[:, :2].abs().max() > 0
    with pytest.raises(RuntimeError):
        with ssm.counted_cells(1):
            raise RuntimeError("inside")
    again, _ = ssm.slstm_full(params, x, cfg)
    torch.testing.assert_close(again, full, rtol=0, atol=0)
