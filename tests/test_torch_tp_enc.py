"""Port parity for tensor parallelism of Whisper's encoder and
cross-attention and InternVL2's image tokens: gloo ranks on the CPU.

Four ranks of ``torch.distributed`` (gloo, one torch thread each) over
a (data 2, model 2) mesh run every case once, in one spawn for the
module (``tests/_torch_tp_hybrid_worker.py``, torch only), on
Whisper-tiny and InternVL2-1B at ``reduced(2, 64, 512)`` (Whisper: 2
encoder layers over 64 frames, 4 heads, 2 a rank, KV heads split;
InternVL2: 16 image tokens before the text, 4 heads over 2 KV heads,
one KV head a rank, QKV biases), the reference's params, batches,
frames and image embeddings injected:

  * serving (``cross_device``): 4 prompts of 16 tokens with their
    frames or image embeddings (rows over ``data``, placed with the
    batch), 4 teacher-forced decode steps, 4 greedy ones, held against
    the reference's jitted prefill and decode on an Auto-axes (data 2,
    model 2) mesh of 4 of the conftest's 8 CPU devices and against the
    port's unsharded steps, at 1e-4·max|logits|; the collectives by
    role are ``serve_collectives``' (the encoder's layers and the cross
    K/V's gather at prefill only); Whisper's cached ``enc_kv`` holds
    every KV head of the rank's rows, the same bits on both ``model``
    ranks, and is the reference's; the reference's whole prefill cache
    placed by ``place_for_rank`` decodes as its own;
  * training: one vmap round of Δ-SGD (K = 2) under both federations
    (``cross_device``; ``cross_silo`` with remat, each decoder layer's
    cross-attention params gathered at use for the K/V and again in the
    block), held against the reference's sharded ``make_train_step``
    and the port's unsharded round: loss and η within 1e-5 relative,
    params within 1e-5·max|p| a leaf, every replicated leaf's ``model``
    replicas bitwise equal, the collectives ``train_collectives``';
  * at full width, Whisper's 6 and InternVL2's 14 heads do not split
    over a tensor axis of 4 (or the production mesh's 8): the rules and
    the dry run refuse them, naming the divisibility; they run on
    (data 2, model 2).
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
from repro.models.common import logical_rules as r_logical_rules
from repro.sharding.spec import LogicalRules as RRules
from repro.sharding.spec import batch_shardings as r_batch_sh
from repro.sharding.spec import cache_shardings as r_cache_sh
from repro.sharding.spec import get_federation_spec as r_fed
from repro.sharding.spec import make_param_shardings as r_param_sh
from repro.sharding.spec import serve_batch_shardings as r_sbatch_sh
from repro_torch import interop
from repro_torch.configs import FLConfig, get_config
from repro_torch.core import init_fl_state
from repro_torch.launch import dryrun
from repro_torch.launch.specs import params_struct
from repro_torch.launch.steps import (make_train_step, serve_rules,
                                      train_rules)
from repro_torch.models.model import batch_extras, build_model
from repro_torch.sharding import dist, hlo
from repro_torch.sharding.spec import get_federation_spec, local_block
from repro_torch.utils.tree import tree_flatten

from _torch_tp_hybrid_worker import MESH, tp_config

needs8 = pytest.mark.skipif(jax.device_count() < 8,
                            reason="needs >= 8 host devices "
                                   "(XLA_FLAGS=--xla_force_host_platform"
                                   "_device_count=8)")
pytestmark = needs8

SHAPE = (2, 64, 512)             # layers, d_model, vocab: reduced()
B, S, FORCED, GREEDY = 4, 16, 4, 4
K, TB = 2, 4                     # local steps, rows a client
REL, LOGIT_REL = 1e-5, 1e-4
ARCHS = {"whisper": "whisper-tiny", "internvl2": "internvl2-1b"}
# name -> (arch, federation, remat)
ROUNDS = {"whisper_device": ("whisper-tiny", "cross_device", False),
          "whisper_silo_remat": ("whisper-tiny", "cross_silo", True),
          "internvl2_device": ("internvl2-1b", "cross_device", False),
          "internvl2_silo_remat": ("internvl2-1b", "cross_silo", True)}
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


def _jcfg(arch):
    return jget_config(arch).reduced(*SHAPE)


@functools.lru_cache(maxsize=None)
def _params(arch):
    return jax.device_get(jbuild_model(_jcfg(arch)).init(jax.random.key(3)))


def _extras(arch, lead, seed):
    """The stub frontends' inputs of ``lead`` rows: Whisper's frames,
    InternVL2's image embeddings, standard normal."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(lead + shape).astype(np.float32)
            for k, shape in batch_extras(tp_config(arch, *SHAPE)).items()}


@functools.lru_cache(maxsize=None)
def _prompts(arch):
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, SHAPE[2], (B, S + FORCED)).astype(np.int32)
    return toks[:, :S], toks[:, S:], _extras(arch, (B,), len(arch) + 1)


@functools.lru_cache(maxsize=None)
def _round_batch(arch, fed):
    C = 2 if fed == "cross_device" else 1
    rng = np.random.default_rng(len(arch) + C)
    toks = rng.integers(0, SHAPE[2], (C, K, TB, S + 1)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    batch.update(_extras(arch, (C, K, TB), len(arch) + C + 1))
    return batch


def _cases():
    cases = {}
    for name, arch in ARCHS.items():
        prompts, forced, extras = _prompts(arch)
        cases[f"serve_{name}"] = dict(
            kind="serve", cfg=(arch,) + SHAPE, federation="cross_device",
            params=_params(arch), prompts=prompts, forced=forced,
            extras=extras, greedy=GREEDY,
            whole_cache=_reference_serve(name)[2])
    for name, (arch, fed, remat) in ROUNDS.items():
        state = jax.device_get(r_init(_params(arch), r_sopt("fedavg")))
        cases[name] = dict(kind="round", cfg=(arch,) + SHAPE,
                           federation=fed, params=_params(arch),
                           state=SimpleNamespace(**state._asdict()),
                           batch=_round_batch(arch, fed), K=K, remat=remat,
                           use_pallas=False, scenario=None, draws=None)
    return cases


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case on 4 gloo ranks, one spawn: {name: [rank results]}."""
    from _torch_tp_hybrid_worker import run_rank
    tmp = tmp_path_factory.mktemp("tp_enc_ranks")
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


def _close(got, want, what, rel=REL):
    tol = rel * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"


# ------------------------------------------------------------------ serving
@functools.lru_cache(maxsize=None)
def _reference_serve(name):
    """The reference's sharded prefill and forced decode steps, its
    greedy tokens and its prefill cache."""
    arch = ARCHS[name]
    prompts, forced, extras = _prompts(arch)
    params = _params(arch)
    mesh = _rmesh()
    model = jbuild_model(_jcfg(arch))
    spec = r_fed("cross_device", mesh)
    psh = r_param_sh(spec, mesh, params)
    batch = {"tokens": jnp.asarray(prompts)}
    batch.update({k: jnp.asarray(v) for k, v in extras.items()})
    bsh = r_sbatch_sh(mesh, batch)
    cache_len = S + FORCED + _jcfg(arch).num_image_tokens
    with mesh, r_logical_rules(RRules(spec, mesh, serve=True)):
        prefill = jax.jit(lambda p, b: model.prefill(
            p, b, cache_len=cache_len), in_shardings=(psh, bsh))
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
    return steps, toks, jax.device_get(cache0)


@functools.lru_cache(maxsize=None)
def _unsharded_serve(name):
    """The port's unsharded prefill and forced decode steps, and its
    greedy tokens."""
    arch = ARCHS[name]
    prompts, forced, extras = _prompts(arch)
    model = build_model(tp_config(arch, *SHAPE))
    params = interop.params_from_numpy(_params(arch))
    batch = interop.params_from_numpy(dict(tokens=prompts, **extras))
    logits, cache0 = model.prefill(
        params, batch, cache_len=S + FORCED + model.cfg.num_image_tokens)
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
    return steps, toks


@pytest.mark.parametrize("name", list(ARCHS))
def test_tp_serve_logits_match_reference_sharded(name, port):
    want, _, _ = _reference_serve(name)
    for t in range(1 + FORCED):
        _close(_rows(port[f"serve_{name}"], "logits", t), want[t],
               f"{name} step {t}", LOGIT_REL)


@pytest.mark.parametrize("name", list(ARCHS))
def test_tp_serve_logits_match_unsharded_port(name, port):
    want, _ = _unsharded_serve(name)
    for t in range(1 + FORCED):
        _close(_rows(port[f"serve_{name}"], "logits", t), want[t],
               f"{name} step {t}", LOGIT_REL)


@pytest.mark.parametrize("name", list(ARCHS))
def test_tp_serve_greedy_tokens_match(name, port):
    """Greedy tokens equal the reference's sharded steps and the port's
    unsharded decode, step by step."""
    _, want = _unsharded_serve(name)
    _, rwant, _ = _reference_serve(name)
    for t in range(GREEDY):
        np.testing.assert_array_equal(want[t], rwant[t])
        np.testing.assert_array_equal(
            _rows(port[f"serve_{name}"], "tokens", t), want[t],
            err_msg=f"{name} step {t}")


@pytest.mark.parametrize("name", list(ARCHS))
def test_tp_serve_collectives_a_step(name, port):
    """Each step's collectives by role are ``serve_collectives``';
    ``cross_device`` moves no param. Whisper's prefill adds its 2
    encoder layers' reduces and each decoder layer's cross K/V gather;
    its decode step reduces after self-attention, cross-attention and
    the MLP and gathers the new token's KV heads."""
    for res in port[f"serve_{name}"]:
        for t, ops in enumerate(res["ops"]):
            want = res["want_ops"]["prefill" if t == 0 else "decode"]
            assert dict(Counter(op[1] for op in ops)) == {
                k: v for k, v in want.items() if v}
        spec = get_federation_spec("cross_device", ShapeMesh)
        for ops in res["ops"]:
            hlo.assert_no_param_gather(
                [hlo.CollectiveOp(k, 0, 2, a, role=r, shape=sh)
                 for k, r, a, sh in ops], spec)
    want = port[f"serve_{name}"][0]["want_ops"]
    if name == "whisper":
        assert want["prefill"]["tp_reduce"] == 2 * 2 + 2 * 3
        assert want["prefill"]["kv_gather"] == 2 * 2
        assert want["decode"] == dict(tp_reduce=2 * 3, kv_gather=2,
                                      fsdp_gather=0, fsdp_rows=0, vocab=2)
    else:
        assert want["decode"] == want["prefill"] == dict(
            tp_reduce=2 * 2, kv_gather=2, fsdp_gather=0, fsdp_rows=0,
            vocab=2)


def test_whisper_enc_kv_holds_every_kv_head(port):
    """The cached cross K/V (``enc_kv``) holds every KV head of the
    rank's rows (``cache_shardings`` leaves the KV-head dim whole), the
    same bits on both ``model`` ranks, and is the reference's."""
    _, _, ref = _reference_serve("whisper")
    res = port["serve_whisper"]
    by_data = {}
    for r in res:
        by_data.setdefault(r["coord"]["data"], []).append(r["cache"]["enc_kv"])
    for key in ("xk", "xv"):
        got = []
        for d in (0, 1):
            a, b = by_data[d]
            np.testing.assert_array_equal(a[key], b[key])
            assert a[key].shape[1:] == (B // 2,) + ref["enc_kv"][key].shape[2:]
            got.append(a[key])
        _close(np.concatenate(got, 1), ref["enc_kv"][key], key)


@pytest.mark.parametrize("name", list(ARCHS))
def test_placed_cache_decodes_as_the_prefills(name, port):
    """The reference's whole prefill cache (Whisper's ``enc_kv``
    included), placed by ``place_for_rank`` (rows over data, every KV
    head), decodes as the reference does."""
    want, _, _ = _reference_serve(name)
    for t in range(FORCED):
        _close(_rows(port[f"serve_{name}"], "placed_logits", t),
               want[1 + t], f"{name} placed step {t}", LOGIT_REL)


# ----------------------------------------------------------------- training
@functools.lru_cache(maxsize=None)
def _reference_round(name):
    arch, fed, remat = ROUNDS[name]
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
    arch, fed, remat = ROUNDS[name]
    model = build_model(tp_config(arch, *SHAPE))
    step, sopt, scn, comp = make_train_step(
        model, FLConfig(local_steps=K), remat=remat)
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
    """Every replica of a leaf holds the same bits: the layer norms and
    their biases, the MLP's output bias, the QKV biases (InternVL2's,
    each rank reading its heads' part), the encoder's norm (a leaf
    whose gradient were partial, or counted twice, would drift here)."""
    _, differ = _whole(port[name], _params(ROUNDS[name][0]))
    assert differ == 0


@pytest.mark.parametrize("name", list(ROUNDS))
def test_tp_round_collectives_are_train_collectives(name, port):
    arch, fed, _ = ROUNDS[name]
    for res in port[name]:
        got = Counter(op[1] for op in res["ops"])
        assert dict(got) == res["want_ops"]
        assert all(op[1] in hlo.TRAIN_ROLES for op in res["ops"])
        if fed == "cross_device":
            spec = get_federation_spec("cross_device", ShapeMesh)
            hlo.assert_no_param_gather(
                [hlo.CollectiveOp("all-reduce", 4, 2, op[2], role=op[1])
                 for op in res["ops"]], spec, train=True)


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("arch,heads", [("whisper-tiny", 6),
                                        ("internvl2-1b", 14)])
def test_heads_that_do_not_split_are_refused(arch, heads):
    """At full width the heads do not split over a tensor axis of 4
    ranks, nor over the production mesh's 8: the serve and training
    rules and the dry run refuse, naming the divisibility; over 2 ranks
    they are admitted."""
    model = build_model(get_config(arch))
    struct = params_struct(model)
    msg = f"its {heads} attention heads do not split"
    for rules in (serve_rules, train_rules):
        with pytest.raises(ValueError, match=msg):
            rules(model, dist.AbstractMesh({"data": 1, "model": 4}), struct)
        rules(model, dist.AbstractMesh({"data": 2, "model": 2}), struct)
    for shape in ("prefill_32k", "decode_32k", "train_4k"):
        with pytest.raises(dryrun.Refused, match=msg):
            dryrun.check_lowerable(arch, shape, False)
