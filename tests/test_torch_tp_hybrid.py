"""Port parity for tensor parallelism of Zamba2's Mamba2 mixer and
shared attention block: gloo ranks on the CPU; and the decode cache
whose time dim is cut over ``model``.

Four ranks of ``torch.distributed`` (gloo, one torch thread each) over
a (data 2, model 2) mesh run every case once, in one spawn for the
module (``tests/_torch_tp_hybrid_worker.py``, torch only), on Zamba2 at
``reduced(14, 64, 512)``: 12 Mamba2 layers of 4 heads (2 a rank; the
column blocks of ``w_zx`` and the conv's channel blocks straddle the
heads) and the shared block at two sites; the reference's params,
batches and prompts injected:

  * serving (``cross_device``): 4 prompts of 16 tokens, 4
    teacher-forced decode steps, 4 greedy ones, held against the
    reference's jitted prefill and decode on an Auto-axes (data 2,
    model 2) mesh of 4 of the conftest's 8 CPU devices and against the
    port's unsharded steps, at 1e-4·max|logits| (the SSD scan's
    tolerance: the CPU's cumsum accumulates in f64); the collectives by
    role are ``serve_collectives``'; the ranks' Mamba2 states and conv
    tails, gathered, are the reference's cache; the reference's whole
    prefill cache, placed by ``place_for_rank`` (each rank narrows the
    Mamba2 state to its heads and channels), decodes as its own;
  * training: one vmap round of Δ-SGD (K = 2) under both federations
    (``cross_device``; ``cross_silo`` with remat, the shared block's
    params gathered at each of its sites), held against the reference's
    sharded ``make_train_step`` and the port's unsharded round: loss
    and η within 1e-5 relative, params within 1e-4·max|p| a leaf (the
    SSD scan's tolerance: the training route's ``_ssd_chunked`` sums
    its cumsum in f64 on the CPU, and at this depth the unsharded port
    itself lies up to 2.1e-5·max|p| from the reference, on ``embed``
    and the conv biases, which start at zero), every replicated leaf's
    ``model`` replicas bitwise equal, the collectives
    ``train_collectives``';
  * a shared leaf's gradient is the sum of its two sites', and every
    rank's block of every gradient is the unsharded port's within
    1e-5·max|g| (one plain backward, no Δ-SGD step to amplify the sum
    orders);
  * at (data 1, model 4) the one DeepSeek-V3 layer's prefill cache,
    whole over the sequence on each rank, still serves;
  * the decode cache at (data 1, model 4), where the reference puts its
    time dim over ``model``: the GQA and MLA caches placed by
    ``place_for_rank`` or made by ``init_cache`` hold the rank's time
    block and decode as the unsharded port does; a Mamba2 state cut
    over its heads is accepted;
  * the dry run admits Zamba2's three shapes on a rank of (32, 8) and
    lowers its ``decode_32k`` here (its ``prefill_32k`` and ``train_4k``
    take about 90 s each on fake tensors here: ``chip_smoke.py`` lowers
    them beside its phases on the card's host).
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
from repro_torch.configs import FLConfig
from repro_torch.core import init_fl_state
from repro_torch.launch import dryrun
from repro_torch.launch.steps import (make_train_step, place_for_rank,
                                      serve_rules)
from repro_torch.models import transformer as tfm
from repro_torch.models.common import logical_rules
from repro_torch.models.model import build_model
from repro_torch.sharding import dist, hlo
from repro_torch.sharding.spec import (get_federation_spec, local_block,
                                       seq_cut_leaves)
from repro_torch.utils.tree import tree_flatten

from _torch_tp_hybrid_worker import MESH, tp_config

needs8 = pytest.mark.skipif(jax.device_count() < 8,
                            reason="needs >= 8 host devices "
                                   "(XLA_FLAGS=--xla_force_host_platform"
                                   "_device_count=8)")
pytestmark = needs8

ARCH = "zamba2-7b"
SHAPE = (14, 64, 512)            # layers (two shared sites), d_model, vocab
B, S, FORCED, GREEDY = 4, 16, 4, 4
K, TB = 2, 4                     # local steps, rows a client
REL, SSD_REL = 1e-5, 1e-4
# name -> (federation, remat)
ROUNDS = {"zamba2_device": ("cross_device", False),
          "zamba2_silo_remat": ("cross_silo", True)}
METRICS = ("loss", "loss_last_step", "eta_mean", "eta_min", "eta_max")
ONE_DATA = ((1, 4), ("data", "model"))
MLA_L1 = ("deepseek-v3-671b", 1, 256, 512)
# the caches cut over their time dim at (data 1, model 4): 8 slots, 2 a
# rank, a prefill of 4 prompt tokens before the forced steps
CUT_ARCHS = (("tinyllama-1.1b", (2, 64, 512)), (MLA_L1[0], MLA_L1[1:]))
CUT_LEN, CUT_PROMPT = 8, 4


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


def _jcfg(arch=ARCH, shape=SHAPE):
    return jget_config(arch).reduced(*shape)


@functools.lru_cache(maxsize=None)
def _params(arch=ARCH, shape=SHAPE):
    return jax.device_get(jbuild_model(_jcfg(arch, shape)).init(
        jax.random.key(3)))


@functools.lru_cache(maxsize=None)
def _prompts(arch=ARCH):
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, SHAPE[2], (B, S + FORCED)).astype(np.int32)
    return toks[:, :S], toks[:, S:]


@functools.lru_cache(maxsize=None)
def _round_batch(fed):
    C = 2 if fed == "cross_device" else 1
    rng = np.random.default_rng(C)
    toks = rng.integers(0, SHAPE[2], (C, K, TB, S + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


@functools.lru_cache(maxsize=None)
def _grad_batch():
    rng = np.random.default_rng(11)
    toks = rng.integers(0, SHAPE[2], (2, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _cases():
    prompts, forced = _prompts()
    cases = {"serve": dict(kind="serve", cfg=(ARCH,) + SHAPE,
                           federation="cross_device", params=_params(),
                           prompts=prompts, forced=forced, greedy=GREEDY,
                           whole_cache=_reference_serve()[2])}
    for name, (fed, remat) in ROUNDS.items():
        state = jax.device_get(r_init(_params(), r_sopt("fedavg")))
        cases[name] = dict(kind="round", cfg=(ARCH,) + SHAPE,
                           federation=fed, params=_params(),
                           state=SimpleNamespace(**state._asdict()),
                           batch=_round_batch(fed), K=K, remat=remat,
                           use_pallas=False, scenario=None, draws=None)
    cases["grad"] = dict(kind="grad", cfg=(ARCH,) + SHAPE, params=_params(),
                         batch=_grad_batch())
    mla = _params(MLA_L1[0], MLA_L1[1:])
    cases["mla_one_data"] = dict(kind="serve", cfg=MLA_L1, mesh=ONE_DATA,
                                 federation="cross_silo", params=mla,
                                 prompts=prompts, forced=forced,
                                 greedy=GREEDY)
    for arch, shape in CUT_ARCHS:
        for how in ("place_for_rank", "init_cache"):
            case = dict(kind="cut_decode", cfg=(arch,) + shape,
                        mesh=ONE_DATA, federation="cross_silo",
                        params=_params(arch, shape), forced=forced,
                        how=how, cache_len=CUT_LEN)
            if how == "place_for_rank":
                case["whole_cache"] = _cut_start(arch, shape)[1]
            cases[f"cut_{arch}_{how}"] = case
    return cases


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case on 4 gloo ranks, one spawn: {name: [rank results]}."""
    from _torch_tp_hybrid_worker import run_rank
    tmp = tmp_path_factory.mktemp("tp_hybrid_ranks")
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
def _reference_serve():
    """The reference's sharded prefill and forced decode steps, and its
    greedy tokens: (logits a step, tokens a step, prefill cache)."""
    prompts, forced = _prompts()
    params = _params()
    mesh = _rmesh()
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
    return steps, toks, jax.device_get(cache0)


@functools.lru_cache(maxsize=None)
def _unsharded_serve(arch=ARCH, shape=SHAPE):
    """The port's unsharded prefill and forced decode steps, and its
    greedy tokens."""
    prompts, forced = _prompts()
    model = build_model(tp_config(arch, *shape))
    params = interop.params_from_numpy(_params(arch, shape))
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
    return steps, toks


def test_tp_serve_logits_match_reference_sharded(port):
    want, _, _ = _reference_serve()
    for t in range(1 + FORCED):
        _close(_rows(port["serve"], "logits", t), want[t], f"step {t}",
               SSD_REL)


def test_tp_serve_logits_match_unsharded_port(port):
    want, _ = _unsharded_serve()
    for t in range(1 + FORCED):
        _close(_rows(port["serve"], "logits", t), want[t], f"step {t}",
               SSD_REL)


def test_tp_serve_greedy_tokens_match(port):
    """Greedy tokens equal the reference's sharded steps and the port's
    unsharded decode, step by step."""
    _, want = _unsharded_serve()
    _, rwant, _ = _reference_serve()
    for t in range(GREEDY):
        np.testing.assert_array_equal(want[t], rwant[t])
        np.testing.assert_array_equal(_rows(port["serve"], "tokens", t),
                                      want[t], err_msg=f"step {t}")


def test_tp_serve_collectives_a_step(port):
    """Each step's collectives by role are ``serve_collectives``': a
    Mamba2 layer gathers its ``w_zx`` product and its conv weights, sums
    its norm's squares and reduces ``w_out``'s partials; each shared
    site reduces after attention and the MLP and gathers its KV heads;
    ``cross_device`` moves no param but the conv's weights."""
    for res in port["serve"]:
        for t, ops in enumerate(res["ops"]):
            want = res["want_ops"]["prefill" if t == 0 else "decode"]
            assert dict(Counter(op[1] for op in ops)) == {
                k: v for k, v in want.items() if v}
        spec = get_federation_spec("cross_device", ShapeMesh)
        for ops in res["ops"]:
            hlo.assert_no_param_gather(
                [hlo.CollectiveOp(k, 0, 2, a, role=r, shape=sh)
                 for k, r, a, sh in ops], spec)
    assert port["serve"][0]["want_ops"]["decode"] == dict(
        tp_reduce=12 + 2 * 2, kv_gather=2, fsdp_gather=0, fsdp_rows=0,
        vocab=2, ssm_zx=12, ssm_conv=12, ssm_norm=12)


def _mamba_runs(cache):
    return [k for k, v in cache["runs"].items() if "ssm" in v]


def test_mamba2_cache_gathered_is_the_references(port):
    """The ranks' Mamba2 states (their heads) and conv tails (their
    heads' x channels, the one group's B and C, the same on both model
    ranks), put together, are the reference's prefill cache."""
    _, _, ref = _reference_serve()
    cfg = tp_config(ARCH, *SHAPE)
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    res = port["serve"]
    runs = _mamba_runs(ref)
    assert runs == ["run0", "run2"]
    for run in runs:
        ssm = [[None, None], [None, None]]
        xs = [[None, None], [None, None]]
        bc = [[], []]
        for r in res:
            d, m = r["coord"]["data"], r["coord"]["model"]
            c = r["cache"]["runs"][run]
            h = c["ssm"].shape[2]
            assert h == 2 and c["conv"].shape[-1] == h * P + 2 * N
            ssm[d][m] = c["ssm"]
            xs[d][m] = c["conv"][..., :h * P]
            bc[d].append(c["conv"][..., h * P:])
        for d in (0, 1):
            np.testing.assert_array_equal(bc[d][0], bc[d][1])
        got_ssm = np.concatenate([np.concatenate(s, 2) for s in ssm], 1)
        got_conv = np.concatenate(
            [np.concatenate(xs[d] + [bc[d][0]], -1) for d in (0, 1)], 1)
        _close(got_ssm, ref["runs"][run]["ssm"], f"{run} ssm", SSD_REL)
        _close(got_conv, ref["runs"][run]["conv"], f"{run} conv", REL)


def test_placed_cache_decodes_as_the_prefills(port):
    """The reference's whole prefill cache placed by ``place_for_rank``
    (its rows over data; each rank's Mamba2 state narrowed to its heads
    and its conv to its channels, where the reference's table leaves
    them whole on every model rank) decodes as the reference does."""
    want, _, ref = _reference_serve()
    cfg = tp_config(ARCH, *SHAPE)
    for r in port["serve"]:
        sh = r["placed_shapes"]
        assert sh["runs/run0/ssm"] == (6, B // 2, 2, cfg.ssm_head_dim,
                                       cfg.ssm_state)
        assert sh["runs/run0/conv"][-1] == 2 * cfg.ssm_head_dim \
            + 2 * cfg.ssm_state
        assert sh["runs/run1/k"] == ref["runs"]["run1"]["k"].shape[:1] + (
            B // 2,) + ref["runs"]["run1"]["k"].shape[2:]
    for t in range(FORCED):
        _close(_rows(port["serve"], "placed_logits", t), want[1 + t],
               f"placed step {t}", SSD_REL)


# ----------------------------------------------------------------- training
@functools.lru_cache(maxsize=None)
def _reference_round(name):
    fed, remat = ROUNDS[name]
    params, batch = _params(), _round_batch(fed)
    mesh = _rmesh()
    model = jbuild_model(_jcfg())
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
    fed, remat = ROUNDS[name]
    model = build_model(tp_config(ARCH, *SHAPE))
    step, sopt, scn, comp = make_train_step(
        model, FLConfig(local_steps=K), remat=remat)
    state = init_fl_state(interop.params_from_numpy(_params()), sopt, scn,
                          comp)
    new, metrics = step(state, interop.params_from_numpy(_round_batch(fed)))
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
        tol = SSD_REL * float(np.abs(w).max())
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
    _held(_whole(port[name], _params())[0], params)


@pytest.mark.parametrize("name", list(ROUNDS))
def test_tp_round_matches_the_unsharded_port(name, port):
    metrics, params = _unsharded_round(name)
    for res in port[name]:
        _metrics_held(res["metrics"], metrics)
    _held(_whole(port[name], _params())[0], params)


@pytest.mark.parametrize("name", list(ROUNDS))
def test_replicated_leaves_are_bitwise_equal_across_ranks(name, port):
    """Every replica of a leaf holds the same bits: the block norms, the
    shared block's norms and, under ``cross_silo``, its params gathered
    at two sites (a leaf whose gradient were partial, or counted twice,
    would drift here)."""
    _, differ = _whole(port[name], _params())
    assert differ == 0


@pytest.mark.parametrize("name", list(ROUNDS))
def test_tp_round_collectives_are_train_collectives(name, port):
    fed, remat = ROUNDS[name]
    for res in port[name]:
        got = Counter(op[1] for op in res["ops"])
        assert dict(got) == res["want_ops"]
        assert all(op[1] in hlo.TRAIN_ROLES for op in res["ops"])
        # each Mamba2 layer's gathers and norm sum, forward (twice under
        # remat) and backward
        assert got["ssm_norm"] == 12 * K * (3 if remat else 2)
        if fed == "cross_device":
            spec = get_federation_spec("cross_device", ShapeMesh)
            hlo.assert_no_param_gather(
                [hlo.CollectiveOp("all-reduce", 4, 2, op[2], role=op[1])
                 for op in res["ops"]], spec, train=True)


# ------------------------------------------------------- the shared block
def _site_grads(params, batch, detach_site):
    """The unsharded port's gradients with the shared block's params
    detached at site ``detach_site`` (0 or 1; None: at neither)."""
    model = build_model(tp_config(ARCH, *SHAPE))
    p = interop.params_from_numpy(params)
    leaves, treedef = tree_flatten(p)
    for x in leaves:
        x.requires_grad_(True)
    run_params = tfm._run_params
    seen = []

    def patched(pp, i, btype, n):
        out = run_params(pp, i, btype, n)
        if btype == "shared_attn":
            site = len(seen)
            seen.append(i)
            if site == detach_site:
                out = [{k: _detach(v) for k, v in out[0].items()}]
        return out

    tfm._run_params = patched
    try:
        loss, _ = model.loss(p, interop.params_from_numpy(batch),
                             use_pallas=False)
    finally:
        tfm._run_params = run_params
    grads = torch.autograd.grad(loss, leaves)
    return {"/".join(k): g.numpy() for k, g in zip(treedef, grads)}


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()


def test_shared_block_gradient_sums_its_sites(port):
    """The shared block's one set of params reads the stream at two
    sites: each leaf's gradient is the sum of its two sites'
    (the unsharded port's, each site's with the other detached), and
    every rank's block of it under training rules is the unsharded
    port's."""
    both = _site_grads(_params(), _grad_batch(), None)
    first = _site_grads(_params(), _grad_batch(), 1)
    second = _site_grads(_params(), _grad_batch(), 0)
    shared = [k for k in both if k.startswith("stack/shared_attn/")]
    assert len(shared) == 9         # 2 norms, 4 attention, 3 MLP
    for k in shared:
        assert float(np.abs(first[k]).max()) > 0
        assert float(np.abs(second[k]).max()) > 0
        _close(first[k] + second[k], both[k], k, REL)
    for r in port["grad"]:
        flat = dict(zip(("/".join(p) for p in tree_flatten(r["grads"])[1]),
                        tree_flatten(r["grads"])[0]))
        axes = dict(zip(("/".join(p) for p in tree_flatten(r["axes"])[1]),
                        tree_flatten(r["axes"])[0]))
        for k, g in flat.items():
            want = local_block(torch.from_numpy(both[k]), axes[k],
                               ShapeMesh, r["coord"]).numpy()
            _close(g, want, f"{k} at {r['coord']}", REL)


# -------------------------------------------- C2: the cache at one data rank
def _one_data_rules(arch, shape, coords=None):
    model = build_model(tp_config(arch, *shape))
    params = model.init(torch.Generator().manual_seed(0))
    mesh = dist.AbstractMesh({"data": 1, "model": 4}, coords)
    return model, params, serve_rules(model, mesh, params, batch_size=B)


@functools.lru_cache(maxsize=None)
def _cut_start(arch, shape):
    """The port's unsharded prefill of the prompts' first CUT_PROMPT
    tokens into CUT_LEN slots: (the model, its cache as numpy)."""
    prompts, _ = _prompts()
    model = build_model(tp_config(arch, *shape))
    params = interop.params_from_numpy(_params(arch, shape))
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(
        prompts[:, :CUT_PROMPT])}, cache_len=CUT_LEN)
    return model, interop.params_to_numpy(cache)


@functools.lru_cache(maxsize=None)
def _cut_unsharded(arch, shape, how):
    """The port's unsharded forced steps from the same start: the
    prefill's cache or an empty one."""
    _, forced = _prompts()
    model = build_model(tp_config(arch, *shape))
    params = interop.params_from_numpy(_params(arch, shape))
    cache = (interop.params_from_numpy(_cut_start(arch, shape)[1])
             if how == "place_for_rank"
             else model.init_cache(B, CUT_LEN, device="cpu"))
    steps = []
    for t in range(FORCED):
        logits, cache = model.decode_step(
            params, cache, torch.from_numpy(forced[:, t:t + 1]))
        steps.append(logits[:, 0].numpy())
    return steps


@pytest.mark.parametrize("arch,shape", list(CUT_ARCHS))
@pytest.mark.parametrize("how", ["place_for_rank", "init_cache"])
def test_attention_caches_are_refused_at_one_data_rank(arch, shape, how,
                                                       port):
    """At (data 1, model 4) the rows do not split, so the reference's
    ``cache_shardings`` puts the GQA K/V's and the MLA latent's sequence
    dim over ``model``. Such a cache, placed by ``place_for_rank`` (the
    port's whole prefill cache) or made by ``init_cache`` under the
    rules, holds the rank's 2 of the 8 slots and decodes as the
    unsharded port does, each rank's logits within 1e-5·max|logits|
    (the rank that owns a slot writes it; the blocks' softmax parts are
    combined over ``model``)."""
    model, _ = _cut_start(arch, shape)
    _, _, rules = _one_data_rules(arch, shape)
    whole = model.init_cache(B, CUT_LEN, device="cpu")
    leaves = {"k", "v"} if not model.cfg.use_mla else {"c_kv", "k_rope"}
    cut = seq_cut_leaves(rules.spec, rules.mesh, whole, batch_size=B)
    assert {p.rsplit("/", 1)[1] for p in cut} == leaves
    want = _cut_unsharded(arch, shape, how)
    for r in port[f"cut_{arch}_{how}"]:
        for p in cut:
            assert r["shapes"][p][2] == CUT_LEN // 4, p
        for t in range(FORCED):
            _close(r["logits"][t], want[t], f"{how} step {t}", REL)
    # a sequence that does not split four ways stays whole
    with logical_rules(rules):
        odd = model.init_cache(B, 9, device="cpu")
    assert tree_flatten(odd["runs"])[0][0].shape[2] == 9


def test_mamba2_state_cut_over_heads_is_accepted_at_one_data_rank():
    """At (data 1, model 4) the reference's table cuts the Mamba2 state
    over its heads (the rank's own block) and leaves the conv's three
    taps whole: not refused. ``place_for_rank`` narrows the conv to the
    rank's channels, and ``init_cache`` makes the same shapes. With the
    shared block, only its K and V are cut over their time dim (which
    the decode reads)."""
    shape = (6, 64, 512)             # six Mamba2 layers, no shared site
    cfg = tp_config(ARCH, *shape)
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    for t in range(4):
        model, _, rules = _one_data_rules(ARCH, shape, {"model": t})
        whole = model.init_cache(B, 8, device="cpu")
        whole["runs"]["run0"]["ssm"].normal_()
        whole["runs"]["run0"]["conv"].normal_()
        assert seq_cut_leaves(rules.spec, rules.mesh, whole,
                              batch_size=B) == []
        placed = place_for_rank(rules, cache=whole, batch_size=B)["cache"]
        ssm, conv = placed["runs"]["run0"]["ssm"], \
            placed["runs"]["run0"]["conv"]
        assert tuple(ssm.shape) == (6, B, 1, P, N)
        assert tuple(conv.shape) == (6, B, 3, P + 2 * N)
        assert torch.equal(ssm, whole["runs"]["run0"]["ssm"][:, :, t:t + 1])
        d_in = 4 * P
        assert torch.equal(conv[..., :P],
                           whole["runs"]["run0"]["conv"][..., t * P:
                                                         (t + 1) * P])
        assert torch.equal(conv[..., P:],
                           whole["runs"]["run0"]["conv"][..., d_in:])
        with logical_rules(rules):
            mine = model.init_cache(B, 8, device="cpu")
        assert tuple(mine["runs"]["run0"]["ssm"].shape) == tuple(ssm.shape)
        assert tuple(mine["runs"]["run0"]["conv"].shape) == \
            tuple(conv.shape)
    model, _, rules = _one_data_rules(ARCH, SHAPE)
    cut = seq_cut_leaves(rules.spec, rules.mesh,
                         model.init_cache(B, 8, device="cpu"), batch_size=B)
    assert cut == ["runs/run1/k", "runs/run1/v", "runs/run3/k",
                   "runs/run3/v"]


def test_mla_prefill_cache_still_serves_at_one_data_rank(port):
    """DeepSeek-V3's one layer on (data 1, model 4): prefill builds its
    own latent cache, whole over the sequence on every rank, and decodes
    from it as the unsharded port does."""
    steps, toks = _unsharded_serve(MLA_L1[0], MLA_L1[1:])
    for r in port["mla_one_data"]:
        assert r["coord"]["data"] == 0
        for t in range(1 + FORCED):
            _close(r["logits"][t], steps[t], f"step {t}", REL)
        for t in range(GREEDY):
            np.testing.assert_array_equal(r["tokens"][t], toks[t])
        c = r["cache"]["runs"]["run0"]["c_kv"]
        assert c.shape[1:3] == (B, S + FORCED)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k",
                                   "train_4k"])
def test_zamba2_lowers_on_the_production_mesh(shape):
    """Zamba2's three shapes on a rank of (data 32, model 8) are
    admitted: 14 Mamba2 heads a rank (112 over 8) and 4 shared-block
    heads. ``decode_32k`` lowers, its collectives with every Mamba2
    role."""
    dryrun.check_lowerable(ARCH, shape, False)
    if shape != "decode_32k":
        return
    res = dryrun.lower_one(ARCH, shape, False, verbose=False)
    for role in ("ssm_zx", "ssm_conv", "ssm_norm"):
        assert res["collectives"][role] > 0
    assert res["roofline"]["flops"] > 0
