"""Port parity for tensor-parallel serving: gloo ranks on the CPU.

Four ranks of ``torch.distributed`` (gloo, one torch thread each) over a
(data 2, model 2) mesh run every case once, in one spawn for the module
(``tests/_torch_tp_worker.py``, torch only): reduced TinyLlama (its KV
heads sharded over ``model``, ``cross_device``), Granite (MQA: the one
KV head on every rank; the GELU MLP's biases) and Qwen2.5 (QKV biases),
the last two ``cross_silo`` (params FSDP over ``data``), 2 layers at
d_model 64, the reference's weights injected through
``interop.params_local_from_numpy``. Each case prefills 4 prompts of 16
tokens (2 rows a data rank), takes 4 teacher-forced decode steps, then 4
greedy ones from the prefill.

Held against the reference's sharded steps: its ``Model.prefill`` and
``decode_step``, and the greedy argmax of ``make_serve_step``, jitted
with
``make_param_shardings``, ``serve_batch_shardings`` and
``cache_shardings`` under ``LogicalRules(serve=True)`` on a (data 2,
model 2) mesh of 4 of the conftest's 8 CPU devices with Auto axis types
(jax 0.9's Explicit axes break the reference's sharded runs), and
against the port's unsharded steps: logits within 1e-5·max|logits|,
greedy tokens equal while the top-two margin exceeds that tolerance.
Each step's collectives are counted by role against
``launch.steps.serve_collectives``.
"""
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models.common import logical_rules as r_logical_rules
from repro.sharding.spec import LogicalRules as RRules
from repro.sharding.spec import cache_shardings as r_cache_sh
from repro.sharding.spec import get_federation_spec as r_fed
from repro.sharding.spec import make_param_shardings as r_param_sh
from repro.sharding.spec import serve_batch_shardings as r_batch_sh
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.steps import serve_rules
from repro_torch.models.common import logical_rules
from repro_torch.models.model import build_model
from repro_torch.sharding import dist, hlo
from repro_torch.sharding.spec import get_federation_spec

from _torch_tp_worker import MESH, tp_config

needs8 = pytest.mark.skipif(jax.device_count() < 8,
                            reason="needs >= 8 host devices "
                                   "(XLA_FLAGS=--xla_force_host_platform"
                                   "_device_count=8)")
pytestmark = needs8

SHAPE = (2, 64, 512)             # layers, d_model, vocab
B, FORCED, GREEDY = 4, 4, 4
# arch -> (federation on the mesh, prompt length): Granite's 80-token
# prompts make its prefill gather the embedding table (an fsdp group's
# 320 ids pass the rank's 256 vocab rows), its decode move rows
ARCHS = {"tinyllama-1.1b": ("cross_device", 16),
         "granite-20b": ("cross_silo", 80),
         "qwen2.5-14b": ("cross_silo", 16)}
REL = 1e-5


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


@functools.lru_cache(maxsize=None)
def _case(arch):
    cfg = jget_config(arch).reduced(*SHAPE)
    params = jax.device_get(jbuild_model(cfg).init(jax.random.key(7)))
    fed, S = ARCHS[arch]
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg.vocab_size, (B, S + FORCED)).astype(np.int32)
    return dict(cfg=(arch,) + SHAPE, federation=fed, params=params,
                prompts=toks[:, :S], forced=toks[:, S:], greedy=GREEDY)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case on 4 gloo ranks, one spawn: {arch: [rank results]}."""
    from _torch_tp_worker import run_rank
    tmp = tmp_path_factory.mktemp("tp_ranks")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"mesh": MESH, "cases": {a: _case(a) for a in ARCHS}},
                    f)
    dist.spawn(run_rank, 4, (str(tmp / "in.pkl"), str(tmp)), device="cpu",
               threads=1)
    ranks = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {a: [rk["cases"][a] for rk in ranks] for a in ARCHS}


def _rows(results, key, t):
    """The whole batch's rows of step t from the ranks' blocks (every
    model rank of a data coordinate holds the same rows)."""
    out = [None, None]
    for res in results:
        d = res["coord"]["data"]
        out[d] = res[key][t]
    return np.concatenate(out)


@pytest.fixture(scope="module")
def ref():
    """The reference's sharded steps: {arch: (logits a step, greedy
    tokens a step)}."""
    mesh = _rmesh()
    out = {}
    for arch in ARCHS:
        cs = _case(arch)
        model = jbuild_model(jget_config(arch).reduced(*SHAPE))
        spec = r_fed(ARCHS[arch][0], mesh)
        rules = RRules(spec, mesh, serve=True)
        cache_len = cs["prompts"].shape[1] + FORCED
        psh = r_param_sh(spec, mesh, cs["params"])
        batch = {"tokens": jnp.asarray(cs["prompts"])}
        bsh = r_batch_sh(mesh, batch)
        with mesh, r_logical_rules(rules):
            prefill = jax.jit(lambda p, b: model.prefill(
                p, b, cache_len=cache_len), in_shardings=(psh, bsh))
            logits, cache0 = prefill(cs["params"], batch)
            csh = r_cache_sh(spec, mesh, cache0, batch_size=B)
            cache0 = jax.device_put(cache0, csh)
            tsh = r_batch_sh(mesh, {"t": jnp.zeros((B, 1), jnp.int32)})["t"]
            dec = jax.jit(lambda p, c, t: model.decode_step(p, c, t),
                          in_shardings=(psh, csh, tsh))
            steps = [np.asarray(logits[:, 0])]
            cache = cache0
            for t in range(FORCED):
                logits, cache = dec(cs["params"], cache,
                                    jnp.asarray(cs["forced"][:, t:t + 1]))
                cache = jax.device_put(cache, csh)
                steps.append(np.asarray(logits[:, 0]))
            serve = jax.jit(lambda p, c, t: (lambda lg, c2: (
                jnp.argmax(lg, -1).astype(jnp.int32), c2))(
                    *model.decode_step(p, c, t)),
                in_shardings=(psh, csh, tsh))
            tok = jnp.argmax(steps[0], -1).astype(jnp.int32)[:, None]
            cache, toks = cache0, []
            for _ in range(GREEDY):
                toks.append(np.asarray(tok[:, 0]))
                tok, cache = serve(cs["params"], cache, tok)
                cache = jax.device_put(cache, csh)
        out[arch] = (steps, toks)
    return out


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded steps on the same inputs."""
    out = {}
    for arch in ARCHS:
        cs = _case(arch)
        model = build_model(tp_config(*cs["cfg"]))
        params = interop.params_from_numpy(cs["params"])
        logits, cache0 = model.prefill(
            params, {"tokens": torch.from_numpy(cs["prompts"])},
            cache_len=cs["prompts"].shape[1] + FORCED)
        steps, cache = [logits[:, 0].numpy()], cache0
        for t in range(FORCED):
            logits, cache = model.decode_step(
                params, cache, torch.from_numpy(cs["forced"][:, t:t + 1]))
            steps.append(logits[:, 0].numpy())
        tok, cache, toks = torch.argmax(torch.from_numpy(steps[0]), -1)[
            :, None], cache0, []
        for _ in range(GREEDY):
            toks.append(tok[:, 0].numpy())
            logits, cache = model.decode_step(params, cache, tok)
            tok = torch.argmax(logits, -1)
        out[arch] = (steps, toks)
    return out


def _close(got, want, what):
    tol = REL * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max |diff| {err} > {tol}"


@pytest.mark.parametrize("arch", list(ARCHS))
def test_tp_logits_match_reference_sharded(arch, port, ref):
    want, _ = ref[arch]
    for t in range(1 + FORCED):
        _close(_rows(port[arch], "logits", t), want[t], f"{arch} step {t}")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_tp_logits_match_unsharded_port(arch, port, unsharded):
    want, _ = unsharded[arch]
    for t in range(1 + FORCED):
        _close(_rows(port[arch], "logits", t), want[t], f"{arch} step {t}")


def _margin_equal(got, want, logits, what):
    """Tokens equal wherever the step's top-two margin of the unsharded
    logits exceeds the tolerance."""
    srt = np.sort(logits, -1)
    margin = srt[:, -1] - srt[:, -2]
    sure = margin > REL * float(np.abs(logits).max())
    np.testing.assert_array_equal(got[sure], want[sure], err_msg=what)
    return int(sure.sum())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_tp_greedy_tokens_match(arch, port, ref, unsharded):
    """Greedy tokens equal the reference's sharded serve step and the
    port's unsharded decode while the runs agree; the first is the
    prefill's argmax."""
    _, want = unsharded[arch]
    _, rwant = ref[arch]
    checked = 0
    for t in range(GREEDY):
        got = _rows(port[arch], "tokens", t)
        np.testing.assert_array_equal(want[t], rwant[t])
        if t == 0:
            logits = unsharded[arch][0][0]
            checked += _margin_equal(got, want[t], logits, f"{arch} {t}")
        elif np.array_equal(_rows(port[arch], "tokens", t - 1),
                            want[t - 1]):
            np.testing.assert_array_equal(got, want[t], err_msg=f"{arch} {t}")
            checked += len(got)
    assert checked >= B


@pytest.mark.parametrize("arch", list(ARCHS))
def test_tp_collectives_a_step(arch, port):
    """Each step's collectives by role: what ``serve_collectives``
    derives from the placement, every step the same; cross_device moves
    no param and crosses no data axis."""
    for res in port[arch]:
        for t, ops in enumerate(res["ops"]):
            want = res["want_ops"]["prefill" if t == 0 else "decode"]
            got = {}
            for _, role, _, _ in ops:
                got[role] = got.get(role, 0) + 1
            assert got == {k: v for k, v in want.items() if v}, (arch, t, ops)
        if ARCHS[arch][0] == "cross_device":
            spec = get_federation_spec("cross_device", ShapeMesh)
            for ops in res["ops"]:
                hlo.assert_no_param_gather(
                    [hlo.CollectiveOp(k, 0, 2, a, role=r, shape=sh)
                     for k, r, a, sh in ops], spec)


def _ops(tp_reduce, kv_gather, vocab, fsdp_gather, fsdp_rows):
    return dict(tp_reduce=tp_reduce, kv_gather=kv_gather, vocab=vocab,
                fsdp_gather=fsdp_gather, fsdp_rows=fsdp_rows)


# 2 layers: tp reduce after attention and MLP, the KV gather where the
# KV heads split, the embedding's and the logits' vocab ops; fsdp: a
# gather a layer of Qwen2.5's wq, wk, wv, wo, w_gate, w_in, w_out
# (Granite's wq, wk, wv, wo, w_in, w_out: D splits, its MQA head not),
# and for each vocab table a gather or, where the group's rows are
# cheaper, two row ops
EXPECTED_OPS = {
    "tinyllama-1.1b": {"prefill": _ops(4, 2, 2, 0, 0),
                       "decode": _ops(4, 2, 2, 0, 0)},
    "granite-20b": {"prefill": _ops(4, 0, 2, 2 * 6 + 1, 2),
                    "decode": _ops(4, 0, 2, 2 * 6, 4)},
    "qwen2.5-14b": {"prefill": _ops(4, 2, 2, 2 * 7, 4),
                    "decode": _ops(4, 2, 2, 2 * 7, 4)},
}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_tp_collective_count_is_the_derived_one(arch, port):
    for res in port[arch]:
        assert res["want_ops"] == EXPECTED_OPS[arch]
        # the cache holds the rank's 2 rows
        assert res["cache_rows"] == B // 2


def test_no_param_gather_refuses_an_fsdp_gather():
    spec = get_federation_spec("cross_device", ShapeMesh)
    bad = [hlo.CollectiveOp("all-gather", 4, 2, ("data",),
                            role="fsdp_gather")]
    with pytest.raises(AssertionError):
        hlo.assert_no_param_gather(bad, spec)
    with pytest.raises(ValueError):
        hlo.assert_no_param_gather(
            [], get_federation_spec("cross_silo", ShapeMesh))


# -------------------------------------------------------------- refusals
def _rules(arch):
    model = build_model(get_config_reduced(arch))
    params = model.init(torch.Generator().manual_seed(0))
    mesh = dist.AbstractMesh({"data": 2, "model": 2})
    return model, params, mesh


def get_config_reduced(arch):
    return tp_config(arch, *SHAPE)


ADMITTED = ("tinyllama-1.1b", "codeqwen1.5-7b", "qwen2.5-14b",
            "granite-20b", "olmoe-1b-7b", "deepseek-v3-671b", "zamba2-7b",
            "whisper-tiny", "internvl2-1b")


@pytest.mark.parametrize("arch", ADMITTED)
def test_admitted_archs_run_under_a_mesh(arch):
    """Every arch but xLSTM runs under rules (the dense decoders here
    and in tests/test_torch_tp_train.py, the MoE and MLA ones in
    tests/test_torch_tp_moe.py, Zamba2 in tests/test_torch_tp_hybrid.py,
    Whisper and InternVL2 in tests/test_torch_tp_enc.py): its serve
    rules on (data 2, model 2), and its cache under them, the rank's
    rows of every run (a Mamba2 run: its heads, and its heads' x
    channels and B and C in the conv tail). The dry run lowers
    ``decode_32k`` on (data 32, model 8) where the heads split 8 ways;
    Whisper's 6 and InternVL2's 14 do not, and it says so."""
    from repro_torch.models.ssm import mamba2_dims
    model, params, mesh = _rules(arch)
    rules = serve_rules(model, mesh, params, batch_size=4)
    heads = get_config(arch).num_heads
    if heads % 8:
        with pytest.raises(dryrun.Refused, match=f"its {heads} attention "
                                                 "heads do not split"):
            dryrun.check_lowerable(arch, "decode_32k", False)
    else:
        dryrun.check_lowerable(arch, "decode_32k", False)
    with logical_rules(rules):
        cache = model.init_cache(4, 8, device="cpu")
    for run in cache["runs"].values():
        for leaf in run.values():
            assert leaf.shape[1] == 2
        if "ssm" in run:
            d_in, H, P, G, N = mamba2_dims(model.cfg)
            assert run["ssm"].shape[2] == H // 2
            assert run["conv"].shape[-1] == d_in // 2 + 2 * G * N
    want = set()
    for btype in model.cfg.layer_types:
        want |= ({"ssm", "conv"} if btype == "mamba2" else
                 {"c_kv", "k_rope"} if model.cfg.use_mla else {"k", "v"})
    assert {k for r in cache["runs"].values() for k in r} == want


@pytest.mark.parametrize("arch", ["xlstm-1.3b"])
def test_other_archs_are_refused_under_a_mesh(arch):
    """xLSTM, the last arch tensor parallelism refused, runs under rules
    since its own slice (tests/test_torch_tp_xlstm.py): its serve rules
    on (data 2, model 2), its cache the rank's rows of every state, its
    ``decode_32k`` admitted on (data 32, model 8) whatever its 4 heads
    (no param of it splits by them). What stays refused, for every
    arch, is the sequence-sharded rules (ROADMAP A17, with
    launch/perf.py's variants)."""
    model, params, mesh = _rules(arch)
    rules = serve_rules(model, mesh, params, batch_size=4)
    dryrun.check_lowerable(arch, "decode_32k", False)
    with logical_rules(rules):
        cache = model.init_cache(4, 8, device="cpu")
    for run in cache["runs"].values():
        for leaf in run.values():
            assert leaf.shape[1] == 2
    with logical_rules(serve_rules(model, mesh, params, seq_shard=True)), \
            pytest.raises(ValueError, match="ROADMAP A17"):
        model.init_cache(4, 8, device="cpu")


@pytest.mark.parametrize("what", ["long_500k", "train_4k", "apply",
                                  "seq_shard", "multi_pod_prefill"])
def test_serving_refusals(what):
    model, params, mesh = _rules("tinyllama-1.1b")
    if what == "long_500k":
        # lowers since the decode on a time-cut cache
        # (tests/test_torch_seq_decode.py); heads that do not split
        # over 8 ranks stay refused there as at every shape
        dryrun.check_lowerable("tinyllama-1.1b", what, False)
        with pytest.raises(dryrun.Refused, match="heads do not split"):
            dryrun.check_lowerable("whisper-tiny", what, False)
    elif what == "train_4k":
        # tensor-parallel training lowers every arch's train_4k whose
        # heads split over 8 ranks, xLSTM's since its TP slice
        dryrun.check_lowerable("tinyllama-1.1b", what, False)
        dryrun.check_lowerable("olmoe-1b-7b", what, False)
        dryrun.check_lowerable("zamba2-7b", what, False)
        dryrun.check_lowerable("xlstm-1.3b", what, False)
        with pytest.raises(dryrun.Refused, match="heads do not split"):
            dryrun.check_lowerable("internvl2-1b", what, False)
    elif what == "multi_pod_prefill":
        with pytest.raises(dryrun.Refused, match="64 data ranks"):
            dryrun.check_lowerable("tinyllama-1.1b", "prefill_32k", True)
    else:
        rules = serve_rules(model, mesh, params,
                            seq_shard=what == "seq_shard")
        batch = {"tokens": torch.zeros((2, 8), dtype=torch.long)}
        # the full forward is training's: under serving rules it is
        # refused as serving's steps are under training rules
        match = "under serving rules" if what == "apply" else "ROADMAP A17"
        with logical_rules(rules), pytest.raises(ValueError, match=match):
            if what == "apply":
                model.apply(params, batch)
            else:
                model.prefill(params, batch)


def test_shard_logical_checks_local_shapes():
    """Without rules a no-op; under rules a tensor whose local shape is
    not the rules' raises."""
    from repro_torch.models.common import shard_logical
    x = torch.zeros((2, 8, 4, 16))
    assert shard_logical(x, ("batch", "seq", "heads", None),
                         (None, 8, 4, 16)) is x
    model, params, mesh = _rules("tinyllama-1.1b")
    with logical_rules(serve_rules(model, mesh, params)):
        shard_logical(x[:, :, :2], ("batch", "seq", "heads", None),
                      (None, 8, 4, 16))
        with pytest.raises(ValueError, match="not the rules'"):
            shard_logical(x, ("batch", "seq", "heads", None),
                          (None, 8, 4, 16))


def test_heads_straddling_two_kv_heads_are_refused():
    """12 heads over 3 KV heads on a tensor axis of 2: 3 does not split,
    so every rank projects the 3 KV heads, and a rank's 6 query heads
    would read two of them."""
    import dataclasses
    from repro_torch.models import attention as attn
    cfg = dataclasses.replace(tp_config("tinyllama-1.1b", 1, 96, 512),
                              num_heads=12, num_kv_heads=3, head_dim=8)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rules = serve_rules(model, dist.AbstractMesh({"data": 2, "model": 2}),
                        params)
    loc = {"wq": params["stack"]["run0"]["attn"]["wq"][:, :6],
           "wk": params["stack"]["run0"]["attn"]["wk"]}
    with logical_rules(rules), pytest.raises(ValueError, match="straddle"):
        attn.heads_of(loc, cfg)


def test_init_cache_under_rules_is_the_ranks_block():
    """Under serve rules ``init_cache`` takes the global batch and
    holds the rank's rows (over data) with every KV head, as
    ``cache_shardings`` places the cache. Three rows do not split over
    the two data ranks: the rows stay whole, and where the 8 cache
    entries then split over ``model`` (the reference's placement of the
    sequence), the rank holds its block of 4 of them (the decode reads
    it: tests/test_torch_seq_decode.py); 9 entries stay whole."""
    model, params, mesh = _rules("tinyllama-1.1b")
    cfg = model.cfg
    with logical_rules(serve_rules(model, mesh, params)):
        cache = model.init_cache(4, 8, device="cpu")
        odd = model.init_cache(3, 9, device="cpu")
        cut = model.init_cache(3, 8, device="cpu")
    assert tuple(cache["runs"]["run0"]["k"].shape) == (
        cfg.num_layers, 2, 8, cfg.num_kv_heads, cfg.head_dim)
    assert odd["runs"]["run0"]["k"].shape[1] == 3
    assert tuple(cut["runs"]["run0"]["k"].shape) == (
        cfg.num_layers, 3, 4, cfg.num_kv_heads, cfg.head_dim)
    assert tuple(cut["positions"].shape) == (8,)
