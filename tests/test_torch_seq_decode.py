"""Port parity for the decode on a cache whose time dim is cut over
``model``: gloo ranks on the CPU.

Where a batch's rows do not split over the data axes (one row, or a
mesh of one data rank), the reference's ``cache_shardings`` cuts the
time dim of each attention cache leaf over ``model``. Four ranks of
``torch.distributed`` (gloo, one torch thread each) on a (data 1,
model 4) mesh run every case once, in one spawn for the module
(``tests/_torch_tp_hybrid_worker.py``'s ``cut_decode``), with the
reference's params injected:

  * GQA f32 (TinyLlama at 2 layers, one head and one KV head a rank):
    a prompt of 6 tokens, a sliding window of 8 and 8 cache slots, 6
    teacher-forced steps, so the ring wraps and the window drops the
    oldest entries; the prefill's cache narrowed by
    ``place_prefill_cache`` to 2 slots a rank;
  * GQA int8: 8 steps from an empty cache of 8 slots made by
    ``init_cache`` under the rules, step j writing slot j;
  * MLA (DeepSeek-V3 at one layer): its latent and rope key cut, a
    window of 8;
  * Whisper's ``enc_kv``: the cached encoder K/V's 64 positions cut,
    16 a rank, beside the decoder's self-attention cache.

Each step's logits are held against the port's unsharded decode and
the reference's sharded decode on an Auto-axes (data 1, model 4) mesh
(its cache re-put with ``cache_shardings`` between steps) at the zoo's
rtol = atol = 2e-5; the int8 case's codes within one of each, as
``test_int8_kv_decode_matches_the_reference_and_the_f32_cache`` allows,
and its logits within the tolerance up to the first step that wrote a
differing code, within that test's FLIP_ATOL from there. Each step's
collectives by role are ``serve_collectives``' with the cache, the
rank's queries gathered (``seq_q``) and the blocks combined
(``seq_max``, ``seq_sum``). The dry run lowers ``long_500k`` for the
archs whose heads split over 8 ranks, the sLSTM state cut.
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

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models.common import logical_rules as r_logical_rules
from repro.sharding.spec import LogicalRules as RRules
from repro.sharding.spec import cache_shardings as r_cache_sh
from repro.sharding.spec import get_federation_spec as r_fed
from repro.sharding.spec import make_param_shardings as r_param_sh
from repro.sharding.spec import serve_batch_shardings as r_sbatch_sh
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun
from repro_torch.models.model import build_model
from repro_torch.sharding import dist, hlo
from repro_torch.sharding.spec import get_federation_spec

from _torch_tp_hybrid_worker import tp_config

needs8 = pytest.mark.skipif(jax.device_count() < 8,
                            reason="needs >= 8 host devices "
                                   "(XLA_FLAGS=--xla_force_host_platform"
                                   "_device_count=8)")
pytestmark = needs8

ONE_DATA = ((1, 4), ("data", "model"))
B = 2
TOL = dict(rtol=2e-5, atol=2e-5)
FLIP_ATOL = 1e-2
# name -> (arch, layers, d_model, how, prompt, steps, cache_len, window,
# quant)
CASES = {
    "gqa_window": ("tinyllama-1.1b", 2, 64, "prefill", 6, 6, 8, 8, False),
    "gqa_int8": ("tinyllama-1.1b", 2, 64, "init_cache", 0, 8, 8, None,
                 True),
    "mla": ("deepseek-v3-671b", 1, 256, "prefill", 6, 6, 8, 8, False),
    "whisper_enc_kv": ("whisper-tiny", 2, 64, "prefill", 6, 4, 12, None,
                       False),
}
CUT = {"gqa_window": {"k", "v"}, "gqa_int8": {"k", "v", "k_scale",
                                              "v_scale"},
       "mla": {"c_kv", "k_rope"}, "whisper_enc_kv": {"k", "v", "xk", "xv"}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one CPU thread while this module runs (its ops are
    small; eight threads a worker contend with the other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape(name):
    arch, layers, d, *_ = CASES[name]
    return arch, (layers, d, 512)


@functools.lru_cache(maxsize=None)
def _params(name):
    arch, shape = _shape(name)
    jm = jbuild_model(jget_config(arch).reduced(*shape))
    return jax.device_get(jm.init(jax.random.key(5)))


@functools.lru_cache(maxsize=None)
def _inputs(name):
    arch, shape = _shape(name)
    _, _, _, _, S, F, _, _, _ = CASES[name]
    rng = np.random.default_rng(len(name))
    toks = rng.integers(0, 512, (B, S + F)).astype(np.int32)
    extras = {}
    cfg = tp_config(arch, *shape)
    if cfg.encoder_layers:
        extras["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return toks[:, :S], toks[:, S:], extras


def _cases():
    cases = {}
    for name, (arch, layers, d, how, S, F, W, window, quant) in \
            CASES.items():
        prompts, forced, extras = _inputs(name)
        cases[name] = dict(kind="cut_decode", cfg=(arch, layers, d, 512),
                           federation="cross_device", params=_params(name),
                           prompts=prompts, forced=forced, extras=extras,
                           how=how, cache_len=W, window=window, quant=quant)
    return cases


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case on 4 gloo ranks, one spawn: {name: [rank results]}."""
    from _torch_tp_hybrid_worker import run_rank
    tmp = tmp_path_factory.mktemp("seq_decode_ranks")
    cases = _cases()
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"mesh": ONE_DATA, "cases": cases}, f)
    dist.spawn(run_rank, 4, (str(tmp / "in.pkl"), str(tmp)), device="cpu",
               threads=1)
    ranks = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {n: [rk["cases"][n] for rk in ranks] for n in cases}


@functools.lru_cache(maxsize=None)
def _unsharded(name):
    """The port's unsharded steps: (logits a step, the final cache)."""
    arch, shape = _shape(name)
    _, _, _, how, S, F, W, window, quant = CASES[name]
    prompts, forced, extras = _inputs(name)
    model = build_model(tp_config(arch, *shape))
    params = interop.params_from_numpy(_params(name))
    steps = []
    if how == "prefill":
        batch = interop.params_from_numpy({"tokens": prompts, **extras})
        logits, cache = model.prefill(params, batch, cache_len=W,
                                      window=window)
        steps.append(logits[:, 0].numpy())
    else:
        cache = model.init_cache(B, W, device="cpu", quant_kv=quant)
    for t in range(F):
        logits, cache = model.decode_step(
            params, cache, torch.from_numpy(forced[:, t:t + 1]),
            window=window)
        steps.append(logits[:, 0].numpy())
    return steps, interop.params_to_numpy(cache["runs"])


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's sharded steps on an Auto-axes (data 1, model 4)
    mesh: logits a step."""
    arch, shape = _shape(name)
    _, _, _, how, S, F, W, window, quant = CASES[name]
    prompts, forced, extras = _inputs(name)
    params = _params(name)
    mesh = jax.make_mesh(ONE_DATA[0], ONE_DATA[1],
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])
    model = jbuild_model(jget_config(arch).reduced(*shape))
    spec = r_fed("cross_device", mesh)
    psh = r_param_sh(spec, mesh, params)
    steps = []
    with mesh, r_logical_rules(RRules(spec, mesh, serve=True)):
        if how == "prefill":
            batch = {"tokens": jnp.asarray(prompts)}
            batch.update({k: jnp.asarray(v) for k, v in extras.items()})
            bsh = r_sbatch_sh(mesh, batch)
            logits, cache = jax.jit(lambda p, b: model.prefill(
                p, b, cache_len=W, window=window),
                in_shardings=(psh, bsh))(params, batch)
            steps.append(np.asarray(logits[:, 0]))
        else:
            cache = model.init_cache(B, W, quant_kv=quant)
        csh = r_cache_sh(spec, mesh, cache, batch_size=B)
        cache = jax.device_put(cache, csh)
        tsh = r_sbatch_sh(mesh, {"t": jnp.zeros((B, 1), jnp.int32)})["t"]
        dec = jax.jit(lambda p, c, t: model.decode_step(p, c, t,
                                                        window=window),
                      in_shardings=(psh, csh, tsh))
        for t in range(F):
            logits, cache = dec(params, cache,
                                jnp.asarray(forced[:, t:t + 1]))
            cache = jax.device_put(cache, csh)
            steps.append(np.asarray(logits[:, 0]))
    return steps, jax.device_get(cache["runs"])


def _first_flip(res, whole):
    """The first step whose write left an int8 code of the ranks' cut
    cache other than ``whole``'s (the steps' count if none), after
    checking that no code moved by more than one (step j writes slot
    j)."""
    first = len(res[0]["logits"])
    for run, leaves in whole.items():
        for key in ("k", "v"):
            got = np.concatenate([np.asarray(r["cache"]["runs"][run][key])
                                  for r in res], axis=2).astype(int)
            diff = np.abs(got - np.asarray(leaves[key]).astype(int))
            assert diff.max() <= 1, (run, key)
            slots = np.flatnonzero(diff.max(axis=(0, 1, 3, 4)))
            if slots.size:
                first = min(first, int(slots[0]))
    return first


def _held(res, want, first):
    for r in res:
        for t, (got, w) in enumerate(zip(r["logits"], want)):
            if t >= first:
                np.testing.assert_allclose(got, w, rtol=0, atol=FLIP_ATOL)
            else:
                np.testing.assert_allclose(got, w, **TOL,
                                           err_msg=f"step {t}")


@pytest.mark.parametrize("name", list(CASES))
def test_cut_cache_decodes_as_the_unsharded_port(name, port):
    """Every rank holds its block of the time dim and the same logits,
    the unsharded port's within the zoo's tolerance (the int8 cache
    within it up to a step that wrote a flipped code)."""
    want, whole = _unsharded(name)
    first = _first_flip(port[name], whole) if CASES[name][-1] \
        else len(want)
    _held(port[name], want, first)


@pytest.mark.parametrize("name", list(CASES))
def test_cut_cache_decodes_as_the_references_sharded_steps(name, port):
    want, whole = _reference(name)
    first = _first_flip(port[name], whole) if CASES[name][-1] \
        else len(want)
    _held(port[name], want, first)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_time_block(name, port):
    """The cut leaves hold W/4 slots a rank (the encoder K/V 16 of its
    64 positions); the positions stay whole; the ranks' blocks put
    together are the unsharded port's final cache (bitwise for the
    int8 codes' scales where no code moved, within the tolerance for
    the float leaves)."""
    arch, shape = _shape(name)
    cfg = tp_config(arch, *shape)
    W = CASES[name][6]
    res = port[name]
    cut = set()
    for path, sh in res[0]["shapes"].items():
        key = path.rsplit("/", 1)[-1]
        if path.startswith("enc_kv"):
            assert sh[2] == cfg.encoder_seq // 4
            cut.add(key)
        elif path.startswith("runs"):
            if sh[2] == W // 4:
                cut.add(key)
            else:
                assert sh[2] == W, path
    assert cut == CUT[name]
    assert res[0]["shapes"]["positions"] == (W,)
    if CASES[name][-1]:
        return
    _, whole = _unsharded(name)
    for run, leaves in whole.items():
        for key, w in leaves.items():
            got = np.concatenate([r["cache"]["runs"][run][key] for r in res],
                                 axis=2)
            np.testing.assert_allclose(got, w, **TOL, err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_cut_decode_collectives_a_step(name, port):
    """Each step's collectives by role are ``serve_collectives``' with
    the cut cache: every attention gathers its rank's queries
    (``seq_q``), takes the blocks' max (``seq_max``) and sums their
    rescaled parts (``seq_sum``); no collective moves a param or
    crosses the data axis."""
    arch, shape = _shape(name)
    cfg = tp_config(arch, *shape)
    attn = cfg.num_layers * (2 if cfg.encoder_layers else 1)
    spec = get_federation_spec("cross_device", ShapeMesh)
    for res in port[name]:
        for ops, want in zip(res["ops"], res["want_ops"]):
            got = dict(Counter(op[1] for op in ops))
            assert got == {k: v for k, v in want.items() if v}
            assert got["seq_max"] == got["seq_sum"] == attn
            hlo.assert_no_param_gather(
                [hlo.CollectiveOp(k, 0, 4, a, role=r, shape=sh)
                 for k, r, a, sh in ops], spec)


class ShapeMesh:
    shape = {"data": 1, "model": 4}


LONG = [a for a in ARCH_IDS if get_config(a).num_heads % 8 == 0
        or "mlstm" in get_config(a).layer_types]


@pytest.mark.parametrize("arch", LONG)
def test_long_500k_lowers_on_the_production_mesh(arch):
    """One decode step of the one-row ``long_500k`` on a rank of (data
    32, model 8): the attention caches' 8,192-slot window cut to 1,024
    a rank and combined over ``model``, xLSTM's sLSTM state cut to 256
    units a rank (its 4 mLSTM heads do not split 8 ways: whole)."""
    res = dryrun.lower_one(arch, "long_500k", False, verbose=False)
    cfg = get_config(arch)
    roles = res["collectives"]
    if "mlstm" in cfg.layer_types:
        assert roles["xlstm_state"] == cfg.layer_types.count("slstm")
        assert "seq_max" not in roles
    else:
        attn = sum(t in ("attn", "moe", "shared_attn")
                   for t in cfg.layer_types)
        assert roles["seq_max"] == roles["seq_sum"] == attn
    assert res["roofline"]["hbm_bytes"] > 0


def test_long_500k_refuses_heads_that_do_not_split():
    """Whisper's 6 and InternVL2's 14 heads do not split over 8 ranks:
    refused at long_500k as at every shape, naming why."""
    for arch in ("whisper-tiny", "internvl2-1b"):
        with pytest.raises(dryrun.Refused, match="heads do not split"):
            dryrun.check_lowerable(arch, "long_500k", False)
