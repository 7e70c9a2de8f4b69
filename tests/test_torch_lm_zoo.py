"""The LM zoo's MoE, MLA and dense archs through the port's layer stack
and Model facade against the reference on the CPU: OLMoE (MoE),
DeepSeek-V3 (MLA, MoE with a shared expert, multi-token prediction),
CodeQwen1.5 and Qwen2.5 (QKV bias) and Granite (MQA, the GELU MLP) at
their configs' reduced widths, 2 layers, d_model 64 and a vocab of 500.
The reference's params are carried across (``repro_torch.interop``);
the param trees, ``stack_full`` (its aux summed over the MoE layers),
``apply`` and ``loss`` (with the MTP loss when labels are given),
``prefill`` and ``decode_step`` in both cache forms, ``init_cache`` and
interop both ways agree within 2e-5 (interop bitwise). MoE runs at the
reference's capacity factor, 1.25, on both sides: the same tokens drop.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtfm
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.models import transformer as tfm
from repro_torch.models.model import build_model
from repro_torch.utils.tree import tree_flatten, tree_map

TOL = dict(rtol=2e-5, atol=2e-5)
VOCAB, D = 500, 64
ARCHS = ["olmoe-1b-7b", "deepseek-v3-671b", "codeqwen1.5-7b", "qwen2.5-14b",
         "granite-20b"]


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference model, its params as numpy, port model, port params)."""
    jmodel = jbuild_model(jget_config(arch).reduced(d_model=D, vocab=VOCAB))
    jparams = jax.device_get(jax.jit(jmodel.init)(jax.random.key(3)))
    # the reference inits biases to zero: make them count
    r = np.random.default_rng(3)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: (r.normal(size=a.shape).astype(a.dtype) * 0.1
                         if path[-1].key in ("bq", "bk", "bv", "b_in",
                                             "b_out") else a), jparams)
    model = build_model(get_config(arch).reduced(d_model=D, vocab=VOCAB))
    return jmodel, jparams, model, interop.params_from_numpy(jparams)


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (B, S)).astype(
        np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _close_trees(got, want):
    g, gdef = tree_flatten(interop.params_to_numpy(got))
    w, wdef = tree_flatten(jax.tree.map(np.asarray, want))
    assert gdef == wdef
    for path, a, b in zip(gdef, g, w):
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, err_msg=str(path), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_is_the_references(arch):
    _, jp, model, _ = _pair(arch)
    mine = model.init(torch.Generator().manual_seed(0))
    g, gdef = tree_flatten(tree_map(lambda a: tuple(a.shape), mine))
    w, wdef = tree_flatten(jax.tree.map(lambda a: tuple(a.shape), jp))
    assert gdef == wdef and g == w
    blk = mine["stack"]["run0"]
    assert ("moe" in blk) == (arch in ARCHS[:2])
    assert ("mtp" in mine) == (arch == "deepseek-v3-671b")
    assert ("wkv_a" in blk["attn"]) == (arch == "deepseek-v3-671b")


@pytest.mark.parametrize("arch", ARCHS)
def test_stack_full_and_its_aux_match_the_reference(arch):
    jmodel, jp, model, p = _pair(arch)
    x = np.random.default_rng(5).normal(size=(2, 20, D)).astype(np.float32)
    pos = np.arange(20)[None]
    y, caches, aux = tfm.stack_full(p["stack"], torch.from_numpy(x),
                                    model.cfg,
                                    positions=torch.from_numpy(pos),
                                    build_cache=True)
    jy, jcaches, jaux = jtfm.stack_full(jp["stack"], x, jmodel.cfg,
                                        positions=pos, build_cache=True,
                                        use_pallas=True)
    _close(y, jy)
    _close_trees(caches, jcaches)
    _close(aux, jaux)
    assert aux.dtype == torch.float32
    assert (float(aux) > 0) == (arch in ARCHS[:2])


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_and_loss_match_the_reference(arch):
    """Logits against both reference paths; with labels, DeepSeek's aux
    carries the MTP loss (0.3·CE of token t+2 through the extra block,
    plus that block's MoE aux) and ``loss`` is CE + aux."""
    jmodel, jp, model, p = _pair(arch)
    toks = _tokens(2, 25, seed=1)
    labels = np.roll(toks, -1, axis=1)
    logits, aux = model.apply(p, {"tokens": torch.from_numpy(toks)})
    for up in (False, True):
        jl, jaux = jmodel.apply(jp, {"tokens": jnp.asarray(toks)},
                                use_pallas=up)
        _close(logits, jl)
        _close(aux, jaux)
    bt = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    jloss, jm = jmodel.loss(jp, {"tokens": jnp.asarray(toks),
                                 "labels": jnp.asarray(labels)})
    for up in (False, True):
        loss, m = model.loss(p, bt, use_pallas=up)
        _close(loss, jloss)
        _close(m["ce"], jm["ce"])
        _close(m["aux"], jm["aux"])
        assert (float(m["aux"]) > float(aux)) == (arch == "deepseek-v3-671b")


@pytest.mark.parametrize("arch,window,cache_len", [
    (arch, None, None) for arch in ARCHS] + [
    (arch, w, c) for arch in ARCHS[:2] for w, c in ((None, 30), (16, None))])
def test_prefill_and_decode_match_the_reference(arch, window, cache_len):
    """Prefill (the cache rolled to a ring buffer where a window crops
    it) and three lockstep decode steps: logits and every cache leaf (the
    MLA latent for DeepSeek). Flash attention runs once per GQA site of
    the prefill (its plain version here), never for MLA."""
    jmodel, jp, model, p = _pair(arch)
    toks = _tokens(2, 27, seed=7)
    S = 24
    fa.reset_launch_count()
    logits, cache = model.prefill(p, {"tokens": torch.from_numpy(toks[:, :S])},
                                  cache_len=cache_len, window=window)
    assert fa.launch_count() == (0 if model.cfg.use_mla else 2)
    jl, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])},
                            cache_len=cache_len, window=window,
                            use_pallas=True)
    _close(logits, jl)
    _close_trees(cache, jc)
    for j in range(S, 27):
        logits, cache = model.decode_step(
            p, cache, torch.from_numpy(toks[:, j:j + 1]), window=window)
        jl, jc = jmodel.decode_step(jp, jc, jnp.asarray(toks[:, j:j + 1]),
                                    window=window)
        _close(logits, jl)
        _close_trees(cache, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_per_slot_decode_and_init_cache_match_the_reference(arch):
    """The serving pool's cache form, each row at its own position, from
    the reference's ``init_cache`` filled with random history."""
    jmodel, jp, model, p = _pair(arch)
    B, W = 3, 24
    _close_trees(model.init_cache(B, W, device="cpu"),
                 jmodel.init_cache(B, W))
    jpool = jmodel.init_cache(B, W)
    jpool["t"] = jnp.asarray([0, 5, 17], jnp.int32)
    pos = np.full((B, W), -1, np.int32)
    for b, t in enumerate((0, 5, 17)):
        pos[b, :t] = np.arange(t)
    jpool["positions"] = jnp.asarray(pos)
    r = np.random.default_rng(8)
    jpool["runs"] = jax.tree.map(
        lambda a: jnp.asarray(r.normal(size=a.shape).astype(np.float32)),
        jpool["runs"])
    pool = interop.params_from_numpy(jax.tree.map(np.asarray, jpool))
    toks = _tokens(B, 1, seed=9)
    for _ in range(2):
        logits, pool = model.decode_step(p, pool, torch.from_numpy(toks))
        jl, jpool = jmodel.decode_step(jp, jpool, jnp.asarray(toks))
        _close(logits, jl)
        _close_trees(pool, jpool)
        toks = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_carries_the_new_trees_both_ways_bitwise(arch):
    """``moe`` (the shared expert's ``shared``), the MLA leaves and
    ``mtp`` cross unchanged, leaf by leaf, in f32 and in bf16."""
    _, jp, model, _ = _pair(arch)
    for want in (jp, jax.tree.map(lambda a: np.asarray(
            jnp.asarray(a, jnp.bfloat16)), jp)):
        there = interop.params_from_numpy(want)
        back, bdef = tree_flatten(interop.params_to_numpy(there))
        wl, wdef = tree_flatten(want)
        assert bdef == wdef
        for a, b in zip(back, wl):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    mine = model.init(torch.Generator().manual_seed(1))
    back = interop.params_from_numpy(interop.params_to_numpy(mine))
    ml, mdef = tree_flatten(mine)
    bl, bdef = tree_flatten(back)
    assert mdef == bdef and all(torch.equal(a, b) for a, b in zip(ml, bl))
