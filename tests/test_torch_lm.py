"""The port's LM zoo slice (configs, common blocks, GQA attention, the
Mamba2 mixer, the layer stack and the Model facade) against the
reference on the CPU, with the reference's parameters carried across
(``repro_torch.interop``) and the same numpy inputs. The reference runs
both its plain path (``use_pallas=False``) and its Pallas kernels in
interpret mode (``use_pallas=True``); f32 results agree within 2e-5.
Sizes are the configs' ``reduced()`` widths: TinyLlama at 2 layers,
Zamba2 at 7 and 14 (two periods: 12 Mamba2 layers and the shared block
at two sites), with a vocab of 500 so that the padded tail of the vocab
table is there."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro_torch import interop
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.model import build_model
from repro_torch.utils.tree import tree_flatten, tree_map

TOL = dict(rtol=2e-5, atol=2e-5)
VOCAB = 500
MODELS = [("tinyllama-1.1b", 2), ("zamba2-7b", 7), ("zamba2-7b", 14)]


@functools.lru_cache(maxsize=None)
def _pair(arch, layers):
    """(reference model, its params as numpy, port model, port params)."""
    jcfg = jget_config(arch).reduced(num_layers=layers, vocab=VOCAB)
    jmodel = jbuild_model(jcfg)
    jparams = jax.device_get(jmodel.init(jax.random.key(layers)))
    model = build_model(get_config(arch).reduced(num_layers=layers,
                                                 vocab=VOCAB))
    return jmodel, jparams, model, interop.params_from_numpy(jparams)


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, (B, S)).astype(
        np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _close_trees(got, want):
    g, gdef = tree_flatten(interop.params_to_numpy(got))
    w, wdef = tree_flatten(jax.tree.map(np.asarray, want))
    assert gdef == wdef
    for path, a, b in zip(gdef, g, w):
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, b, err_msg=str(path), **TOL)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-7b",
                                  "olmoe-1b-7b", "deepseek-v3-671b",
                                  "codeqwen1.5-7b", "qwen2.5-14b",
                                  "granite-20b"])
def test_configs_are_the_references(arch):
    for layers in (None, 2, 7):
        cfg, jcfg = get_config(arch), jget_config(arch)
        if layers:
            cfg, jcfg = cfg.reduced(num_layers=layers), jcfg.reduced(
                num_layers=layers)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.layer_types == jcfg.layer_types
        assert cfg.padded_vocab == jcfg.padded_vocab
        assert cfg.head_dim == jcfg.head_dim


def test_full_width_shapes_of_the_two_served_archs():
    t = get_config("tinyllama-1.1b")
    assert (t.num_layers, t.d_model, t.num_heads, t.num_kv_heads, t.head_dim,
            t.d_ff, t.vocab_size) == (22, 2048, 32, 4, 64, 5632, 32000)
    z = dataclasses.replace(get_config("zamba2-7b"), num_layers=14)
    assert (z.d_model, z.d_ff, z.num_heads, z.head_dim) == (3584, 14336, 32,
                                                            112)
    assert ssm.mamba2_dims(z) == (7168, 112, 64, 1, 64)
    assert tfm.segment_runs(z.layer_types) == [
        ("mamba2", 6), ("shared_attn", 1), ("mamba2", 6), ("shared_attn", 1)]


def test_unported_arch_ids_raise_naming_the_roadmap_item():
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        if arch not in ("whisper-tiny", "xlstm-1.3b", "internvl2-1b"):
            continue
        with pytest.raises(NotImplementedError, match="A15"):
            get_config(arch)
    with pytest.raises(KeyError):
        get_config("gpt-2")


@pytest.mark.parametrize("arch,what,change", [
    ("whisper-tiny", "cross-attention", {"encoder_layers": 0}),
    ("xlstm-1.3b", "xLSTM", {"block_pattern": ("slstm",)}),
    ("whisper-tiny", "encoder", {}), ("internvl2-1b", "image tokens", {}),
    ("xlstm-1.3b", "xLSTM", {}),
    ("tinyllama-1.1b", "sinusoidal", {"rope_theta": 0.0})])
def test_build_model_refuses_unported_families(arch, what, change):
    from repro_torch.configs.base import ModelConfig
    cfg = ModelConfig(**{**dataclasses.asdict(jget_config(arch).reduced()),
                         **change})
    with pytest.raises(NotImplementedError, match="A15") as err:
        build_model(cfg)
    assert what in str(err.value)


# ------------------------------------------------------------ common blocks
def test_rope_is_the_half_split_form():
    r = np.random.default_rng(0)
    x = r.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(9)[None].repeat(2, 0)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    _close(got, jcommon.apply_rope(x, pos, 1e4))
    # x1, x2 are the two halves of the head dim, not interleaved pairs
    f = common.rope_freqs(16, 1e4)
    ang = pos[..., None, None] * f
    x1, x2 = x[..., :8], x[..., 8:]
    half = np.concatenate([x1 * np.cos(ang) - x2 * np.sin(ang),
                           x1 * np.sin(ang) + x2 * np.cos(ang)], -1)
    _close(got, half, rtol=1e-5, atol=1e-5)
    ev, od = x[..., 0::2], x[..., 1::2]
    inter = np.stack([ev * np.cos(ang) - od * np.sin(ang),
                      ev * np.sin(ang) + od * np.cos(ang)], -1).reshape(
        x.shape)
    assert np.abs(got.numpy() - inter).max() > 0.1


def test_norms_and_swiglu_match_the_reference():
    r = np.random.default_rng(1)
    x = r.normal(size=(2, 5, 32)).astype(np.float32)
    s = r.normal(size=(32,)).astype(np.float32)
    b = r.normal(size=(32,)).astype(np.float32)
    t = torch.from_numpy
    _close(common.rmsnorm(t(x), t(s)), jcommon.rmsnorm(x, s))
    _close(common.layernorm(t(x), t(s), t(b)), jcommon.layernorm(x, s, b))
    _close(common.swiglu(t(x), t(s)), jcommon.swiglu(x, s))
    assert common.tree_size({"a": t(x), "b": {"c": t(s)}}) == 2 * 5 * 32 + 32


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("window", [None, 9])
def test_gqa_full_matches_both_reference_paths(window):
    jmodel, jp, model, p = _pair("tinyllama-1.1b", 2)
    cfg = model.cfg
    jl = jax.tree.map(lambda a: a[0], jp["stack"]["run0"]["attn"])
    pl = tree_map(lambda a: a[0], p["stack"]["run0"]["attn"])
    x = np.random.default_rng(2).normal(size=(2, 33, cfg.d_model)).astype(
        np.float32)
    pos = np.arange(33)[None]
    y, c = attn.gqa_full(pl, torch.from_numpy(x), cfg,
                         positions=torch.from_numpy(pos), window=window,
                         build_cache=True)
    for up in (False, True):
        jy, jc = jattn.gqa_full(jl, x, jmodel.cfg, positions=pos,
                                window=window, build_cache=True,
                                use_pallas=up)
        _close(y, jy)
        _close_trees(c, jc)


def test_gqa_step_matches_the_reference_per_row():
    jmodel, jp, model, p = _pair("tinyllama-1.1b", 2)
    cfg = model.cfg
    jl = jax.tree.map(lambda a: a[1], jp["stack"]["run0"]["attn"])
    pl = tree_map(lambda a: a[1], p["stack"]["run0"]["attn"])
    r = np.random.default_rng(3)
    B, W = 3, 12
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    cache = {"k": r.normal(size=(B, W, KV, hd)).astype(np.float32),
             "v": r.normal(size=(B, W, KV, hd)).astype(np.float32)}
    x = r.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    t = np.array([3, 11, 20], np.int32)                  # row 2 wraps
    slot = t % W
    pos = np.full((B, W), -1, np.int32)
    for b in range(B):
        for s in range(t[b] + 1):
            pos[b, s % W] = s
    jcache = jax.tree.map(jnp.asarray, cache)
    for window in (None, 5):
        y, c = attn.gqa_step(pl, torch.from_numpy(x), cfg,
                             interop.params_from_numpy(cache),
                             t=torch.from_numpy(t), slot=torch.from_numpy(
                                 slot), positions_buf=torch.from_numpy(pos),
                             window=window)
        jy, jc = jattn.gqa_step(jl, x, jmodel.cfg, jcache, t=t, slot=slot,
                                positions_buf=pos, window=window)
        _close(y, jy)
        _close_trees(c, jc)


# ------------------------------------------------------------------ mamba2
def test_mamba2_full_and_step_match_the_reference():
    jmodel, jp, model, p = _pair("zamba2-7b", 7)
    cfg = model.cfg
    jl = jax.tree.map(lambda a: a[2], jp["stack"]["run0"]["mixer"])
    pl = tree_map(lambda a: a[2], p["stack"]["run0"]["mixer"])
    r = np.random.default_rng(4)
    for S in (2, 96):            # S < K − 1 pads the conv tail; L = 48
        x = r.normal(size=(2, S, cfg.d_model)).astype(np.float32)
        y, c = ssm.mamba2_full(pl, torch.from_numpy(x), cfg,
                               build_cache=True)
        for up in (False, True):
            jy, jc = jssm.mamba2_full(jl, x, jmodel.cfg, build_cache=True,
                                      use_pallas=up)
            _close(y, jy)
            _close_trees(c, jc)
        x1 = r.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        y1, c1 = ssm.mamba2_step(pl, torch.from_numpy(x1), cfg, c)
        jy1, jc1 = jssm.mamba2_step(jl, x1, jmodel.cfg, jc)
        _close(y1, jy1)
        _close_trees(c1, jc1)


def test_init_draws_the_references_distributions():
    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(), d_model=512)
    p = ssm.init_mamba2(torch.Generator().manual_seed(0), cfg, torch.float32)
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    a = torch.exp(p["A_log"])
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    w = p["w_zx"]
    assert abs(float(w.std()) * np.sqrt(512) - 0.88) < 0.02   # trunc. ±2σ
    assert float(w.abs().max()) <= 2 / np.sqrt(512) + 1e-6
    model = build_model(get_config("tinyllama-1.1b").reduced())
    params = model.init(torch.Generator().manual_seed(0))
    emb = params["embed"]
    assert abs(float(emb.std()) - 0.02 * 0.88) < 0.002
    assert float(params["stack"]["run0"]["ln1"]["scale"].min()) == 1.0


# ------------------------------------------------------------------- stack
@pytest.mark.parametrize("arch,layers", MODELS)
def test_param_tree_is_the_references(arch, layers):
    jmodel, jp, model, _ = _pair(arch, layers)
    mine = model.init(torch.Generator().manual_seed(0))
    g, gdef = tree_flatten(tree_map(lambda a: tuple(a.shape), mine))
    w, wdef = tree_flatten(jax.tree.map(lambda a: tuple(a.shape), jp))
    assert gdef == wdef
    assert g == w
    if arch == "zamba2-7b":
        assert "shared_attn" in mine["stack"]
        assert mine["stack"]["run0"]["mixer"]["w_zx"].shape[0] == 6


@pytest.mark.parametrize("arch,layers", MODELS)
def test_stack_full_matches_the_reference(arch, layers):
    jmodel, jp, model, p = _pair(arch, layers)
    x = np.random.default_rng(5).normal(
        size=(2, 20, model.cfg.d_model)).astype(np.float32)
    pos = np.arange(20)[None]
    y, caches, aux = tfm.stack_full(p["stack"], torch.from_numpy(x),
                                    model.cfg,
                                    positions=torch.from_numpy(pos),
                                    build_cache=True)
    assert float(aux) == 0.0
    jy, jcaches, _ = jtfm.stack_full(jp["stack"], x, jmodel.cfg,
                                     positions=pos, build_cache=True,
                                     use_pallas=True)
    _close(y, jy)
    _close_trees(caches, jcaches)


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("arch,layers", MODELS)
def test_apply_and_loss_match_both_reference_paths(arch, layers):
    jmodel, jp, model, p = _pair(arch, layers)
    toks = _tokens(2, 33, seed=layers)
    logits, aux = model.apply(p, {"tokens": torch.from_numpy(toks)})
    for up in (False, True):
        jl, _ = jmodel.apply(jp, {"tokens": jnp.asarray(toks)},
                             use_pallas=up)
        _close(logits, jl)
    labels = np.roll(toks, -1, axis=1)
    loss, m = model.loss(p, {"tokens": torch.from_numpy(toks),
                             "labels": torch.from_numpy(labels)})
    jloss, _ = jmodel.loss(jp, {"tokens": jnp.asarray(toks),
                                "labels": jnp.asarray(labels)})
    _close(loss, jloss)


def test_config_variants_of_the_zoo_match_the_reference():
    """LayerNorm, the GELU MLP and QKV biases (other archs of the zoo use
    them) through the whole model, against both reference paths."""
    variant = dict(norm_variant="layernorm", mlp_variant="gelu",
                   qkv_bias=True)
    jcfg = dataclasses.replace(jget_config("tinyllama-1.1b").reduced(
        vocab=VOCAB), **variant)
    jmodel = jbuild_model(jcfg)
    jp = jax.device_get(jmodel.init(jax.random.key(11)))
    # the reference inits biases to zero: make them count
    r = np.random.default_rng(11)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: (r.normal(size=a.shape).astype(a.dtype) * 0.1
                         if path[-1].key in ("bq", "bk", "bv", "b_in",
                                             "b_out", "bias") else a), jp)
    model = build_model(dataclasses.replace(
        get_config("tinyllama-1.1b").reduced(vocab=VOCAB), **variant))
    p = interop.params_from_numpy(jp)
    assert p["stack"]["run0"]["ln1"].keys() == {"scale", "bias"}
    toks = _tokens(2, 17, seed=11)
    logits, _ = model.apply(p, {"tokens": torch.from_numpy(toks)})
    for up in (False, True):
        jl, _ = jmodel.apply(jp, {"tokens": jnp.asarray(toks)},
                             use_pallas=up)
        _close(logits, jl)


def test_padded_vocab_logits_are_masked():
    _, _, model, p = _pair("tinyllama-1.1b", 2)
    assert model.cfg.padded_vocab == 512 and model.cfg.vocab_size == VOCAB
    logits, _ = model.apply(p, {"tokens": torch.from_numpy(_tokens(2, 9))})
    assert torch.all(logits[..., VOCAB:] == -1e30)
    assert torch.all(logits[..., :VOCAB] > -1e29)
    assert int(logits.argmax(-1).max()) < VOCAB


@pytest.mark.parametrize("window,cache_len", [(None, None), (None, 40),
                                              (16, None)])
@pytest.mark.parametrize("arch,layers", MODELS[:2])
def test_prefill_and_decode_match_the_reference(arch, layers, window,
                                                cache_len):
    """Prefill (the cache rolled to a ring buffer when a window crops it)
    and three decode steps in the lockstep form; logits and every cache
    leaf against the reference."""
    jmodel, jp, model, p = _pair(arch, layers)
    toks = _tokens(2, 36, seed=7)
    S = 33
    logits, cache = model.prefill(p, {"tokens": torch.from_numpy(toks[:, :S])},
                                  cache_len=cache_len, window=window)
    jl, jc = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])},
                            cache_len=cache_len, window=window,
                            use_pallas=True)
    _close(logits, jl)
    _close_trees(cache, jc)
    for j in range(S, 36):
        logits, cache = model.decode_step(
            p, cache, torch.from_numpy(toks[:, j:j + 1]), window=window)
        jl, jc = jmodel.decode_step(jp, jc, jnp.asarray(toks[:, j:j + 1]),
                                    window=window)
        _close(logits, jl)
        _close_trees(cache, jc)


def test_per_slot_decode_matches_the_reference():
    """The serving pool's cache form: each row at its own position."""
    jmodel, jp, model, p = _pair("zamba2-7b", 7)
    B, W = 3, 24
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


def test_init_cache_is_the_references():
    jmodel, _, model, _ = _pair("zamba2-7b", 7)
    c = model.init_cache(2, 10, device="cpu")
    _close_trees(c, jmodel.init_cache(2, 10))


@pytest.mark.parametrize("arch,layers", MODELS)
def test_interop_carries_the_lm_tree_both_ways_bitwise(arch, layers):
    """Stacked runs and the shared block cross unchanged, leaf by leaf."""
    _, jp, _, p = _pair(arch, layers)
    back, bdef = tree_flatten(interop.params_to_numpy(p))
    want, wdef = tree_flatten(jp)
    assert bdef == wdef
    for a, b in zip(back, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
