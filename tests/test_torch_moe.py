"""The port's MoE layer and MLA attention against the reference on the
CPU: ``apply_moe`` (output and aux) at the reference's capacity factor
1.25, where choices are dropped, and at 8.0, where none are; against the
reference's test's dense per-token loop (f64, rtol 2e-3), with the
shared expert, and under ``torch.func.vmap`` over a client axis; the
capacity rule; MLA's full form with its latent cache and its absorbed
decode step (lockstep and per slot); the new archs' configs field for
field and their init distributions; and the in-place scaling of
``dense_init`` (the same bits as the out-of-place product). The
reference's params are carried across with ``repro_torch.interop``;
f32 results agree within 2e-5.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import repro.models.moe as jmoe
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import moe
from repro_torch.models.model import build_model
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map

TOL = dict(rtol=2e-5, atol=2e-5)
NEW_ARCHS = ["olmoe-1b-7b", "deepseek-v3-671b", "codeqwen1.5-7b",
             "qwen2.5-14b", "granite-20b"]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _close_trees(got, want):
    g, gdef = tree_flatten(interop.params_to_numpy(got))
    w, wdef = tree_flatten(jax.tree.map(np.asarray, want))
    assert gdef == wdef
    for path, a, b in zip(gdef, g, w):
        np.testing.assert_allclose(a, b, err_msg=str(path), **TOL)


def _moe_pair(arch, seed):
    """(port cfg, reference cfg, reference params numpy, port params)."""
    jcfg = jget_config(arch).reduced()
    jp = jax.device_get(jmoe.init_moe(jax.random.key(seed), jcfg,
                                      jnp.float32))
    return (get_config(arch).reduced(), jcfg, jp,
            interop.params_from_numpy(jp))


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_archs_build_at_full_width_and_reduced(arch):
    """Each new arch id builds, with the shapes its source gives."""
    cfg = get_config(arch)
    assert build_model(cfg).cfg is cfg
    assert build_model(cfg.reduced()).cfg.num_layers == 2
    want = {"olmoe-1b-7b": (16, 2048, 16, 16, 128, 64, 8, 1024),
            "deepseek-v3-671b": (61, 7168, 128, 128, 128, 256, 8, 2048),
            "codeqwen1.5-7b": (32, 4096, 32, 32, 128, 0, 0, 13440),
            "qwen2.5-14b": (48, 5120, 40, 8, 128, 0, 0, 13824),
            "granite-20b": (52, 6144, 48, 1, 128, 0, 0, 24576)}[arch]
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.num_experts, cfg.num_experts_per_tok,
            cfg.expert_d_ff) == want


def test_reduced_moe_and_mla_are_the_references_cut():
    o = get_config("olmoe-1b-7b").reduced()
    assert (o.num_experts, o.num_experts_per_tok, o.expert_d_ff,
            o.num_shared_experts) == (4, 2, 256, 0)
    d = get_config("deepseek-v3-671b").reduced()
    assert (d.num_experts, d.num_experts_per_tok, d.num_shared_experts,
            d.q_lora_rank, d.kv_lora_rank, d.qk_rope_head_dim,
            d.qk_nope_head_dim, d.v_head_dim, d.mtp_depth) == (
                4, 2, 1, 64, 32, 16, 16, 64, 1)


# ---------------------------------------------------------------- capacity
def test_capacity_is_the_references_rule(monkeypatch):
    for T in (1, 3, 4, 17, 64, 256, 380, 1000, 4096):
        for E in (4, 8, 64, 256):
            for k in (1, 2, 8):
                assert moe._capacity(T, E, k) == jmoe._capacity(T, E, k)
    monkeypatch.setattr(moe, "CAPACITY_FACTOR", 8.0)
    monkeypatch.setattr(jmoe, "CAPACITY_FACTOR", 8.0)
    # at 8.0 and K/E = 1/8 (OLMoE) every token fits: C >= T
    assert moe._capacity(380, 64, 8) == jmoe._capacity(380, 64, 8) == 380


# --------------------------------------------------------------- the layer
@pytest.mark.parametrize("factor", [1.25, 8.0])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_apply_moe_matches_the_reference(arch, factor, monkeypatch):
    monkeypatch.setattr(moe, "CAPACITY_FACTOR", factor)
    monkeypatch.setattr(jmoe, "CAPACITY_FACTOR", factor)
    cfg, jcfg, jp, p = _moe_pair(arch, 0)
    x = _x((2, 48, cfg.d_model), 1)
    out, aux = moe.apply_moe(p, torch.from_numpy(x), cfg)
    jout, jaux = jmoe.apply_moe(jp, x, jcfg)
    _close(out, jout)
    _close(aux, jaux)
    assert aux.dtype == torch.float32
    if factor == 1.25 and arch == "olmoe-1b-7b":
        # T·K·1.25/E = 60 slots an expert for 96 tokens: drops happen
        assert moe._capacity(96, 4, 2) < 96


def _dense_reference(p, x, cfg):
    """The reference's test's per-token loop, in f64."""
    B, S, D = x.shape
    xt = x.reshape(-1, D).astype(np.float64)
    lg = xt @ p["router"].astype(np.float64)
    pr = np.exp(lg - lg.max(1, keepdims=True))
    pr /= pr.sum(1, keepdims=True)
    K = cfg.num_experts_per_tok
    out = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        idx = np.argsort(-pr[t])[:K]
        w = pr[t, idx] / pr[t, idx].sum()
        for j, e in enumerate(idx):
            g = xt[t] @ p["w_gate"][e].astype(np.float64)
            u = xt[t] @ p["w_in"][e].astype(np.float64)
            out[t] += w[j] * (((g / (1 + np.exp(-g))) * u)
                              @ p["w_out"][e].astype(np.float64))
    if "shared" in p:
        sp = p["shared"]
        g = xt @ sp["w_gate"].astype(np.float64)
        u = xt @ sp["w_in"].astype(np.float64)
        out += ((g / (1 + np.exp(-g))) * u) @ sp["w_out"].astype(np.float64)
    return out.reshape(B, S, D)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_apply_moe_matches_the_dense_per_token_loop(arch, monkeypatch):
    """No drops at capacity 8.0: the layer is the dense loop (the
    shared expert too, for DeepSeek)."""
    monkeypatch.setattr(moe, "CAPACITY_FACTOR", 8.0)
    cfg, _, jp, p = _moe_pair(arch, 4)
    assert ("shared" in p) == (arch == "deepseek-v3-671b")
    x = _x((2, 8, cfg.d_model), 2, 0.5)
    out, _ = moe.apply_moe(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), _dense_reference(jp, x, cfg),
                               rtol=2e-3, atol=2e-3)


def test_apply_moe_drops_to_the_shared_path_and_uniform_aux_is_coef(
        monkeypatch):
    cfg, _, _, p = _moe_pair("deepseek-v3-671b", 3)
    x = torch.from_numpy(_x((2, 256, cfg.d_model), 3))
    monkeypatch.setattr(moe, "_capacity", lambda T, E, K: 4)
    out, _ = moe.apply_moe(p, x, cfg)
    sp = p["shared"]
    xt = x.reshape(-1, cfg.d_model)
    shared = (torch.nn.functional.silu(xt @ sp["w_gate"])
              * (xt @ sp["w_in"])) @ sp["w_out"]
    # 16 slots for 512 tokens: all but 16 tokens' outputs are the shared
    # expert's alone
    routed = (out.reshape(-1, cfg.d_model) - shared).abs().amax(-1) > 1e-6
    assert 0 < int(routed.sum()) <= 4 * cfg.num_experts
    monkeypatch.undo()
    q = dict(p, router=torch.zeros_like(p["router"]))
    _, aux = moe.apply_moe(q, torch.ones((1, 64, cfg.d_model)), cfg)
    assert float(aux) == pytest.approx(cfg.router_aux_coef, rel=1e-6)


def test_apply_moe_under_vmap_is_each_clients_own():
    """Each client routes its own tokens: vmap(grad) over a client axis
    equals each client's own gradient, the router's included."""
    cfg, _, _, p = _moe_pair("deepseek-v3-671b", 6)
    r = np.random.default_rng(6)
    pc = tree_map(lambda a: torch.stack([a + 0.05 * torch.from_numpy(
        r.normal(size=a.shape).astype(np.float32)) for _ in range(3)]), p)
    x = torch.from_numpy(_x((3, 2, 24, cfg.d_model), 7))

    def loss(q, xx):
        out, aux = moe.apply_moe(q, xx, cfg)
        return torch.sum(out ** 2) + aux

    g = vmap(grad(loss))(pc, x)
    for c in range(3):
        gc = grad(loss)(tree_map(lambda a: a[c], pc), x[c])
        for a, b in zip(tree_leaves(g), tree_leaves(gc)):
            torch.testing.assert_close(a[c], b, rtol=1e-5,
                                       atol=1e-5 * float(b.abs().max()))
    assert float(g["router"].abs().sum()) > 0


# --------------------------------------------------------------------- MLA
def _mla_pair(seed):
    jcfg = jget_config("deepseek-v3-671b").reduced()
    jp = jax.device_get(jattn.init_mla(jax.random.key(seed), jcfg,
                                       jnp.float32))
    return (get_config("deepseek-v3-671b").reduced(), jcfg, jp,
            interop.params_from_numpy(jp))


@pytest.mark.parametrize("window", [None, 9])
def test_mla_full_and_its_cache_match_the_reference(window):
    cfg, jcfg, jp, p = _mla_pair(0)
    x = _x((2, 20, cfg.d_model), 1)
    pos = np.arange(20)[None]
    for up in (True, False):   # the route keyword changes nothing
        y, c = attn.mla_full(p, torch.from_numpy(x), cfg,
                             positions=torch.from_numpy(pos), window=window,
                             build_cache=True, use_pallas=up)
        jy, jc = jattn.mla_full(jp, x, jcfg, positions=pos, window=window,
                                build_cache=True)
        _close(y, jy)
        _close_trees(c, jc)
    assert c["c_kv"].shape == (2, 20, 32) and c["k_rope"].shape == (2, 20,
                                                                     16)


def _mla_cache(B, W, ts, seed):
    r = np.random.default_rng(seed)
    cache = {"c_kv": r.normal(size=(B, W, 32)).astype(np.float32),
             "k_rope": r.normal(size=(B, W, 16)).astype(np.float32)}
    pos = np.full((B, W), -1, np.int32)
    for b, t in enumerate(ts):
        pos[b, :t] = np.arange(t)
    return cache, pos


@pytest.mark.parametrize("window", [None, 4])
def test_mla_step_matches_the_reference_in_both_cache_forms(window):
    """The absorbed decode against the latent cache: per slot (each row
    at its own position) and lockstep (the reference's scalar t, which
    the port runs as every row at the same position)."""
    cfg, jcfg, jp, p = _mla_pair(2)
    B, W = 3, 12
    x = _x((B, 1, cfg.d_model), 3)
    for ts in ((0, 5, 11), (7, 7, 7)):
        cache, pos = _mla_cache(B, W, ts, 4)
        t = np.asarray(ts, np.int32)
        slot = t % W
        pos[np.arange(B), slot] = t
        y, c = attn.mla_step(p, torch.from_numpy(x), cfg,
                             tree_map(torch.from_numpy, cache),
                             t=torch.from_numpy(t),
                             slot=torch.from_numpy(slot),
                             positions_buf=torch.from_numpy(pos),
                             window=window)
        jcache = jax.tree.map(jnp.asarray, cache)
        if len(set(ts)) == 1:   # the reference's lockstep form
            jy, jc = jattn.mla_step(jp, x, jcfg, jcache, t=int(t[0]),
                                    slot=int(slot[0]), positions_buf=pos[0],
                                    window=window)
        else:
            jy, jc = jattn.mla_step(jp, x, jcfg, jcache, t=jnp.asarray(t),
                                    slot=jnp.asarray(slot),
                                    positions_buf=pos, window=window)
        _close(y, jy)
        _close_trees(c, jc)


def test_mla_step_continues_mla_full():
    """A decode step after a prefill of S tokens gives the full form's
    output at position S."""
    cfg, _, _, p = _mla_pair(5)
    S = 10
    x = torch.from_numpy(_x((2, S + 1, cfg.d_model), 6))
    full, _ = attn.mla_full(p, x, cfg, positions=torch.arange(S + 1)[None])
    _, c = attn.mla_full(p, x[:, :S], cfg, positions=torch.arange(S)[None],
                         build_cache=True)
    cache = {k: torch.cat([v, torch.zeros_like(v[:, :1])], 1)
             for k, v in c.items()}
    t = torch.full((2,), S, dtype=torch.int32)
    pos = torch.arange(S + 1, dtype=torch.int32)[None].expand(2, S + 1)
    y, _ = attn.mla_step(p, x[:, S:], cfg, cache, t=t, slot=t,
                         positions_buf=pos)
    torch.testing.assert_close(y[:, 0], full[:, S], rtol=1e-4, atol=1e-5)


def test_init_mla_cache_is_the_references():
    cfg = get_config("deepseek-v3-671b").reduced()
    c = attn.init_mla_cache(cfg, 2, 10, torch.float32, "cpu")
    _close_trees(c, jattn.init_mla_cache(jget_config(
        "deepseek-v3-671b").reduced(), 2, 10, jnp.float32))


# -------------------------------------------------------------------- init
def test_init_draws_the_references_distributions_for_the_new_leaves():
    cfg = dataclasses.replace(get_config("deepseek-v3-671b").reduced(),
                              d_model=512, moe_d_ff=512)
    p = build_model(cfg).init(torch.Generator().manual_seed(0))
    blk = p["stack"]["run0"]
    for w, fan in ((blk["moe"]["w_gate"][:, 0], 512),
                   (blk["moe"]["w_out"][:, 0], 512),
                   (blk["moe"]["shared"]["w_in"], 512),
                   (blk["attn"]["wq_a"], 512), (blk["attn"]["wq_b"], 64),
                   (p["mtp"]["proj"], 1024)):
        std = float(w.std()) * math.sqrt(fan)
        assert abs(std - 0.88) < 0.03, (w.shape, std)   # trunc. ±2σ
        assert float(w.abs().max()) <= 2 / math.sqrt(fan) + 1e-6
    assert float(blk["attn"]["q_norm"].min()) == 1.0
    assert float(blk["attn"]["kv_norm"].max()) == 1.0
    assert p["mtp"]["block"].keys() == blk.keys()


def _out_of_place_init(monkeypatch, arch, layers):
    """The model's init with dense_init/embed_init scaling out of place
    (the earlier form), from the same generator."""
    def dense(gen, shape, dtype=torch.float32, fan_in=None):
        fan = fan_in if fan_in is not None else shape[0]
        return (common._trunc_normal(gen, shape)
                * (1.0 / math.sqrt(max(1, fan)))).to(dtype)

    def embed(gen, shape, dtype=torch.float32):
        return (common._trunc_normal(gen, shape) * 0.02).to(dtype)

    calls = []
    import repro_torch.models.attention as a_mod
    import repro_torch.models.model as m_mod
    import repro_torch.models.ssm as s_mod
    import repro_torch.models.transformer as t_mod
    model = build_model(get_config(arch).reduced(num_layers=layers))
    with monkeypatch.context() as m:
        for mod in (a_mod, m_mod, s_mod, t_mod, moe):
            if hasattr(mod, "dense_init"):
                m.setattr(mod, "dense_init",
                          lambda *a, **k: calls.append(1) or dense(*a, **k))
        m.setattr(m_mod, "embed_init", embed)
        params = model.init(torch.Generator().manual_seed(3))
    return params, len(calls)


@pytest.mark.parametrize("arch,layers", [("tinyllama-1.1b", 2),
                                         ("zamba2-7b", 7)])
def test_in_place_init_keeps_every_bit(arch, layers, monkeypatch):
    model = build_model(get_config(arch).reduced(num_layers=layers))
    got = model.init(torch.Generator().manual_seed(3))
    want, calls = _out_of_place_init(monkeypatch, arch, layers)
    assert calls > 0
    gl, gd = tree_flatten(got)
    wl, wd = tree_flatten(want)
    assert gd == wd
    assert all(torch.equal(a, b) for a, b in zip(gl, wl))
