"""The LM zoo's last three archs below the Model facade, on the CPU
against the reference: xLSTM's mixers (the chunked mLSTM at every chunk
length, the sLSTM's time loop, full against stepwise, gradients under
``vmap``), Whisper's sinusoidal positions (both routes), its
bidirectional encoder attention and cross-attention, the synthetic
round batches with stub frames and image embeddings, the serving
engine's tokens against each request decoded alone, its per-slot cross
K/V, and decode caches crossing ``interop`` bitwise. Mixer and
attention inputs are numpy draws; the reference's params are carried
across (``repro_torch.interop``). Tolerances: values 2e-5 (the stepwise
mixers against the chunked or hoisted full form 1e-4, as the reference
holds its own), gradients 1e-4 relative to max|g|.

The model-level parity of these archs (apply, loss, prefill, decode,
init_cache, gradients, rounds, CLIs) is in ``test_torch_lm_zoo.py``,
``test_torch_lm_zoo_train.py``, ``test_torch_lm_rounds.py`` and
``test_torch_serve.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.configs import get_config as jget_config
from repro.data.pipeline import lm_round_batches as r_lm_batches
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.data.pipeline import lm_round_batches
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.model import batch_extras, build_model
from repro_torch.serving import DecodeEngine
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one CPU thread while this module runs: eight threads a
    worker contend with the other test workers and with XLA's pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-5, atol=2e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
VOCAB, D = 500, 64


def _xcfg(get=get_config):
    return get("xlstm-1.3b").reduced(num_layers=4, d_model=D, vocab=VOCAB)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _close_trees(got, want, **tol):
    g, gdef = tree_flatten(interop.params_to_numpy(got))
    w, wdef = tree_flatten(jax.tree.map(np.asarray, want))
    assert gdef == wdef
    for path, a, b in zip(gdef, g, w):
        np.testing.assert_allclose(a, b, err_msg=str(path), **(tol or TOL))


def _t(x):
    return torch.from_numpy(np.asarray(x))


@functools.lru_cache(maxsize=None)
def _mixer_params(kind):
    """The reference's init of an mLSTM or sLSTM mixer (numpy) and the
    port's copy."""
    init = {"mlstm": jssm.init_mlstm, "slstm": jssm.init_slstm}[kind]
    jp = jax.device_get(init(jax.random.key(4), _xcfg(jget_config),
                             jnp.float32))
    return jp, interop.params_from_numpy(jp)


def _x(B, S, seed, scale=0.5):
    return (np.random.default_rng(seed).normal(size=(B, S, D)) * scale
            ).astype(np.float32)


# ------------------------------------------------------ sinusoidal positions
def test_sinusoidal_routes_match_their_reference_counterparts():
    """The table (numpy f64 rounded to f32) is the reference's bit for
    bit; the per-position route (f32 on the device) is its jnp
    counterpart's, run as the reference's decode runs it (jit, vmap over
    rows), at every position a served request of the configs reaches.
    The tolerance grows with the position: each package's f32 pow of
    the frequencies is a few ulps from exact (XLA's jitted one up to 6),
    and sin and cos of t·ω carry t times that relative error, so row t
    is held within 2e-5 + 1e-6·t (about 8 ulps of ω). Each package's two
    routes differ in their last bits, so each is held against its own
    counterpart."""
    d = 384
    table = common.sinusoidal_positions(300, d)
    np.testing.assert_array_equal(table, jcommon.sinusoidal_positions(300,
                                                                      d))
    t = np.arange(300, dtype=np.int32)
    got = common.sinusoidal_position_at(torch.from_numpy(t), d)
    want = np.asarray(jax.jit(jax.vmap(
        lambda ti: jcommon.sinusoidal_position_at(ti, d)))(t))
    assert got.dtype == torch.float32 and got.shape == (300, d)
    err = np.abs(got.numpy() - want)
    assert (err <= 2e-5 + 1e-6 * t[:, None]).all(), float(err.max())
    assert not np.array_equal(want, table)
    assert not np.array_equal(got.numpy(), table)


# -------------------------------------------------------------------- mLSTM
@pytest.mark.parametrize("S,chunk,L", [(37, 8, 1), (33, 256, 33),
                                       (32, 16, 16)])
def test_mlstm_chunked_matches_the_reference_and_the_recurrence(S, chunk,
                                                                 L):
    """``_mlstm_chunked`` at one token a chunk (37 is prime: L = 1), one
    chunk of 33, and two chunks of 16 (the state carried across): its
    outputs and final (C, n, m) against the reference's, and against S
    steps of the recurrence ``mlstm_step`` runs."""
    assert ssm._chunk_len(S, chunk) == L
    r = np.random.default_rng(S)
    B, H, hk, hv = 2, 4, 16, 32
    q, k = (r.normal(size=(B, S, H, hk)).astype(np.float32)
            for _ in range(2))
    v = r.normal(size=(B, S, H, hv)).astype(np.float32)
    i_pre = r.normal(size=(B, S, H)).astype(np.float32)
    f_pre = (r.normal(size=(B, S, H)) + 3.0).astype(np.float32)
    y, (C, n, m) = ssm._mlstm_chunked(*map(_t, (q, k, v, i_pre, f_pre)),
                                      chunk=chunk)
    jy, (jC, jn, jm) = jax.jit(functools.partial(
        jssm._mlstm_chunked, chunk=chunk))(q, k, v, i_pre, f_pre)
    for a, b in ((y, jy), (C, jC), (n, jn), (m, jm)):
        _close(a, b)
    # the recurrence, step by step, as mlstm_step runs it
    Cs = torch.zeros((B, H, hk, hv))
    ns, ms = torch.zeros((B, H, hk)), torch.zeros((B, H))
    ys = []
    for t in range(S):
        kt = _t(k[:, t]) / np.sqrt(hk)
        logi = _t(i_pre[:, t])
        logf = torch.nn.functional.logsigmoid(_t(f_pre[:, t]))
        m_new = torch.maximum(logf + ms, logi)
        fp, ip = torch.exp(logf + ms - m_new), torch.exp(logi - m_new)
        Cs = fp[..., None, None] * Cs + ip[..., None, None] * (
            kt[..., :, None] * _t(v[:, t])[..., None, :])
        ns = fp[..., None] * ns + ip[..., None] * kt
        ms = m_new
        qt = _t(q[:, t])
        den = torch.maximum(torch.einsum("bhk,bhk->bh", ns, qt).abs(),
                            torch.exp(-ms))
        ys.append(torch.einsum("bhkd,bhk->bhd", Cs, qt) / den[..., None])
    _close(y, torch.stack(ys, 1), **STEP_TOL)
    _close(C, Cs, **STEP_TOL)
    _close(m, ms)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_full_and_step_match_the_reference(kind):
    """``<kind>_full`` (with its final state) and ``<kind>_step`` from a
    random state, against the reference's, on the reference's params."""
    jp, p = _mixer_params(kind)
    cfg, jcfg = _xcfg(), _xcfg(jget_config)
    full, jfull = getattr(ssm, f"{kind}_full"), getattr(jssm, f"{kind}_full")
    step, jstep = getattr(ssm, f"{kind}_step"), getattr(jssm, f"{kind}_step")
    x = _x(2, 21, seed=1)
    y, cache = full(p, _t(x), cfg, build_cache=True)
    jy, jcache = jax.jit(lambda q, x_: jfull(q, x_, jcfg,
                                             build_cache=True))(jp, x)
    _close(y, jy)
    _close_trees(cache, jcache)
    init = getattr(ssm, f"init_{kind}_cache")(cfg, 2, torch.float32, "cpu")
    _close_trees(init, getattr(jssm, f"init_{kind}_cache")(jcfg, 2,
                                                           jnp.float32))
    assert all(a.dtype == torch.float32 for a in tree_leaves(init))
    r = np.random.default_rng(2)
    state = jax.tree.map(lambda a: np.abs(r.normal(size=a.shape)).astype(
        np.float32), jcache)
    x1 = _x(2, 1, seed=3)
    y1, c1 = step(p, _t(x1), cfg, interop.params_from_numpy(state))
    jy1, jc1 = jax.jit(lambda q, x_, c: jstep(q, x_, jcfg, c))(jp, x1,
                                                               state)
    _close(y1, jy1)
    _close_trees(c1, jc1)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_full_equals_its_steps(kind):
    """S decode steps from the empty state give the full form's outputs
    and final state (the reference holds its own the same way)."""
    _, p = _mixer_params(kind)
    cfg = _xcfg()
    x = _t(_x(2, 19, seed=5))
    y, cache = getattr(ssm, f"{kind}_full")(p, x, cfg, build_cache=True)
    c = getattr(ssm, f"init_{kind}_cache")(cfg, 2, torch.float32, "cpu")
    ys = []
    for t in range(x.shape[1]):
        yt, c = getattr(ssm, f"{kind}_step")(p, x[:, t:t + 1], cfg, c)
        ys.append(yt)
    _close(y, torch.cat(ys, 1), **STEP_TOL)
    for a, b in zip(tree_leaves(cache), tree_leaves(c)):
        _close(a, b, **STEP_TOL)


def test_mixer_gradients_under_vmap_are_finite_and_the_references():
    """``vmap(grad)`` of each mixer over two clients, as the vmap engine
    traces it: each client's gradient equals the reference's
    ``jax.grad`` of the same client, and stays finite with an input-gate
    bias of +40 (the mLSTM's stabiliser at work). There the stabiliser
    cancels the input gate's gradient to rounding noise, so the absolute
    floor is 1e-4 of the largest gradient of any leaf."""
    cfg, jcfg = _xcfg(), _xcfg(jget_config)
    xs = _x(2, 12, seed=6, scale=2.0)
    w = np.random.default_rng(7).normal(size=(12, D)).astype(np.float32)
    for kind, bump in (("mlstm", 0.0), ("mlstm", 40.0), ("slstm", 0.0)):
        jp, p = _mixer_params(kind)
        bias = "b_if" if kind == "mlstm" else "b"
        jp = {**jp, bias: jp[bias] + bump}
        p = {**p, bias: p[bias] + bump}
        full, jfull = (getattr(ssm, f"{kind}_full"),
                       getattr(jssm, f"{kind}_full"))
        pc = tree_map(lambda a: torch.stack([a, a * 1.01]), p)

        def f(q, x):
            return torch.sum(full(q, x[None], cfg)[0][0] * _t(w))

        g = vmap(grad(f))(pc, _t(xs))
        jgrad = jax.jit(jax.grad(lambda q, x: jnp.sum(
            jfull(q, x[None], jcfg)[0][0] * w)))
        for c in range(2):
            jq = jax.tree.map(lambda a: a * (1.0 if c == 0 else 1.01), jp)
            jl, jdef = tree_flatten(jax.tree.map(np.asarray,
                                                 jgrad(jq, xs[c])))
            top = max(float(np.abs(b).max()) for b in jl)
            for path, a, b in zip(jdef,
                                  tree_leaves(tree_map(lambda t: t[c], g)),
                                  jl):
                assert torch.isfinite(a).all(), (kind, bump, path)
                floor = top if bump else float(np.abs(b).max())
                np.testing.assert_allclose(
                    a.numpy(), b, rtol=1e-4, atol=1e-4 * floor + 1e-30,
                    err_msg=f"{kind} bump {bump} {path}")


# ------------------------------------------------ encoder, cross-attention
@functools.lru_cache(maxsize=None)
def _whisper():
    jcfg = jget_config("whisper-tiny").reduced(d_model=D, vocab=VOCAB)
    cfg = get_config("whisper-tiny").reduced(d_model=D, vocab=VOCAB)
    jp = jax.device_get(jattn.init_attention(jax.random.key(9), jcfg,
                                             jnp.float32))
    return cfg, jcfg, jp, interop.params_from_numpy(jp)


def test_bidir_and_cross_attention_match_the_reference():
    """The encoder's non-causal attention (``_bidir_attn``), ``cross_kv``
    over T = 29 encoder positions and ``cross_attend`` from S = 11
    decoder positions (T ≠ S), values and gradients; and the plain
    ``_sdpa``'s non-causal form against the reference's."""
    cfg, jcfg, jp, p = _whisper()
    x, enc = _x(2, 11, seed=10), _x(2, 29, seed=11)
    pos = np.arange(29)[None]
    y, none = tfm._bidir_attn(p, _t(enc), cfg, _t(pos))
    jy, _ = jax.jit(lambda q, e: jtfm._bidir_attn(q, e, jcfg, pos))(jp,
                                                                    enc)
    assert none is None
    _close(y, jy)
    kv = attn.cross_kv(p, _t(enc), cfg)
    jkv = jax.jit(lambda q, e: jattn.cross_kv(q, e, jcfg))(jp, enc)
    _close_trees(kv, jkv)
    assert kv["xk"].shape == (2, 29, cfg.num_kv_heads, cfg.head_dim)
    _close(attn.cross_attend(p, _t(x), cfg, kv),
           jax.jit(lambda q, x_, kv_: jattn.cross_attend(q, x_, jcfg, kv_))(
               jp, x, jkv))

    def f(q, x_, e):
        return torch.sum(attn.cross_attend(q, x_, cfg,
                                           attn.cross_kv(q, e, cfg)) ** 2)

    def jf(q, x_, e):
        return jnp.sum(jattn.cross_attend(q, x_, jcfg,
                                          jattn.cross_kv(q, e, jcfg)) ** 2)

    g = grad(f, argnums=(0, 1, 2))(p, _t(x), _t(enc))
    jg = jax.jit(jax.grad(jf, argnums=(0, 1, 2)))(jp, x, enc)
    _close_trees(g[0], jg[0], rtol=1e-4, atol=1e-4)
    for a, b in zip(g[1:], jg[1:]):
        _close(a, b, rtol=1e-4, atol=1e-4)
    r = np.random.default_rng(12)
    q = r.normal(size=(1, 5, 2, 3, 8)).astype(np.float32)
    k, v = (r.normal(size=(1, 13, 2, 8)).astype(np.float32)
            for _ in range(2))
    _close(attn._sdpa(_t(q), _t(k), _t(v), causal=False),
           jattn._sdpa(q, k, v, causal=False))


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-1b"])
def test_lm_round_batches_with_extras_are_the_references_bit_for_bit(arch):
    """Tokens, labels and the (C, K, b, ...) frames or image embeddings,
    drawn after the tokens, as the reference's ``train_lm`` asks for
    them (``models.model.batch_extras``, which the train CLI reads)."""
    cfg = get_config(arch).reduced()
    extras = batch_extras(cfg)
    assert list(extras) == (["frames"] if cfg.encoder_layers
                            else ["image_embeds"])
    kw = dict(clients=3, local_steps=2, batch=2, seq=9, vocab=VOCAB,
              extras=extras)
    got = lm_round_batches(np.random.default_rng((5, 1)), **kw)
    want = r_lm_batches(np.random.default_rng((5, 1)), **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    name, shape = next(iter(extras.items()))
    assert got[name].shape == (3, 2, 2) + shape


# ------------------------------------------------------------------ serving
ENGINE_ARCHS = {"xlstm-1.3b": 4, "whisper-tiny": 2, "internvl2-1b": 2}


@functools.lru_cache(maxsize=None)
def _served(arch):
    cfg = get_config(arch).reduced(num_layers=ENGINE_ARCHS[arch],
                                   d_model=D, vocab=VOCAB)
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(2))


def _isolated(model, params, prompt, extras, gen, cache_len):
    """A request prefilled and greedily decoded alone, lockstep (B = 1)."""
    batch = {k: torch.from_numpy(np.asarray(v)[None])
             for k, v in {"tokens": prompt, **(extras or {})}.items()}
    logits, cache = model.prefill(params, batch, cache_len=cache_len)
    toks = [torch.argmax(logits[:, -1:], -1)]
    for _ in range(gen - 1):
        logits, cache = model.decode_step(params, cache, toks[-1])
        toks.append(torch.argmax(logits, -1))
    return torch.cat(toks, 1)[0].numpy()


@pytest.mark.parametrize("arch", list(ENGINE_ARCHS))
def test_engine_tokens_equal_isolated_decodes(arch):
    """Three requests through two slots (one admitted into a freed
    slot), flush 3: each request's tokens equal its own isolated decode
    bit for bit, its frames or image embeddings with it; one
    flash-attention call per causal attention layer a request (xLSTM
    none; Whisper's encoder and cross-attention none); the per-slot
    cross K/V keeps its bits through decode blocks."""
    model, params = _served(arch)
    cfg = model.cfg
    gen, n_img = 7, cfg.num_image_tokens
    cache_len = 10 + gen + n_img
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, VOCAB, (3, 10)).astype(np.int32)
    extras = [serve._row_extras(cfg, rng) for _ in prompts]
    assert (extras[0] is None) == (arch == "xlstm-1.3b")
    eng = DecodeEngine(model, params, slots=2, cache_len=cache_len,
                       flush_tokens=3)
    fa.reset_launch_count()
    rids = [eng.submit(p, gen, extras=ex) for p, ex in zip(prompts, extras)]
    eng.step()
    enc = (tree_map(torch.clone, eng.pool["enc_kv"])
           if cfg.encoder_layers else None)
    eng.step()
    if enc is not None:
        # written at admission only; the same requests hold the slots
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(enc), tree_leaves(eng.pool["enc_kv"])))
        assert eng.pool["enc_kv"]["xk"].shape == (
            cfg.num_layers, 2, cfg.encoder_seq, cfg.num_kv_heads,
            cfg.head_dim)
    done = {c.request_id: c.tokens for c in eng.completed}
    done.update({c.request_id: c.tokens for c in eng.run_until_idle()})
    sites = sum(t in tfm.ATTN_TYPES for t in cfg.layer_types)
    assert fa.launch_count() == 3 * sites
    for rid, p, ex in zip(rids, prompts, extras):
        np.testing.assert_array_equal(
            done[rid], _isolated(model, params, p, ex, gen, cache_len),
            err_msg=f"request {rid}")
    with pytest.raises(ValueError, match="cache_len"):
        eng.submit(prompts[0], gen + 1)


def test_decode_caches_with_enc_kv_cross_interop_bitwise():
    """The reference's Whisper prefill cache (runs, t, positions and the
    per-layer cross K/V) crosses to the port and back unchanged, and the
    port decodes from it as the reference does."""
    jcfg = jget_config("whisper-tiny").reduced(d_model=D, vocab=VOCAB)
    jmodel = jbuild_model(jcfg)
    jp = jax.device_get(jax.jit(jmodel.init)(jax.random.key(1)))
    r = np.random.default_rng(13)
    batch = {"tokens": r.integers(0, VOCAB, (2, 6)).astype(np.int32),
             "frames": r.normal(size=(2, jcfg.encoder_seq, D)
                                ).astype(np.float32)}
    _, jc = jax.jit(lambda q, b: jmodel.prefill(q, b, cache_len=9))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    want = jax.tree.map(np.asarray, jc)
    there = interop.params_from_numpy(want)
    back, bdef = tree_flatten(interop.params_to_numpy(there))
    wl, wdef = tree_flatten(want)
    assert bdef == wdef and ("enc_kv", "xk") in bdef
    for a, b in zip(back, wl):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    model = build_model(get_config("whisper-tiny").reduced(d_model=D,
                                                           vocab=VOCAB))
    tok = r.integers(0, VOCAB, (2, 1)).astype(np.int32)
    logits, c = model.decode_step(interop.params_from_numpy(jp), there,
                                  torch.from_numpy(tok))
    jl, jc2 = jax.jit(jmodel.decode_step)(jp, jc, jnp.asarray(tok))
    _close(logits, jl)
    _close_trees(c, jc2)


# ----------------------------------------------- xLSTM's f32 conditioning
def test_xlstm_local_steps_are_f32_conditioned_in_both_packages():
    """Why ``test_torch_lm_rounds.py`` holds xLSTM's rounds looser: two
    Δ-SGD local steps (η0 = 0.2, θ0 = 1, the second η from the gradient
    difference on its own batch) of round 0's second client, in the
    port in f64, in the port in f32 and in the reference (f32). Both f32
    results lie within 2e-3·max|p| of f64 and their η within 3e-4, and
    the gap to f64 passes 5e-4·max|p| in each: the rounding of the first
    step, not either package, sets it."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    import test_torch_lm_rounds as rounds
    jmodel, jp = rounds._reference("xlstm-1.3b", 4)
    bs = rounds._round_batches(1, jmodel)
    b = [{k: v[0, 1, s] for k, v in bs.items()} for s in range(2)]

    def steps(g, p0, norm, sub, scale):
        x1 = sub(p0, scale(g(p0, b[0]), 0.2))
        g1, g1p = g(x1, b[1]), g(p0, b[1])
        eta = min(2 ** 0.5 * 0.2,
                  norm(sub(x1, p0)) / (2 * norm(sub(g1, g1p))))
        return sub(x1, scale(g1, eta)), eta

    def port(dtype):
        model = build_model(_xcfg(), dtype)
        p0 = tree_map(lambda a: a.to(dtype), interop.params_from_numpy(jp))
        g = grad(lambda q, bb: model.loss(q, tree_map(torch.from_numpy, bb),
                                          use_pallas=False)[0])
        x2, eta = steps(
            g, p0, lambda t: float(sum((a.double() ** 2).sum()
                                       for a in tree_leaves(t))) ** 0.5,
            lambda a, c: tree_map(lambda u, w_: u - w_, a, c),
            lambda a, s: tree_map(lambda u: u * s, a))
        return tree_map(lambda a: a.double().numpy(), x2), eta

    jg = jax.jit(jax.grad(lambda q, bb: jmodel.loss(q, bb)[0]))
    jx2, jeta = steps(
        jg, jp, lambda t: float(sum(np.sum(np.asarray(a, np.float64) ** 2)
                                    for a in jax.tree.leaves(t))) ** 0.5,
        lambda a, c: jax.tree.map(lambda u, w_: u - w_, a, c),
        lambda a, s: jax.tree.map(lambda u: u * s, a))
    (x64, e64), (x32, e32) = port(torch.float64), port(torch.float32)
    gaps = []
    for got, eta in ((x32, e32), (jax.tree.map(np.asarray, jx2), jeta)):
        assert abs(eta / e64 - 1) < 3e-4
        worst = 0.0
        for a, t in zip(tree_flatten(got)[0], tree_flatten(x64)[0]):
            worst = max(worst, float(np.abs(a - t).max()
                                     / np.abs(t).max()))
        assert worst < 2e-3
        gaps.append(worst)
    assert min(gaps) > 5e-4
