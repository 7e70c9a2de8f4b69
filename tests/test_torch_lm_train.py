"""The port's federated LM training path against the reference on the
CPU: the synthetic token data (bit for bit), the models' trainable route
(``attention._sdpa``, ``ssm._ssd_chunked``: values and gradients),
``Model.loss`` and its gradient against ``jax.grad`` of the reference's
plain route, and ``vmap(grad)`` of the loss over a client axis, as the
vmap engine takes it, against each client's own gradient. The rounds are in ``test_torch_lm_rounds.py``, the CLI
in ``test_torch_lm_cli.py``. The reference's params are carried across
with ``repro_torch.interop``; models are the configs' reduced widths
(d_model 64, vocab 500 so the padded vocab tail is there).

Tolerances: attention 1e-5, the SSD scan 1e-4 (the CPU's torch.cumsum
accumulates in f64, XLA in f32), losses and gradients 1e-5 relative
with an absolute floor of 1e-5·max|g|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.configs import get_config as jget_config
from repro.data.pipeline import lm_round_batches as r_lm_batches
from repro.data.synthetic import lm_tokens as r_lm_tokens
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import ssm as jssm
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.data.pipeline import lm_round_batches
from repro_torch.data.synthetic import lm_tokens
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.mamba2_scan import mamba2_scan as m2
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.model import build_model
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map

VOCAB, D = 500, 64
MODELS = [("tinyllama-1.1b", 2), ("zamba2-7b", 7)]
C, B, S = 2, 2, 16


@functools.lru_cache(maxsize=None)
def _pair(arch, layers):
    """(reference model, its params as numpy, port model, port params)."""
    jmodel = jbuild_model(jget_config(arch).reduced(
        num_layers=layers, d_model=D, vocab=VOCAB))
    jparams = jax.device_get(jmodel.init(jax.random.key(layers)))
    model = build_model(get_config(arch).reduced(num_layers=layers,
                                                 d_model=D, vocab=VOCAB))
    return jmodel, jparams, model, interop.params_from_numpy(jparams)


def _batch(seed, lead=(B,)):
    toks = np.random.default_rng(seed).integers(
        0, VOCAB, lead + (S + 1,)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _t(tree):
    return tree_map(torch.from_numpy, tree)


def _close_trees(got, want, rtol=1e-5):
    """Each leaf within rtol, with an absolute floor of rtol·max|want|."""
    g, gdef = tree_flatten(interop.params_to_numpy(got))
    w, wdef = tree_flatten(jax.tree.map(np.asarray, want))
    assert gdef == wdef
    for path, a, b in zip(gdef, g, w):
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=rtol * float(np.abs(b).max()) + 1e-30,
            err_msg=str(path))


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("shape", [(4, 2, 8, 16, 500), (3, 1, 2, 7, 32000),
                                   (1, 4, 1, 256, 7)])
def test_lm_round_batches_are_the_references_bit_for_bit(shape):
    clients, k, b, seq, vocab = shape
    for seed in ((0, 0), (3, 11)):
        kw = dict(clients=clients, local_steps=k, batch=b, seq=seq,
                  vocab=vocab)
        got = lm_round_batches(np.random.default_rng(seed), **kw)
        want = r_lm_batches(np.random.default_rng(seed), **kw)
        assert got.keys() == want.keys() == {"tokens", "labels"}
        for key in got:
            assert got[key].dtype == want[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_array_equal(got["tokens"][..., 1:],
                                      got["labels"][..., :-1])


def test_lm_tokens_are_the_references_bit_for_bit():
    kw = dict(vocab=32, n_train=24, n_test=6, seq=10, seed=5)
    got, want = lm_tokens("lm", **kw), r_lm_tokens("lm", **kw)
    for f in ("x", "y", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert (got.name, got.num_classes) == (want.name, want.num_classes)


# ------------------------------------------------------- the plain routes
@pytest.mark.parametrize("S_,G,window", [(24, 2, None), (24, 1, 7),
                                         (2048, 2, None)])
def test_sdpa_matches_the_reference_values_and_gradients(S_, G, window):
    r = np.random.default_rng(S_ + G)
    KV, hd = 2, 8
    q = r.normal(size=(1, S_, KV, G, hd)).astype(np.float32)
    k = r.normal(size=(1, S_, KV, hd)).astype(np.float32)
    v = r.normal(size=(1, S_, KV, hd)).astype(np.float32)
    w = r.normal(size=(1, S_, KV, G, hd)).astype(np.float32)

    def jf(q, k, v):
        out = jattn._sdpa(q, k, v, causal=True, window=window)
        return jnp.sum(out * w), out

    (jl, jout), jg = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                        has_aux=True)(q, k, v)

    def tf(q, k, v):
        out = attn._sdpa(q, k, v, window=window)
        return torch.sum(out * torch.from_numpy(w)), out

    tg, (tl, tout) = torch.func.grad_and_value(
        tf, argnums=(0, 1, 2), has_aux=True)(*map(torch.from_numpy,
                                                  (q, k, v)))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def _ssd_inputs(S_, dt_shift):
    r = np.random.default_rng(S_)
    Bt, H, P, G, N = 2, 4, 8, 2, 16
    x = r.normal(size=(Bt, S_, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(r.normal(size=(Bt, S_, H)) + dt_shift)
                  ).astype(np.float32)
    A_log = np.log(r.uniform(1.0, 16.0, H)).astype(np.float32)
    Bm = r.normal(size=(Bt, S_, G, N)).astype(np.float32)
    Cm = r.normal(size=(Bt, S_, G, N)).astype(np.float32)
    wy = r.normal(size=(Bt, S_, H, P)).astype(np.float32)
    wh = r.normal(size=(Bt, H, P, N)).astype(np.float32)
    return (x, dt, A_log, Bm, Cm), wy, wh


def _ssd_grads(S_, dt_shift):
    """(reference (y, h, grads), port (y, h, grads)) of a weighted sum
    of the scan's outputs."""
    args, wy, wh = _ssd_inputs(S_, dt_shift)

    def jf(*a):
        y, h = jssm._ssd_chunked(*a)
        return jnp.sum(y * wy) + jnp.sum(h * wh), (y, h)

    (_, (jy, jh)), jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3, 4),
                                           has_aux=True)(*args)

    def tf(*a):
        y, h = ssm._ssd_chunked(*a)
        return (torch.sum(y * torch.from_numpy(wy))
                + torch.sum(h * torch.from_numpy(wh)), (y, h))

    tg, (_, (ty, th)) = torch.func.grad_and_value(
        tf, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *map(torch.from_numpy, args))
    return ((np.asarray(jy), np.asarray(jh), [np.asarray(g) for g in jg]),
            (ty.numpy(), th.numpy(), [g.numpy() for g in tg]))


# one chunk of 40, two of 48, two of 64 (one of 64: the overflow test)
@pytest.mark.parametrize("S_", [40, 96, 128])
def test_ssd_chunked_matches_the_reference_values_and_gradients(S_):
    # dt ≈ 0.05: a chunk's decay stays inside f32's exp range
    (jy, jh, jg), (ty, th, tg) = _ssd_grads(S_, -3.0)
    for a, b in [(ty, jy), (th, jh)] + list(zip(tg, jg)):
        assert np.isfinite(b).all()
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(b).max()))


def test_ssd_chunked_gradient_stays_finite_where_the_reference_overflows():
    """With dt ≈ 0.7 a chunk's cs_q − cs_k above the diagonal passes
    f32's exp range: the reference masks after the exp and its gradient
    is 0·inf = NaN there; the port masks before it. The outputs are the
    same, and the port's gradient is finite."""
    (jy, jh, jg), (ty, th, tg) = _ssd_grads(64, 0.0)
    np.testing.assert_allclose(ty, jy, rtol=1e-4,
                               atol=1e-4 * float(np.abs(jy).max()))
    assert not all(np.isfinite(g).all() for g in jg)
    assert all(np.isfinite(g).all() for g in tg)


def test_routes_agree_and_the_kernel_route_refuses_grad():
    """use_pallas picks the route, and nothing else does: the plain
    route launches no kernel wrapper, the kernel route (the port's
    default, serving's) launches one a site, and under torch.func the
    kernel route is refused as the reference's Pallas kernels are."""
    for arch, layers in MODELS:
        _, _, model, p = _pair(arch, layers)
        bt = _t(_batch(3))
        fa.reset_launch_count(), m2.reset_launch_count()
        plain, _ = model.loss(p, bt, use_pallas=False)
        assert fa.launch_count() == m2.launch_count() == 0
        kernel, _ = model.loss(p, bt)
        assert fa.launch_count() + m2.launch_count() > 0
        torch.testing.assert_close(plain, kernel, rtol=1e-5, atol=1e-5)
        with pytest.raises((ValueError, RuntimeError)):
            torch.func.grad(lambda q: model.loss(q, bt)[0])(p)


# --------------------------------------------------------- loss and grads
@pytest.mark.parametrize("arch,layers", MODELS)
def test_model_loss_and_gradient_match_jax_grad(arch, layers):
    jmodel, jp, model, p = _pair(arch, layers)
    bt = _batch(layers)
    (jl, jaux), jg = jax.value_and_grad(
        lambda q: jmodel.loss(q, bt), has_aux=True)(jp)
    tg, (tl, taux) = grad_and_value(
        lambda q: model.loss(q, _t(bt), use_pallas=False),
        has_aux=True)(p)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               rtol=1e-5)
    _close_trees(tg, jg)


@pytest.mark.parametrize("arch,layers", MODELS)
def test_vmap_grad_matches_each_clients_grad(arch, layers):
    """The vmap engine's trace of the loss (the embedding gather, the
    padded-vocab mask, the cross entropy, the SSD scan's cumsum and
    segment sums) over C clients with their own params gives each
    client's own loss and gradient."""
    _, _, model, p = _pair(arch, layers)
    r = np.random.default_rng(11)
    pc = tree_map(lambda x: torch.stack(
        [x + 1e-3 * torch.from_numpy(r.normal(size=x.shape).astype(
            np.float32)) for _ in range(C)]), p)
    bt = _t(_batch(7, lead=(C, B)))

    def f(q, b):
        return model.loss(q, b, use_pallas=False)[0]

    g, loss = vmap(grad_and_value(f))(pc, bt)
    for c in range(C):
        qc = tree_map(lambda x: x[c], pc)
        gc, lc = grad_and_value(f)(qc, tree_map(lambda x: x[c], bt))
        torch.testing.assert_close(loss[c], lc, rtol=1e-5, atol=0)
        for a, b in zip(tree_leaves(g), tree_leaves(gc)):
            torch.testing.assert_close(
                a[c], b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
