"""Port parity for the paper-task models: MLP and shallow-CNN logits, and
per-client ``(loss, grads)`` from ``torch.func.vmap(grad_and_value)``
against ``jax.vmap(jax.value_and_grad)``, at ≤ 1e-5, with the params
carried across by ``repro_torch.interop``. The CNN case covers the two
layout traps: XLA's asymmetric SAME padding at stride 2, and the NHWC
flatten before ``fc1``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.configs.paper_tasks import CNN_PAPER, MLP_SMALL, MLP_WIDE
from repro.core.losses import make_loss as rmake_loss
from repro.models import small as rsmall
from repro_torch import interop
from repro_torch.configs import paper_tasks as tcfg
from repro_torch.core.losses import make_loss as tmake_loss
from repro_torch.models import small as tsmall
from repro_torch.utils.tree import tree_leaves

CFGS = {"mlp": MLP_SMALL, "mlp-wide": MLP_WIDE, "cnn": CNN_PAPER}
TCFGS = {"mlp": tcfg.MLP_SMALL, "mlp-wide": tcfg.MLP_WIDE,
         "cnn": tcfg.CNN_PAPER}


def _x(name, rng, *lead):
    cfg = CFGS[name]
    if name == "cnn":
        shape = lead + (cfg.image_size, cfg.image_size, cfg.channels)
    else:
        shape = lead + (cfg.input_dim,)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_logits_match_reference(name, rng):
    rinit, rlogits = rsmall.make_small_model(CFGS[name])
    _, tlogits = tsmall.make_small_model(TCFGS[name])
    params = jax.device_get(rinit(jax.random.key(1)))
    x = _x(name, rng, 8)
    want = np.asarray(rlogits(params, jnp.asarray(x)))
    got = tlogits(interop.params_from_numpy(params), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cnn_same_padding_is_asymmetric(rng):
    """nn.Conv2d-style symmetric padding=1 would disagree with the
    reference: the port must pad 0 before, 1 after."""
    rinit, rlogits = rsmall.make_small_model(CNN_PAPER)
    params = jax.device_get(rinit(jax.random.key(2)))
    x = _x("cnn", rng, 2)
    y_ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), params["conv1"]["w"], (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    tp = interop.params_from_numpy(params)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    w = tp["conv1"]["w"].permute(3, 2, 0, 1)
    port = torch.nn.functional.conv2d(
        torch.nn.functional.pad(xt, (0, 1, 0, 1)), w, stride=2)
    np.testing.assert_allclose(port.permute(0, 2, 3, 1).numpy(), y_ref,
                               rtol=1e-5, atol=1e-5)
    sym = torch.nn.functional.conv2d(xt, w, stride=2, padding=1)
    assert not np.allclose(sym.permute(0, 2, 3, 1).numpy(), y_ref,
                           atol=1e-3)


@pytest.mark.parametrize("fedprox_mu", [0.0, 0.1])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_per_client_loss_and_grads_match_reference(name, fedprox_mu, rng):
    C, B = 3, 6
    rinit, rlogits = rsmall.make_small_model(CFGS[name])
    _, tlogits = tsmall.make_small_model(TCFGS[name])
    gp = jax.device_get(rinit(jax.random.key(3)))
    # distinct per-client params: the global params plus numpy noise
    pc = jax.tree.map(lambda a: np.stack(
        [a + 0.01 * rng.normal(size=a.shape).astype(np.float32)
         for _ in range(C)]), gp)
    x = _x(name, rng, C, B)
    y = rng.integers(0, 10, size=(C, B)).astype(np.int32)

    rloss = rmake_loss(lambda p, b: (rsmall.softmax_ce(
        rlogits(p, b["x"]), b["y"]), {}), fedprox_mu=fedprox_mu)
    (rl, _), rg = jax.vmap(jax.value_and_grad(rloss, has_aux=True),
                           in_axes=(0, 0, None))(
        jax.tree.map(jnp.asarray, pc), {"x": jnp.asarray(x),
                                        "y": jnp.asarray(y)},
        jax.tree.map(jnp.asarray, gp))

    tloss = tmake_loss(lambda p, b: (tsmall.softmax_ce(
        tlogits(p, b["x"]), b["y"]), {}), fedprox_mu=fedprox_mu)
    tg, (tl, _) = vmap(grad_and_value(tloss, has_aux=True),
                       in_dims=(0, 0, None))(
        interop.params_from_numpy(pc),
        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
        interop.params_from_numpy(gp))

    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(rg), tree_leaves(tg)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)


def test_accuracy_and_ce_match_reference(rng):
    logits = rng.normal(size=(32, 10)).astype(np.float32)
    y = rng.integers(0, 10, 32).astype(np.int32)
    np.testing.assert_allclose(
        float(tsmall.softmax_ce(torch.from_numpy(logits),
                                torch.from_numpy(y))),
        float(rsmall.softmax_ce(jnp.asarray(logits), jnp.asarray(y))),
        rtol=1e-6)
    assert float(tsmall.accuracy(torch.from_numpy(logits),
                                 torch.from_numpy(y))) == float(
        rsmall.accuracy(jnp.asarray(logits), jnp.asarray(y)))


def test_dense_init_distribution():
    """Same distribution as the reference's truncated normal: within
    [−2σ, 2σ] and σ_trunc ≈ 0.88·σ (not bitwise: jax.random vs torch)."""
    from repro_torch.models.common import dense_init
    w = dense_init(torch.Generator().manual_seed(0), (400, 256))
    s = 1 / np.sqrt(400)
    assert float(w.abs().max()) <= 2 * s + 1e-7
    assert abs(float(w.std()) / s - 0.8796) < 0.01
    params = tsmall.make_small_model(tcfg.CNN_PAPER)[0](0)
    assert params["conv1"]["w"].shape == (3, 3, 1, 16)
    assert params["fc1"]["w"].shape == (512, 128)
