"""Training and the CLIs for the LM zoo's MoE, MLA, dense, xLSTM,
encoder-decoder and image-token archs on the CPU, against the
reference: ``Model.loss`` and its gradient against
``jax.value_and_grad`` (the MoE aux and DeepSeek-V3's MTP loss in it;
Whisper's encoder and cross-attention, InternVL2's image positions and
xLSTM's recurrences in the gradient), ``vmap(grad)`` of the loss over a
client axis (each client routes its own tokens, reads its own frames or
image embeddings) against each client's own gradient, one ``train_lm``
round of OLMoE on each engine against the reference's step builders,
the fused loop bitwise equal to the ``--flat`` host loop, and the serve
and train CLIs with ``--reduced --device cpu`` for each arch added
since the dense ones. Models are the configs' reduced widths at 2
layers (xLSTM 4), d_model 64, vocab 500; the reference's params are
carried across (``repro_torch.interop``).
Tolerances as in ``test_torch_lm_train.py``: losses and gradients 1e-5
relative with an absolute floor of 1e-5·max|g|.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from repro.configs import FLConfig as RFL
from repro.configs import get_config as jget_config
from repro.core import init_fl_state as r_init
from repro.data.pipeline import lm_round_batches as r_lm_batches
from repro.launch import steps as rsteps
from repro.models import build_model as jbuild_model
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.kernels.delta_sgd import delta_sgd as tk
from repro_torch.launch import serve
from repro_torch.launch import train as ttrain
from repro_torch.models.model import build_model
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map

VOCAB, D, SEED = 500, 64, 5
C, K, B, S = 2, 2, 2, 16
ARCHS = ["olmoe-1b-7b", "deepseek-v3-671b", "codeqwen1.5-7b", "qwen2.5-14b",
         "granite-20b", "xlstm-1.3b", "whisper-tiny", "internvl2-1b"]
NEW = ARCHS[-3:]
# layers a reduced config keeps: xLSTM's period is [m, m, m, s]
LAYERS = {"xlstm-1.3b": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one CPU thread while this module runs: its ops are small,
    and eight threads a worker contend with the other test workers and
    with XLA's pool in the same process. Put back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(get, arch):
    return get(arch).reduced(num_layers=LAYERS.get(arch, 2), d_model=D,
                             vocab=VOCAB)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference model, its params as numpy, port model, port params)."""
    jmodel = jbuild_model(_cfg(jget_config, arch))
    jparams = jax.device_get(jax.jit(jmodel.init)(jax.random.key(2)))
    model = build_model(_cfg(get_config, arch))
    return jmodel, jparams, model, interop.params_from_numpy(jparams)


def _batch(seed, lead=(B,), cfg=None):
    """Tokens and labels, plus the stub frames or image embeddings of
    ``cfg`` where it has them."""
    r = np.random.default_rng(seed)
    toks = r.integers(0, VOCAB, lead + (S + 1,)).astype(np.int32)
    out = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg is not None and cfg.encoder_layers:
        out["frames"] = r.normal(size=lead + (cfg.encoder_seq, D)
                                 ).astype(np.float32)
    if cfg is not None and cfg.num_image_tokens:
        out["image_embeds"] = r.normal(
            size=lead + (cfg.num_image_tokens, D)).astype(np.float32)
    return out


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


# --------------------------------------------------------- loss and grads
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b",
                                  "granite-20b"] + NEW)
def test_model_loss_and_gradient_match_jax_grad(arch):
    jmodel, jp, model, p = _pair(arch)
    bt = _batch(1, cfg=model.cfg)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda q: jmodel.loss(q, bt), has_aux=True))(jp)
    tg, (tl, taux) = grad_and_value(
        lambda q: model.loss(q, _t(bt), use_pallas=False),
        has_aux=True)(p)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-5)
    _close_trees(tg, jg)
    if arch in ARCHS[:2]:
        # the router and the MTP block learn
        assert float(tg["stack"]["run0"]["moe"]["router"].abs().sum()) > 0
    if arch == "deepseek-v3-671b":
        assert float(tg["mtp"]["proj"].abs().sum()) > 0
    if arch == "whisper-tiny":
        # the encoder learns through the cross-attention
        assert float(tg["encoder"]["stack"]["run0"]["attn"]["wq"]
                     .abs().sum()) > 0
    if arch == "xlstm-1.3b":
        # the sLSTM's recurrent weights learn through its time loop
        assert float(tg["stack"]["run1"]["mixer"]["r"].abs().sum()) > 0


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"] + NEW)
def test_vmap_grad_matches_each_clients_grad(arch):
    """The vmap engine's trace of the loss over C clients, each with its
    own params and tokens (and frames or image embeddings) and so its
    own routing, capacity drops and MTP loss, gives each client's own
    loss and gradient."""
    _, _, model, p = _pair(arch)
    r = np.random.default_rng(11)
    pc = tree_map(lambda x: torch.stack(
        [x + 1e-2 * torch.from_numpy(r.normal(size=x.shape).astype(
            np.float32)) for _ in range(C)]), p)
    bt = _t(_batch(7, lead=(C, B), cfg=model.cfg))

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


# ------------------------------------------------------------------ rounds
def _train_lm(arch, rounds, *flags):
    """The port's ``train_lm`` from the reference's params: (result,
    Δ-SGD launches)."""
    args = ttrain.build_parser().parse_args(
        ["--arch", arch, "--rounds", str(rounds), "--clients-per-round",
         str(C), "--local-steps", str(K), "--batch", str(B), "--seq",
         str(S), "--num-clients", "10", "--seed", str(SEED), "--device",
         "cpu"] + list(flags))
    lt = ttrain.setup_lm(args, get_config(arch).reduced(d_model=D,
                                                        vocab=VOCAB))
    lt = lt._replace(params=interop.params_from_numpy(_pair(arch)[1]))
    tk.reset_launch_count()
    out = ttrain.train_lm(args, lt)
    return out, tk.launch_count()


def _round_batches(rounds):
    bs = [r_lm_batches(np.random.default_rng((SEED, r)), clients=C,
                       local_steps=K, batch=B, seq=S, vocab=VOCAB)
          for r in range(rounds)]
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


@pytest.mark.parametrize("engine", ["vmap", "flat"])
def test_olmoe_round_matches_the_references_train_step(engine):
    """One round of OLMoE on each engine against the reference's
    ``make_train_step`` (loss and η within 1e-5, params within
    1e-5·max|p| a leaf); the flat engine's fused loop equals its host
    loop bitwise."""
    arch = "olmoe-1b-7b"
    jmodel, jp, _, _ = _pair(arch)
    rstep, rsopt, _, _ = rsteps.make_train_step(
        jmodel, RFL(num_clients=10, local_steps=K, lr=0.05), num_rounds=1,
        flat=engine == "flat")
    rstate, rmets = jax.jit(rstep)(
        r_init(jp, rsopt), {k: v[0] for k, v in _round_batches(1).items()})
    got, launches = _train_lm(arch, 1,
                              *(["--flat"] if engine == "flat" else []))
    assert launches == (2 * K if engine == "flat" else 0)
    want = jax.device_get(rmets)
    for k in ("loss", "eta_mean", "eta_min", "eta_max"):
        np.testing.assert_allclose(np.asarray(got.history[0][k], np.float32),
                                   np.asarray(want[k]), rtol=1e-5,
                                   err_msg=k)
    _close_trees(got.state.params, jax.device_get(rstate.params))
    if engine == "flat":
        fused, launches = _train_lm(arch, 1, "--rounds-per-call", "2")
        assert launches == 2 * K
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(fused.state.params), tree_leaves(got.state.params)))
        for k in got.history[0]:
            assert (got.history[0][k].tobytes()
                    == fused.history[0][k].tobytes()), k


# -------------------------------------------------------------------- CLIs
@pytest.mark.parametrize("arch", ARCHS)
def test_train_and_serve_clis_run_each_new_arch(arch, capsys):
    """``--reduced --device cpu``: a fused round of the train CLI
    (finite loss and η, 2·K Δ-SGD launches) and the serve CLI (tokens in
    the vocab, one flash-attention call a GQA site a request)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    tk.reset_launch_count()
    res = ttrain.main(["--arch", arch, "--reduced", "--layers", "2",
                       "--d-model", "64", "--clients-per-round", "2",
                       "--local-steps", "2", "--batch", "2", "--seq", "16",
                       "--rounds", "1", "--rounds-per-call", "2",
                       "--device", "cpu"])
    assert tk.launch_count() == 2 * 2
    row = res.history[0]
    assert np.isfinite(float(row["loss"])) and float(row["eta_mean"]) > 0
    fa.reset_launch_count()
    out = serve.main(["--device", "cpu", "--arch", arch, "--reduced",
                      "--batch", "2", "--prompt-len", "16", "--gen", "6"])
    cfg = get_config(arch).reduced()
    assert out["tokens"].shape == (2, 6)
    assert 0 <= out["tokens"].min() and out["tokens"].max() < cfg.vocab_size
    sites = sum(t in ("attn", "moe", "shared_attn") for t in cfg.layer_types)
    assert fa.launch_count() == (0 if cfg.use_mla else 2 * sites)
    assert "decoded 6 tokens x 2 on cpu" in capsys.readouterr().out
