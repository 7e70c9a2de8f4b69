"""The rounds of the port's ``launch.train.train_lm`` against the
reference's step builders (``repro.launch.steps.make_train_step`` and
``make_train_loop``) on the CPU: one round of each engine (vmap and
``--flat``) and two rounds of the fused loop (``--rounds-per-call 2``:
bitwise equal to the ``--flat`` host loop, 2·K·R Δ-SGD launches), with
the reference's params carried in (``setup_lm`` then ``train_lm(args,
lt)``, ``repro_torch.interop``) and the same per-round numpy batches,
drawn from ``(seed, round)`` (with Whisper's frames or InternVL2's
image embeddings, drawn after the tokens). Models: TinyLlama (2 layers),
Zamba2 (7: six Mamba2 layers and the shared block), xLSTM (4: three
mLSTM layers and an sLSTM), Whisper (2 + 2) and InternVL2 (2) at the
configs' reduced widths, d_model 64, vocab 500. A round's loss and η
agree within 1e-5 relative; the params after R rounds within
R·1e-5·max|p| a leaf, since each round adds its own reduction-order
difference. xLSTM is held looser, for the reason at ``XLSTM_RTOL``.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import FLConfig as RFL
from repro.configs import get_config as jget_config
from repro.core import init_fl_state as r_init
from repro.core.fed_loop import flatten_fl_state as r_flatten
from repro.core.fed_loop import unflatten_fl_state as r_unflatten
from repro.data.pipeline import lm_round_batches as r_lm_batches
from repro.launch import steps as rsteps
from repro.models import build_model as jbuild_model
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.kernels.delta_sgd import delta_sgd as tk
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.mamba2_scan import mamba2_scan as m2
from repro_torch.launch import train as ttrain
from repro_torch.utils.tree import tree_flatten, tree_leaves

VOCAB, D, SEED = 500, 64, 5
MODELS = [("tinyllama-1.1b", 2), ("zamba2-7b", 7), ("xlstm-1.3b", 4),
          ("whisper-tiny", 2), ("internvl2-1b", 2)]
C, K, B, S = 2, 2, 2, 16
# xLSTM's local steps are ill-conditioned in f32 at this config: its
# first Δ-SGD step moves embedding rows by up to 1.8 (they start near
# 0.02), and the second step's gradient at the moved point, and η, which
# divides by a difference of two close gradients, carry the rounding of
# the first. Both packages' f32 results after two local steps lie up to
# 1.5e-3·max|p| (a leaf) and their η up to 1.3e-4 from an f64 evaluation
# of the same steps, on either side of it
# (test_torch_lm_zoo_enc.py::test_xlstm_local_steps_are_f32_conditioned_in_both_packages);
# the two agree to 5.6e-4·max|p| and 4e-5 in η; the loss within 1e-5 as
# for every arch. A later round amplifies that gap (round 1's η differs
# by 8 %), so each later round is held against the reference's round from
# the port's own params before it, where the two agree as round 0 does.
XLSTM_RTOL = {"eta": 1e-4, "params": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one CPU thread while this module runs: its ops are small,
    and eight threads a worker contend with the other test workers and
    with XLA's pool in the same process. Put back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rtol(arch, what):
    return XLSTM_RTOL[what] if arch == "xlstm-1.3b" else 1e-5


@functools.lru_cache(maxsize=None)
def _reference(arch, layers):
    """(reference model, its params as numpy)."""
    jmodel = jbuild_model(jget_config(arch).reduced(
        num_layers=layers, d_model=D, vocab=VOCAB))
    return jmodel, jax.device_get(jmodel.init(jax.random.key(layers)))


def _train_lm(arch, layers, rounds, *flags):
    """The port's ``train_lm`` from the reference's params: (result,
    Δ-SGD launches)."""
    args = ttrain.build_parser().parse_args(
        ["--arch", arch, "--rounds", str(rounds), "--clients-per-round",
         str(C), "--local-steps", str(K), "--batch", str(B), "--seq",
         str(S), "--num-clients", "10", "--seed", str(SEED), "--device",
         "cpu"] + list(flags))
    lt = ttrain.setup_lm(args, get_config(arch).reduced(
        num_layers=layers, d_model=D, vocab=VOCAB))
    lt = lt._replace(params=interop.params_from_numpy(
        _reference(arch, layers)[1]))
    tk.reset_launch_count()
    out = ttrain.train_lm(args, lt)
    return out, tk.launch_count()


def _reference_fl():
    # the FLConfig the reference's train_lm builds from the same flags
    return RFL(num_clients=10, local_steps=K, lr=0.05)


def _round_batches(rounds, jmodel):
    # the extras the reference's train_lm builds from the config
    cfg = jmodel.cfg
    extras = {}
    if cfg.encoder_layers:
        extras["frames"] = (cfg.encoder_seq, cfg.d_model)
    if cfg.num_image_tokens:
        extras["image_embeds"] = (cfg.num_image_tokens, cfg.d_model)
    bs = [r_lm_batches(np.random.default_rng((SEED, r)), clients=C,
                       local_steps=K, batch=B, seq=S, vocab=VOCAB,
                       extras=extras)
          for r in range(rounds)]
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def _close_trees(got, want, rtol=1e-5):
    """Each leaf within rtol, with an absolute floor of rtol·max|want|."""
    g, gdef = tree_flatten(interop.params_to_numpy(got))
    w, wdef = tree_flatten(jax.tree.map(np.asarray, want))
    assert gdef == wdef
    for path, a, b in zip(gdef, g, w):
        np.testing.assert_allclose(
            a, b, rtol=rtol, atol=rtol * float(np.abs(b).max()) + 1e-30,
            err_msg=str(path))


def _close_metrics(row, want, arch):
    for k in ("loss", "eta_mean", "eta_min", "eta_max"):
        rtol = _rtol(arch, "eta") if k.startswith("eta") else 1e-5
        np.testing.assert_allclose(np.asarray(row[k], np.float32),
                                   np.asarray(want[k]), rtol=rtol,
                                   err_msg=k)


@pytest.mark.parametrize("engine", ["vmap", "flat"])
@pytest.mark.parametrize("arch,layers", MODELS)
def test_train_step_matches_the_references(arch, layers, engine):
    jmodel, jp = _reference(arch, layers)
    rstep, rsopt, _, _ = rsteps.make_train_step(
        jmodel, _reference_fl(), num_rounds=1, flat=engine == "flat")
    rstate, rmets = jax.jit(rstep)(
        r_init(jp, rsopt), {k: v[0] for k, v in _round_batches(1, jmodel).items()})
    got, launches = _train_lm(arch, layers, 1,
                              *(["--flat"] if engine == "flat" else []))
    assert launches == (2 * K if engine == "flat" else 0)
    assert got.state.round == 1 and len(got.history) == 1
    _close_metrics(got.history[0], jax.device_get(rmets), arch)
    _close_trees(got.state.params, jax.device_get(rstate.params),
                 rtol=_rtol(arch, "params"))


@pytest.mark.parametrize("arch,layers", MODELS)
def test_train_loop_fused_equals_host_and_the_reference(arch, layers):
    jmodel, jp = _reference(arch, layers)
    R = 2
    if arch != "xlstm-1.3b":
        rloop, rsopt, _, _ = rsteps.make_train_loop(
            jmodel, _reference_fl(), num_rounds=R, rounds_per_call=R)
        rfs, rmets = jax.jit(rloop)(
            r_flatten(r_init(jp, rsopt), rloop.layout),
            _round_batches(R, jmodel))
        rstate = r_unflatten(rfs, rloop.layout)

    fused, launches = _train_lm(arch, layers, R, "--rounds-per-call",
                                str(R))
    assert launches == 2 * K * R
    # the host loop on the flat engine: the same bits
    host, _ = _train_lm(arch, layers, R, "--flat")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(host.state.params), tree_leaves(fused.state.params)))
    for h, f in zip(host.history, fused.history):
        assert h.keys() == f.keys()
        for k in h:
            assert h[k].tobytes() == f[k].tobytes(), k
    if arch == "xlstm-1.3b":
        # each round against the reference's round from the port's params
        # before it (XLSTM_RTOL says why)
        first, _ = _train_lm(arch, layers, 1, "--flat")
        rstep, rsopt, _, _ = rsteps.make_train_step(
            jmodel, _reference_fl(), num_rounds=R, flat=True)
        rstep = jax.jit(rstep)
        batches = _round_batches(R, jmodel)
        rmets = []
        for r, params in enumerate((jp, interop.params_to_numpy(
                first.state.params))):
            rstate, m = rstep(r_init(params, rsopt),
                              {k: v[r] for k, v in batches.items()})
            rmets.append(jax.device_get(m))
        rmets = {k: np.stack([m[k] for m in rmets]) for k in rmets[0]}
    rm = jax.device_get(rmets)
    for r in range(R):
        _close_metrics(fused.history[r], {k: v[r] for k, v in rm.items()},
                       arch)
    _close_trees(fused.state.params, jax.device_get(rstate.params),
                 rtol=R * _rtol(arch, "params"))


def test_use_pallas_reaches_the_client_optimizer_only():
    """``--use-pallas`` on the vmap engine takes the Δ-SGD step's kernel
    route (one norms and one apply launch a local step) while the model
    stays on its plain route (no attention kernel): the round is the
    plain step's within 1e-5."""
    plain, _ = _train_lm("tinyllama-1.1b", 2, 1)
    fa.reset_launch_count(), m2.reset_launch_count()
    kern, launches = _train_lm("tinyllama-1.1b", 2, 1, "--use-pallas")
    assert launches == 2 * K
    assert fa.launch_count() == m2.launch_count() == 0
    _close_metrics(kern.history[0], plain.history[0], "tinyllama-1.1b")
    _close_trees(kern.state.params, interop.params_to_numpy(
        plain.state.params))
