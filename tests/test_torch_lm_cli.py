"""The LM path of the port's train CLI (``python -m
repro_torch.launch.train --arch ...``) on the CPU: ``train_lm`` with the
reference's initial params carried in (``setup_lm`` then ``train_lm(args,
lt)``) against the reference's ``train_lm`` over the same flags (params
within 1e-5·max|p| a leaf), the CLI under scenarios, compression,
telemetry and an event log for TinyLlama and Zamba2, crash and resume
(bitwise equal to an uninterrupted run, host loop and fused), serving a
trained checkpoint through the serve CLI, and the LM's refusals."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as rtrain
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch import interop
from repro_torch.launch import serve
from repro_torch.launch import train as ttrain
from repro_torch.models.model import build_model
from repro_torch.configs import get_config
from repro_torch.utils.tree import tree_flatten, tree_leaves

# a small LM run: C = 2 clients of K = 2 steps on 2 sequences of 16
SMALL = ["--reduced", "--layers", "2", "--d-model", "64",
         "--clients-per-round", "2", "--local-steps", "2", "--batch", "2",
         "--seq", "16", "--num-clients", "10", "--seed", "3"]


def _port(argv, lt=None):
    args = ttrain.build_parser().parse_args(argv + ["--device", "cpu"])
    return ttrain.train_lm(args, lt), args


def _assert_states_equal(a, b):
    assert a.round == b.round
    for name in ("params", "server_state", "buffer", "ef"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            xs = tree_leaves(x) if name != "buffer" else (
                tree_leaves(x.delta) + list(x[1:]))
            ys = tree_leaves(y) if name != "buffer" else (
                tree_leaves(y.delta) + list(y[1:]))
            assert all(torch.equal(torch.as_tensor(p), torch.as_tensor(q))
                       for p, q in zip(xs, ys)), name


@pytest.mark.parametrize("mode", [[], ["--flat"], ["--rounds-per-call", "2"]],
                         ids=["vmap", "flat", "fused"])
def test_train_lm_matches_the_reference_from_its_params(mode):
    argv = ["--arch", "tinyllama-1.1b", "--rounds", "2"] + SMALL + mode
    want = rtrain.train_lm(rtrain.build_parser().parse_args(argv))
    # the reference's init of the same config and seed, carried across
    jcfg = jget_config("tinyllama-1.1b").reduced(num_layers=2, d_model=64)
    jparams = jax.device_get(jbuild_model(jcfg).init(jax.random.key(3)))
    args = ttrain.build_parser().parse_args(argv + ["--device", "cpu"])
    lt = ttrain.setup_lm(args)
    lt = lt._replace(params=interop.params_from_numpy(jparams))
    got = ttrain.train_lm(args, lt)
    assert got.state.round == int(want.round) == 2
    assert len(got.history) == 2
    g, gdef = tree_flatten(interop.params_to_numpy(got.state.params))
    w, wdef = tree_flatten(jax.tree.map(np.asarray, want.params))
    assert gdef == wdef
    for path, a, b in zip(gdef, g, w):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(b).max()),
                                   err_msg=str(path))


@pytest.mark.parametrize("flags", [
    ["--scenario", "zipf_async", "--rounds-per-call", "2"],
    ["--compression", "int8", "--error-feedback"],
    ["--telemetry", "--rounds-per-call", "2"]],
    ids=["zipf_async", "int8_ef21", "telemetry"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-7b"])
def test_cli_runs_the_lm_under_each_feature(arch, flags, tmp_path, capsys):
    events = str(tmp_path / "events.jsonl")
    out, _ = _port(["--arch", arch, "--rounds", "2", "--events", events]
                   + SMALL + flags)
    assert out.state.round == 2 and out.test_acc is None
    assert all(np.isfinite(float(r["loss"])) for r in out.history)
    lines = [json.loads(ln) for ln in open(events)]
    kinds = [e.get("kind", e.get("event")) for e in lines]
    assert kinds.count("round") == 2 and "spans" in kinds
    text = capsys.readouterr().out
    assert "scenario report:" in text
    if "--telemetry" in flags:
        hist = np.stack([r["eta_hist"] for r in out.history])
        assert hist.sum(axis=1).tolist() == [2, 2]
    if "--compression" in flags:
        assert out.state.ef is not None
        assert all(float(r["wire_bytes"]) > 0 for r in out.history)
    if "zipf_async" in flags:
        assert out.state.buffer is not None


@pytest.mark.parametrize("mode", [
    ["--scenario", "zipf_async", "--compression", "int8",
     "--error-feedback"],
    ["--rounds-per-call", "2", "--flat"]], ids=["host_async_ef", "fused"])
def test_lm_crash_and_resume_equals_an_uninterrupted_run(tmp_path, mode):
    """Kill a run after 2 of 4 rounds and --resume: the state (params,
    server state, round, async buffer, EF21 tree) and the resumed
    rounds' metrics equal the uninterrupted run's bitwise, since the
    batches are drawn from (seed, round)."""
    def run(ckpt, rounds, *extra):
        return _port(["--arch", "zamba2-7b", "--rounds", str(rounds),
                      "--ckpt-dir", ckpt, "--ckpt-every", "2"] + SMALL
                     + mode + list(extra))[0]
    straight = run(str(tmp_path / "ref"), 4)
    cut = str(tmp_path / "cut")
    run(cut, 2)
    resumed = run(cut, 2, "--resume")
    assert straight.state.round == resumed.state.round == 4
    _assert_states_equal(straight.state, resumed.state)
    for a, b in zip(straight.history[2:], resumed.history):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k


def test_a_trained_lm_is_served_from_its_checkpoint(tmp_path):
    """TinyLlama at the serve CLI's reduced width (2 layers, d_model 256,
    vocab 512) trained 2 rounds with --ckpt-dir; the serve CLI given that
    directory decodes the trained params' tokens, not its own init's."""
    d = str(tmp_path)
    trained, _ = _port(["--arch", "tinyllama-1.1b", "--reduced", "--layers",
                        "2", "--d-model", "256", "--clients-per-round",
                        "2", "--local-steps", "1", "--batch", "1", "--seq",
                        "8", "--rounds", "2", "--ckpt-dir", d])
    flags = ["--arch", "tinyllama-1.1b", "--reduced", "--batch", "2",
             "--prompt-len", "8", "--gen", "4", "--device", "cpu",
             "--seed", "1"]
    got = serve.main(flags + ["--ckpt-dir", d])
    own = serve.main(flags)
    assert got["ckpt_step"] == 2
    model = build_model(get_config("tinyllama-1.1b").reduced())
    want, _, _ = serve.decode(model, trained.state.params,
                              serve.build_parser().parse_args(flags))
    np.testing.assert_array_equal(got["tokens"], want)
    assert not np.array_equal(got["tokens"], own["tokens"])


def test_lm_refusals():
    # the fleet needs per-client data partitions, as in the reference
    with pytest.raises(SystemExit, match="paper-task feature"):
        ttrain.main(["--arch", "tinyllama-1.1b", "--reduced",
                     "--num-registered", "1000", "--device", "cpu"])
    # architectures that are not ported name their ROADMAP item
    with pytest.raises(SystemExit, match="A15"):
        ttrain.main(["--arch", "xlstm-1.3b", "--reduced", "--device",
                     "cpu"])
    # the fused loop needs Δ-SGD, as the reference's does
    with pytest.raises(ValueError, match="delta_sgd"):
        ttrain.main(["--arch", "tinyllama-1.1b", "--rounds", "1",
                     "--client-opt", "adam", "--rounds-per-call", "2",
                     "--device", "cpu"] + SMALL)
    with pytest.raises(SystemExit):
        ttrain.main(["--device", "cpu"])
