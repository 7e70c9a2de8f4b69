"""Port parity for checkpointing (``repro_torch.checkpoint``) and the
train CLI's ``--ckpt-dir``/``--resume``.

The port writes the reference's on-disk format: the same manifest
(keys, logical dtypes, shapes) and the same ``.npy`` bytes for the same
state, so a checkpoint written by either package is restored by the
other bitwise, an async buffer, an EF21 tree, a bf16 leaf and the round
counter included. A CLI run cut after some rounds and resumed equals the
uninterrupted run bitwise, on the host loop and fused.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as r_restore
from repro.checkpoint import save as r_save
from repro.compression import CompressionSpec as RSpec
from repro.core import get_server_opt as r_sopt
from repro.core import init_fl_state as r_init
from repro.federation import get_scenario as r_scenario
from repro_torch import interop
from repro_torch.checkpoint import (latest_step, restore, restore_params,
                                    save)
from repro_torch.compression import CompressionSpec
from repro_torch.core import (flat, flatten_fl_state, get_client_opt,
                              get_server_opt, init_fl_state, make_fl_round,
                              make_loss, unflatten_fl_state)
from repro_torch.federation import get_scenario
from repro_torch.launch import train as ttrain
from repro_torch.utils.tree import tree_leaves

COHORT = 3


def _leaves(state):
    """Every leaf of a state in checkpoint order, as numpy."""
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    out = []
    for key, leaf in _flatten_with_paths(state):
        if isinstance(leaf, torch.Tensor):
            leaf = (leaf.float() if leaf.dtype == torch.bfloat16
                    else leaf).numpy()
        out.append((key, np.asarray(leaf), str(getattr(leaf, "dtype", ""))))
    return out


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [k for k, _, _ in la] == [k for k, _, _ in lb]
    for (k, x, dx), (_, y, dy) in zip(la, lb):
        assert dx == dy and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    assert a.round == b.round if hasattr(a, "round") else True


def _quad():
    def quad(p, batch):
        x = p["x"].to(torch.float32)
        r = batch["A"] @ x - batch["b"]
        return 0.5 * torch.mean(r * r), {}
    return make_loss(quad)


def _batches(rng, C, K, D):
    return {"A": torch.from_numpy(rng.normal(size=(C, K, 4, D)).astype(
                np.float32)),
            "b": torch.from_numpy(rng.normal(size=(C, K, 4)).astype(
                np.float32))}


def _async_ef_run(rounds, *, buffer_size=9, ckpt=None, resume_after=None):
    """Flat async + int8 EF21 rounds on a quadratic, fedadam server;
    optionally saved after round ``resume_after`` and restored into a
    fresh state before going on."""
    rng = np.random.default_rng(0)
    D, K = 40, 2
    params = {"x": torch.from_numpy(rng.normal(size=D).astype(np.float32))}
    scn = get_scenario("zipf_async", buffer_size=buffer_size)
    comp = CompressionSpec(kind="int8", error_feedback=True)
    sopt = get_server_opt("fedadam")
    rnd = make_fl_round(_quad(), get_client_opt("delta_sgd"), sopt,
                        num_rounds=10, flat=True, scenario=scn,
                        compression=comp)
    state = init_fl_state(params, sopt, scn, compression=comp, cohort=4)
    batches = [_batches(rng, 4, K, D) for _ in range(rounds)]
    for t in range(rounds):
        state, _, _ = rnd(state, batches[t])
        if ckpt is not None and t == resume_after:
            save(ckpt, state, step=state.round)
            fresh = init_fl_state(params, sopt, scn, compression=comp,
                                  cohort=4)
            state, _ = restore(ckpt, like=fresh)
    return state


def test_flstate_with_buffer_and_ef_round_trips(tmp_path):
    """A part-full async buffer (M = 9 > 2 rounds x 4 clients), the EF21
    tree and fedadam's moments, all non-zero, come back bitwise, and a
    template without a buffer is refused."""
    state = _async_ef_run(2)
    assert int(state.buffer.count) == 8
    assert float(state.buffer.delta["x"].abs().max()) > 0.0
    assert float(state.ef["x"].abs().max()) > 0.0
    save(str(tmp_path), state, step=2)
    restored, step = restore(str(tmp_path), like=state)
    assert step == 2 and restored.round == 2
    assert isinstance(restored.round, int)
    _assert_states_equal(state, restored)
    plain = init_fl_state({"x": torch.zeros(40)}, get_server_opt("fedavg"))
    with pytest.raises(ValueError):
        restore(str(tmp_path), like=plain)


def test_resume_with_buffer_and_ef_is_bitwise(tmp_path):
    straight = _async_ef_run(4)
    resumed = _async_ef_run(4, ckpt=str(tmp_path), resume_after=1)
    assert straight.round == resumed.round == 4
    _assert_states_equal(straight, resumed)


def test_flat_form_state_round_trips(tmp_path):
    """A FlatFLState (what a fused run carries) round-trips bitwise and
    unpacks to the tree state it was packed from."""
    rng = np.random.default_rng(1)
    params = {"w": torch.from_numpy(rng.normal(size=(40, 3)).astype(
                  np.float32)),
              "e": torch.from_numpy(rng.normal(size=(9,)).astype(
                  np.float32)).to(torch.bfloat16)}
    scn = get_scenario("zipf_async")
    comp = CompressionSpec(kind="int8", error_feedback=True)
    state = init_fl_state(params, get_server_opt("fedadam"), scn,
                          compression=comp, cohort=COHORT)
    state = state._replace(ef={k: v + 0.5 for k, v in state.ef.items()})
    layout = flat.layout_of(params)
    fstate = flatten_fl_state(state, layout)
    save(str(tmp_path), fstate, step=4)
    restored, step = restore(str(tmp_path), like=fstate)
    assert step == 4
    _assert_states_equal(fstate, restored)
    _assert_states_equal(unflatten_fl_state(restored, layout), state)


def test_keep_newest_and_latest(tmp_path):
    tree = {"w": torch.zeros(2)}
    assert latest_step(str(tmp_path / "none")) is None
    for s in (1, 2, 3, 4, 5):
        save(str(tmp_path), {"w": torch.full((2,), float(s))}, step=s,
             keep=2)
    assert latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["step_00000004",
                                            "step_00000005"]
    got, s = restore(str(tmp_path), like=tree)
    assert s == 5 and got["w"].tolist() == [5.0, 5.0]
    got, s = restore(str(tmp_path), like=tree, step=4)
    assert got["w"].tolist() == [4.0, 4.0]
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path), like=tree, step=1)
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"), like=tree)


def test_shape_mismatch_refused(tmp_path):
    save(str(tmp_path), {"w": torch.zeros(3)}, step=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore(str(tmp_path), like={"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_params(str(tmp_path), {"w": torch.zeros(4)})


# ------------------------------------------------------ across packages
def _reference_state():
    """A reference FLState with every slot filled: bf16 and f32 params,
    fedadam's moments and step, a part-full async buffer, EF21, round 5."""
    rng = np.random.default_rng(2)
    params = {"w": jnp.asarray(rng.normal(size=(8, 4)), jnp.float32),
              "b": {"x": jnp.asarray(rng.normal(size=(4,)), jnp.bfloat16)}}
    scn = r_scenario("zipf_async")
    state = r_init(params, r_sopt("fedadam"), scn,
                   compression=RSpec(kind="int8", error_feedback=True),
                   cohort=COHORT)

    def fill(x):
        v = rng.normal(size=np.shape(x))
        if np.issubdtype(x.dtype, np.integer):
            v = rng.integers(1, 9, size=np.shape(x))
        return jnp.asarray(v, x.dtype)
    state = jax.tree.map(fill, state)
    return state._replace(round=jnp.asarray(5, jnp.int32))


def _port_template():
    params = {"w": torch.zeros((8, 4)),
              "b": {"x": torch.zeros(4, dtype=torch.bfloat16)}}
    return init_fl_state(params, get_server_opt("fedadam"),
                         get_scenario("zipf_async"),
                         compression=CompressionSpec(
                             kind="int8", error_feedback=True),
                         cohort=COHORT)


def _manifest(d):
    steps = [e for e in os.listdir(d) if e.startswith("step_")]
    with open(os.path.join(d, steps[0], "manifest.json")) as f:
        return json.load(f), os.path.join(d, steps[0])


def test_reference_checkpoint_restores_in_the_port_bitwise(tmp_path):
    rstate = _reference_state()
    r_save(str(tmp_path), rstate, step=5)
    got, step = restore(str(tmp_path), like=_port_template())
    assert step == 5 and got.round == 5 and isinstance(got.round, int)
    assert got.params["b"]["x"].dtype == torch.bfloat16
    assert got.buffer.count.dtype == torch.int32
    want = jax.device_get(rstate)
    back = interop.fl_state_to_numpy(got)
    rl = jax.tree_util.tree_leaves(want)
    pl = jax.tree_util.tree_leaves(tuple(back))
    assert len(rl) == len(pl) == 16
    for a, b in zip(rl, pl):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.shape(a) == np.shape(b)
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_port_checkpoint_restores_in_the_reference_bitwise(tmp_path):
    """The port's save of the same state writes the reference's manifest
    and the same bytes per leaf, and the reference restores it."""
    rstate = _reference_state()
    port = interop.fl_state_from_numpy(jax.device_get(rstate))
    save(str(tmp_path / "port"), port, step=5)
    r_save(str(tmp_path / "ref"), rstate, step=5)
    (pm, pd), (rm, rd) = (_manifest(str(tmp_path / "port")),
                          _manifest(str(tmp_path / "ref")))
    assert pm == rm
    assert any(m["dtype"] == "bfloat16" for m in pm["leaves"])
    assert [(m["dtype"], m["shape"]) for m in pm["leaves"]
            if m["key"] == "round"] == [("int32", [])]
    for m in pm["leaves"]:
        a = np.load(os.path.join(pd, m["file"]))
        b = np.load(os.path.join(rd, m["file"]))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), m["key"]
    got, step = r_restore(str(tmp_path / "port"), like=rstate)
    assert step == 5
    for a, b in zip(jax.tree_util.tree_leaves(rstate),
                    jax.tree_util.tree_leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_restore_params_from_a_full_flstate_checkpoint(tmp_path):
    """Serving reads the params of a training checkpoint: ``k`` or
    ``params/k``; a missing leaf names its key."""
    state = interop.fl_state_from_numpy(jax.device_get(_reference_state()))
    save(str(tmp_path), state, step=3)
    like = {"w": torch.zeros((8, 4)),
            "b": {"x": torch.zeros(4, dtype=torch.bfloat16)}}
    got, step = restore_params(str(tmp_path), like)
    assert step == 3
    for a, b in zip(tree_leaves(got), tree_leaves(state.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    save(str(tmp_path / "bare"), state.params, step=1)
    got, _ = restore_params(str(tmp_path / "bare"), like)
    assert torch.equal(got["w"], state.params["w"])
    with pytest.raises(KeyError, match="'z'"):
        restore_params(str(tmp_path), {"z": torch.zeros(2)})


# ---------------------------------------------------------- the CLI
def _cli(ckpt, rounds, *extra):
    return ttrain.main(["--device", "cpu", "--task", "easy", "--model",
                        "mlp", "--num-clients", "20", "--batch", "128",
                        "--rounds", str(rounds), "--ckpt-dir", ckpt,
                        "--ckpt-every", "2", "--seed", "0", *extra])


def test_final_round_always_saved_and_keyed_on_the_round(tmp_path):
    """--ckpt-every 2 over 3 rounds saves after rounds 1 and 3 (the
    last); a resumed run's saves are numbered past the first run's."""
    d = str(tmp_path)
    _cli(d, 3, "--flat")
    assert sorted(os.listdir(d)) == ["step_00000001", "step_00000003"]
    _cli(d, 1, "--flat", "--resume")
    assert latest_step(d) == 4


@pytest.mark.parametrize("mode", [["--flat"], ["--rounds-per-call", "2"],
                                  ["--rounds-per-call", "2", "--scenario",
                                   "zipf_async", "--participation",
                                   "0.2"]],
                         ids=["host", "fused", "fused_async"])
def test_cli_crash_and_resume_equals_an_uninterrupted_run(tmp_path, mode):
    straight = _cli(str(tmp_path / "ref"), 4, *mode)
    cut = str(tmp_path / "cut")
    _cli(cut, 2, *mode)
    resumed = _cli(cut, 2, *mode, "--resume")
    assert straight.state.round == resumed.state.round == 4
    _assert_states_equal(straight.state, resumed.state)
    for a, b in zip(straight.history[2:], resumed.history):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k
