"""Port parity for the whole slice: R rounds of the round-fused loop
(``make_fl_loop`` with the arena gather) on a small MLP federation and
one round of the shallow CNN, against the reference's
``make_fl_loop(flat="xla")`` and one ``flat="pallas"`` case, with the
reference's initial params and cohort ids injected. Per-round ``loss`` /
``eta_*`` and the final params agree within 1e-5 relative; the port's
fused loop equals its host loop bitwise and launches 2·K·R kernels; and
the CLI runs end to end on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_tasks import CNN_PAPER, MLP_SMALL
from repro.core import arena_gather as r_gather
from repro.core import flatten_fl_state as r_flatten
from repro.core import get_client_opt as r_copt
from repro.core import get_server_opt as r_sopt
from repro.core import init_fl_state as r_init
from repro.core import make_fl_loop as r_loop
from repro.core import make_loss as r_make_loss
from repro.core import unflatten_fl_state as r_unflatten
from repro.data.pipeline import FederatedDataset as RFed
from repro.data.synthetic import get_task as r_task
from repro.models.small import make_small_model as r_model
from repro.models.small import softmax_ce as r_ce
from repro_torch import interop
from repro_torch.configs import paper_tasks as tcfg
from repro_torch.core import (arena_gather, flatten_fl_state,
                              get_client_opt, get_server_opt, init_fl_state,
                              make_fl_loop, make_fl_round, make_loss,
                              unflatten_fl_state)
from repro_torch.data.pipeline import FederatedDataset
from repro_torch.data.synthetic import get_task
from repro_torch.federation import get_scenario
from repro_torch.kernels.delta_sgd import delta_sgd as tk
from repro_torch.launch import train as ttrain
from repro_torch.models.small import make_small_model, softmax_ce
from repro_torch.utils.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
METRICS = ("loss", "loss_last_step", "eta_mean", "eta_min", "eta_max",
           "eta_clip_rate", "nan_guard_rate")

# (task, reference model config, port model config, clients, p, batch,
#  samples per client)
SETUPS = {"mlp": ("easy", MLP_SMALL, tcfg.MLP_SMALL, 20, 0.2, 16, 64),
          "cnn": ("image", CNN_PAPER, tcfg.CNN_PAPER, 10, 0.2, 8, 32)}


class ReplayScheduler:
    def __init__(self, ids, round0=0):
        self.ids, self.round0 = np.asarray(ids), round0
        self.cohort = self.ids.shape[1]

    def sample(self, seed, t):
        return self.ids[t - self.round0]


def _reference(name, R, flat):
    """The reference's fused loop on its own data -> (initial FLState,
    staged indices, cohort ids, K, metrics, final params)."""
    task, rcfg, _, m, p, b, spc = SETUPS[name]
    fed = RFed.build(r_task(task, seed=0), num_clients=m, alpha=0.1,
                     samples_per_client=spc, seed=0)
    K = fed.epoch_steps(b)
    init_fn, logits_fn = r_model(rcfg)
    params = init_fn(jax.random.key(0))
    loss = r_make_loss(lambda q, bt: (r_ce(logits_fn(q, bt["x"]), bt["y"]),
                                      {}))
    copt, sopt = r_copt("delta_sgd"), r_sopt("fedavg")
    loop = r_loop(loss, copt, sopt, params_like=params, num_rounds=10,
                  rounds_per_call=R, flat=flat, gather=r_gather)
    idx, _, ids = fed.sample_block(p, K, b, round0=0, rounds=R)
    state0 = r_init(params, sopt)
    fst = r_flatten(state0, loop.layout)
    arena = jax.tree.map(jnp.asarray, fed.arena())
    fst, mets = jax.jit(loop)(fst, jnp.asarray(idx), arena=arena)
    final = r_unflatten(fst, loop.layout).params
    return (jax.device_get(state0), idx, ids, K, jax.device_get(mets),
            jax.device_get(final))


def _port_setup(name, ids):
    task, _, pcfg, m, p, b, spc = SETUPS[name]
    fed = FederatedDataset.build(get_task(task, seed=0), num_clients=m,
                                 alpha=0.1, samples_per_client=spc, seed=0,
                                 scheduler=ReplayScheduler(ids))
    _, logits_fn = make_small_model(pcfg)
    loss = make_loss(lambda q, bt: (softmax_ce(logits_fn(q, bt["x"]),
                                               bt["y"]), {}))
    return fed, loss, get_client_opt("delta_sgd"), get_server_opt("fedavg")


def _port_fused(name, state0_np, ids, K, R):
    fed, loss, copt, sopt = _port_setup(name, ids)
    p, b = SETUPS[name][4], SETUPS[name][5]
    state0 = interop.fl_state_from_numpy(state0_np)
    loop = make_fl_loop(loss, copt, sopt, params_like=state0.params,
                        num_rounds=10, rounds_per_call=R, gather=arena_gather)
    idx, _, _ = fed.sample_block(p, K, b, round0=0, rounds=R)
    arena = {k: torch.from_numpy(v) for k, v in fed.arena().items()}
    tk.reset_launch_count()
    fst, mets = loop(flatten_fl_state(state0, loop.layout),
                     torch.from_numpy(idx), arena=arena)
    launches = tk.launch_count()
    return idx, mets, unflatten_fl_state(fst, loop.layout), launches


def _port_host(name, state0_np, ids, K, R):
    fed, loss, copt, sopt = _port_setup(name, ids)
    p, b = SETUPS[name][4], SETUPS[name][5]
    round_fn = make_fl_round(loss, copt, sopt, num_rounds=10, flat=True)
    state = init_fl_state(interop.params_from_numpy(state0_np.params), sopt)
    rows = []
    for t in range(R):
        batches, _, _ = fed.sample_round(p, K, b, round_idx=t)
        state, m, _ = round_fn(state, {k: torch.from_numpy(v)
                                       for k, v in batches.items()})
        rows.append(m)
    return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


@pytest.mark.parametrize("name,R,flat", [("mlp", 3, "xla"),
                                         ("mlp", 1, "pallas"),
                                         ("cnn", 1, "xla")])
def test_fused_loop_matches_reference(name, R, flat):
    state0_np, ridx, ids, K, rmets, rfinal = _reference(name, R, flat)
    idx, mets, state, launches = _port_fused(name, state0_np, ids, K, R)
    np.testing.assert_array_equal(idx, ridx)
    assert set(mets) == set(rmets) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(mets[k].numpy(), np.asarray(rmets[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(rfinal),
                    tree_leaves(state.params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    assert state.round == R
    assert launches == 2 * K * R


def test_fused_loop_equals_host_loop_bitwise():
    state0_np, _, ids, K, _, _ = _reference("mlp", 3, "xla")
    _, fmets, fstate, _ = _port_fused("mlp", state0_np, ids, K, 3)
    hstate, hmets = _port_host("mlp", state0_np, ids, K, 3)
    for k in METRICS:
        assert torch.equal(fmets[k], hmets[k]), k
    for a, b in zip(tree_leaves(fstate.params), tree_leaves(hstate.params)):
        assert torch.equal(a, b)
    assert fstate.round == hstate.round == 3


def test_unported_arguments_name_their_roadmap_item(tmp_path):
    """A mesh without a FederationSpec is refused, as the reference
    refuses it (mesh sharding itself is ported: tests/
    test_torch_sharded_round.py). The LM's flags run on --task,
    which ignores them as the reference's paper task does: the run
    equals one without them. (The fleet, async, checkpoint and LM runs:
    test_torch_fleet.py, test_torch_async.py, test_torch_checkpoint.py,
    test_torch_lm_cli.py.)"""
    loss = make_loss(lambda q, bt: (q["x"].sum(), {}))
    copt, sopt = get_client_opt("delta_sgd"), get_server_opt("fedavg")
    with pytest.raises(ValueError, match="mesh and federation must be "
                                         "given together"):
        make_fl_round(loss, copt, sopt, num_rounds=1, mesh=object())
    # async aggregation needs the flat engine, as in the reference
    with pytest.raises(ValueError, match="flat engine"):
        make_fl_round(loss, copt, sopt, num_rounds=1,
                      scenario=get_scenario("zipf_async"))
    base = ["--task", "easy", "--rounds", "1", "--num-clients", "10",
            "--batch", "8", "--device", "cpu"]
    plain = ttrain.main(base)
    lm = ttrain.main(base + ["--layers", "2", "--seq", "16", "--ckpt-dir",
                             str(tmp_path)])
    assert plain.state.round == lm.state.round == 1
    assert lm.test_acc == plain.test_acc
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(plain.state.params), tree_leaves(lm.state.params)))


def test_cli_runs_on_cpu_and_fused_equals_flat():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    common = [sys.executable, "-m", "repro_torch.launch.train", "--device",
              "cpu", "--task", "easy", "--model", "mlp", "--rounds", "2",
              "--num-clients", "20", "--batch", "128"]
    outs = []
    for extra in (["--rounds-per-call", "2"], ["--flat"]):
        proc = subprocess.run(common + extra, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        outs.append([l.split("(")[0] for l in proc.stdout.splitlines()])
    assert outs[0] == outs[1]
    assert outs[0][-1].startswith("final test-acc")


def test_default_device_without_a_gpu_is_an_error(monkeypatch):
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
