"""The differentiable collectives of tensor-parallel training, on 4 gloo
CPU ranks, and per-block remat.

One spawn of 4 ranks over a (data 2, model 2) mesh
(``tests/_torch_tp_grad_worker.py``) runs each operator of
``repro_torch.sharding.dist`` forward, under ``torch.func.grad`` and
under ``torch.func.vmap(grad)`` over 3 stacked clients; the test holds
each value against the unsharded math in numpy (within 1e-6) and checks
the ops each records: one a call, the stacked clients in one op under
vmap, and the gradient's op marked backward with its role. Remat
(``models.common.remat_call`` through ``transformer.stack_full``)
gives gradients bitwise equal to the plain blocks' under
``vmap(grad)``, on one process.
"""
import pickle

import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro_torch.configs import get_config
from repro_torch.models.common import remat_blocks, remat_on
from repro_torch.models.model import build_model
from repro_torch.sharding import dist
from repro_torch.utils.tree import tree_leaves, tree_map

from _torch_tp_grad_worker import C, inputs

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from _torch_tp_grad_worker import run_rank
    tmp = tmp_path_factory.mktemp("tp_grad_ranks")
    dist.spawn(run_rank, 4, (str(tmp),), device="cpu", threads=1)
    out = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _ops(res, name):
    return [(kind, role, axes, bwd) for kind, role, axes, _, bwd
            in res[name + "_ops"]]


def test_copy_to_is_identity_forward_and_sums_its_gradient(ranks):
    t = inputs()
    both = ("data", "model")
    for res in ranks:
        r = res["rank"]
        _close(res["copy_fwd"], t["x"][r][0])
        _close(res["copy_grad"], t["w"].sum(0))
        _close(res["copy_vgrad"], np.broadcast_to(t["w"].sum(0),
                                                  (C, 5, 8)))
        assert _ops(res, "copy_fwd") == []
        assert _ops(res, "copy_grad") == [("all-reduce", "tp_grad", both,
                                           True)]
        assert _ops(res, "copy_vgrad") == [("all-reduce", "tp_grad", both,
                                            True)]
        assert res["copy_vgrad_ops"][0][3] == (C, 5, 8)


def test_reduce_from_sums_forward_and_passes_its_gradient(ranks):
    t = inputs()
    both = ("data", "model")
    for res in ranks:
        r = res["rank"]
        _close(res["reduce_fwd"], (t["x"][:, 0] * t["w"]).sum(0))
        _close(res["reduce_grad"], t["w"][r] * t["c"])
        _close(res["reduce_vgrad"], np.broadcast_to(t["w"][r] * t["c"],
                                                    (C, 5, 8)))
        assert _ops(res, "reduce_fwd") == [("all-reduce", "tp_reduce", both,
                                            False)]
        # one forward sum, no op in the backward
        assert _ops(res, "reduce_vgrad") == [("all-reduce", "tp_reduce",
                                              both, False)]
        assert res["reduce_vgrad_ops"][0][3] == (C, 5, 8)


def test_gather_from_gathers_and_reduce_scatters_its_gradient(ranks):
    t = inputs()
    for res in ranks:
        d, m = res["coord"]["data"], res["coord"]["model"]
        group = [2 * d, 2 * d + 1]
        _close(res["gather_fwd"], np.concatenate([t["x"][g][0]
                                                  for g in group], 1))
        total = t["u"][group].sum(0)               # (C, 5, 16)
        mine = total[..., 8 * m:8 * m + 8]
        _close(res["gather_grad"], mine[0])
        _close(res["gather_vgrad"], mine)
        assert _ops(res, "gather_grad") == [
            ("all-gather", "fsdp_gather", ("model",), False),
            ("reduce-scatter", "fsdp_scatter", ("model",), True)]
        assert [o[3] for o in res["gather_vgrad_ops"]] == [(C, 5, 16),
                                                          (C, 5, 16)]


def test_max_over_takes_the_global_max_without_gradient(ranks):
    t = inputs()
    for res in ranks:
        _close(res["max_fwd"], t["x"][:, 0].max(0))
        _close(res["max_vfwd"], t["x"].max(0))
        # d/da of (max + a).sum() is 1: nothing flows through the max
        _close(res["max_grad"], np.ones((5, 8), np.float32))
        assert all(role == "vocab" for _, role, _, _ in
                   _ops(res, "max_grad"))
        assert res["input_kept"]


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-20b"])
def test_remat_gradients_are_the_plain_blocks_bits(arch):
    """``vmap(grad)`` of a 2-layer stack's loss over 3 clients, with
    remat on and off: the same loss and the same gradient bits."""
    cfg = get_config(arch).reduced(num_layers=2, d_model=64, vocab=512)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (3, 2, 17), generator=gen)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    stacked = tree_map(lambda a: a.expand((3,) + tuple(a.shape)),
                           params)

    def loss(p, b):
        return model.loss(p, b, use_pallas=False)[0]

    def run(flag):
        with remat_blocks(flag):
            assert remat_on() == flag
            return vmap(grad(loss))(stacked, batch), vmap(loss)(stacked,
                                                                  batch)

    (g0, l0), (g1, l1) = run(False), run(True)
    assert not remat_on()
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)
