"""Port parity for the client and server optimizers, the (↓) decay
schedule, the MOON loss and the per-leaf Δ-SGD step.

Each client optimizer's ``init``/``reset``/``update`` runs 3 steps on f32
and on bf16 leaves against the reference's, within 1e-6 of each tensor's
scale; fedavgm, fedadam and fedyogi likewise on bf16 leaves (the
adaptive ones with f32 moments). On f32 leaves the reference runs
jitted, as its engine runs it. On bf16 leaves it runs op by op: under
``jax.jit`` XLA on the CPU keeps a chain of bf16 operations in f32 and
rounds once at the end (its excess-precision rewrite: fedadam's
``(mean - params).astype(f32)`` is then the exact difference, not the
bf16 one), which depends on what XLA fuses; the port, like the
reference's code as written and its op-by-op run, rounds each bf16
operation. The decay
scale equals the reference's jitted ``_decay_scale(round / T)`` at every
round of every T up to 400. The MOON loss and its gradient match the
reference's. The per-leaf and groupwise ``delta_sgd_update`` and the
plain version of ``fused_delta_sgd_update`` (one client, and a stacked
cohort of 4) match the reference's, whose ``use_pallas`` route runs its
Pallas kernels in interpret mode (under ``jax.vmap`` for the cohort).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import client_opt as r_client_opt
from repro.core import delta_sgd as r_dsgd
from repro.core import get_client_opt as r_copt
from repro.core import get_server_opt as r_sopt
from repro.core import make_loss as r_make_loss
from repro_torch import interop
from repro_torch.core import (CLIENT_OPTS, SERVER_OPTS, DeltaSGDState,
                              delta_sgd_init, delta_sgd_reset,
                              delta_sgd_update, get_client_opt,
                              get_server_opt, make_loss)
from repro_torch.core.client_opt import _decay_scale
from repro_torch.kernels.delta_sgd import delta_sgd as tk
from repro_torch.kernels.delta_sgd import ops as tops
from repro_torch.utils.numerics import round_frac
from repro_torch.utils.tree import tree_leaves, tree_map

DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}
# two top-level groups (the groupwise rule's unit), one of two leaves
SHAPES = {"dense": {"w": (6, 5), "b": (5,)}, "head": (7,)}
STEPS = 3
GW = dict(gamma=2.0, delta=0.1, eta0=0.2)


def _tree(rng, dtype, scale=1.0, lead=()):
    def leaf(shape):
        return (rng.normal(size=lead + shape) * scale).astype(np.float32)
    out = {"dense": {k: leaf(v) for k, v in SHAPES["dense"].items()},
           "head": leaf(SHAPES["head"])}
    return jax.tree.map(lambda a: a.astype(dtype), out)


def _to_t(tree):
    return interop.params_from_numpy(tree)


def _close(got, want, err, rtol=1e-6):
    """Within ``rtol`` of the tensor's largest magnitude (a scalar: of
    its value)."""
    got = np.asarray(np.asarray(got).astype(np.float64))
    want = np.asarray(np.asarray(want).astype(np.float64))
    scale = np.max(np.abs(want)) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * scale, err_msg=err)


def _close_trees(port_tree, ref_tree, err):
    rl = jax.tree_util.tree_leaves(ref_tree)
    pl = tree_leaves(port_tree) if not isinstance(port_tree, tuple) else [
        x for f in port_tree for x in (tree_leaves(f) if f is not None
                                       else [])]
    assert len(pl) == len(rl), (len(pl), len(rl), err)
    for i, (a, b) in enumerate(zip(rl, pl)):
        b = interop.params_to_numpy(b)
        assert np.asarray(a).dtype == b.dtype, (err, i, a.dtype, b.dtype)
        _close(b, a, f"{err} leaf {i}")


def _inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    params = _tree(rng, dtype, 0.5)
    grads = [_tree(rng, dtype, 0.3) for _ in range(STEPS)]
    losses = [np.float32(rng.uniform(0.5, 2.5)) for _ in range(STEPS)]
    return params, grads, losses


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", CLIENT_OPTS)
def test_client_opt_matches_the_reference(name, dtype):
    npdt, _ = DTYPES[dtype]
    params, grads, losses = _inputs(
        2 * CLIENT_OPTS.index(name) + (dtype == "bf16"), npdt)
    kw = {} if name in ("sps", "delta_sgd") else dict(lr=0.05)
    rop, top = r_copt(name, **kw), get_client_opt(name, **kw)
    rf = round_frac(6, 10)               # past 50 %: the (↓) scale is 0.1
    rs = rop.reset(rop.init(jax.tree.map(jnp.asarray, params)),
                   jnp.float32(rf))
    ts = top.reset(top.init(_to_t(params)), torch.tensor(rf))
    rp, tp = jax.tree.map(jnp.asarray, params), _to_t(params)
    rupdate = jax.jit(rop.update) if dtype == "f32" else rop.update
    for k in range(STEPS):
        rp, rs = rupdate(rp, jax.tree.map(jnp.asarray, grads[k]), rs,
                         jnp.asarray(losses[k]))
        tp, ts = top.update(tp, _to_t(grads[k]), ts,
                            torch.tensor(losses[k]))
        _close_trees(tp, jax.device_get(rp), f"{name} step {k} params")
        r_leaves = jax.tree_util.tree_leaves(jax.device_get(rs))
        t_leaves = tree_leaves(ts) if isinstance(ts, dict) else [
            x for f in ts for x in tree_leaves(f)]
        t_leaves = [x for x in t_leaves if x is not None]
        assert len(r_leaves) == len(t_leaves), name
        for a, b in zip(r_leaves, t_leaves):
            b = interop.params_to_numpy(b)
            assert np.asarray(a).dtype == b.dtype, (name, a.dtype, b.dtype)
            _close(b, a, f"{name} step {k} state")


@pytest.mark.parametrize("name", SERVER_OPTS)
def test_server_opt_matches_the_reference_on_bf16_leaves(name):
    rng = np.random.default_rng(11)
    params = _tree(rng, ml_dtypes.bfloat16, 0.5)
    means = [jax.tree.map(lambda p: (p.astype(np.float32) + rng.normal(
        size=p.shape).astype(np.float32) * 0.05).astype(ml_dtypes.bfloat16),
        params) for _ in range(STEPS)]
    rop, top = r_sopt(name), get_server_opt(name)
    rp, tp = jax.tree.map(jnp.asarray, params), _to_t(params)
    rs, ts = rop.init(rp), top.init(tp)
    for k in range(STEPS):
        rp, rs = rop.update(rp, jax.tree.map(jnp.asarray, means[k]), rs)
        tp, ts = top.update(tp, _to_t(means[k]), ts)
        _close_trees(tp, jax.device_get(rp), f"{name} step {k} params")
        for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(rs)),
                        tree_leaves(ts)):
            b = interop.params_to_numpy(b)
            assert np.asarray(a).dtype == b.dtype, (name, a.dtype, b.dtype)
            _close(b, a, f"{name} step {k} state")
    if name in ("fedadam", "fedyogi"):
        assert all(v.dtype == torch.float32 for v in tree_leaves(ts["m"]))


@pytest.mark.parametrize("block", range(4))
def test_decay_scale_equals_the_references_jitted_schedule(block):
    """Every round t = 0..T of every T in this block of 1..400, against
    the reference's jitted round_frac (t / T, which XLA takes as t times
    f32(1/T)) and ``_decay_scale``: 24 (T, t) pairs of 1..400 sit on the
    wrong side of a threshold against the true quotient, and the port
    must too."""
    Ts = range(100 * block + 1, 100 * block + 101)
    rounds = np.arange(401, dtype=np.int32)

    def ref(r):
        # each T a constant in the graph, as num_rounds is in the round
        return jnp.stack([r_client_opt._decay_scale(
            r.astype(jnp.float32) / T) for T in Ts])

    want = np.asarray(jax.jit(ref)(jnp.asarray(rounds)))
    flips = 0
    for i, T in enumerate(Ts):
        got = _decay_scale(torch.tensor(
            [round_frac(t, T) for t in range(T + 1)])).numpy()
        np.testing.assert_array_equal(got, want[i, :T + 1], err_msg=f"T={T}")
        true = _decay_scale(torch.tensor(
            np.arange(T + 1, dtype=np.float32) / np.float32(T))).numpy()
        flips += int((true != got).sum())
    assert flips == {0: 2, 1: 6, 2: 9, 3: 7}[block]   # 24 in all


def test_moon_loss_and_gradient_match_the_reference():
    rng = np.random.default_rng(3)
    w = {"w": rng.normal(size=(8, 6)).astype(np.float32),
         "v": rng.normal(size=(6, 3)).astype(np.float32)}
    glob = jax.tree.map(lambda a: a + rng.normal(size=a.shape).astype(
        np.float32) * 0.1, w)
    prev = jax.tree.map(lambda a: a + rng.normal(size=a.shape).astype(
        np.float32) * 0.1, w)
    batch = {"x": rng.normal(size=(5, 8)).astype(np.float32),
             "y": rng.integers(0, 3, 5).astype(np.int32)}

    def r_base(p, b):
        return jnp.mean(jnp.square(jnp.tanh(b["x"] @ p["w"]) @ p["v"])), {}

    def t_base(p, b):
        return torch.mean(torch.square(torch.tanh(b["x"] @ p["w"])
                                       @ p["v"])), {}

    rl = r_make_loss(r_base, moon_mu=0.7, moon_tau=0.5,
                     repr_fn=lambda p, b: jnp.tanh(b["x"] @ p["w"]))
    tl = make_loss(t_base, moon_mu=0.7, moon_tau=0.5,
                   repr_fn=lambda p, b: torch.tanh(b["x"] @ p["w"]))
    def j(tree):
        return jax.tree.map(jnp.asarray, tree)

    (rv, rm), rg = jax.value_and_grad(rl, has_aux=True)(
        j(w), j(batch), j(glob), j(prev))
    tg, (tv, tm) = torch.func.grad_and_value(tl, has_aux=True)(
        _to_t(w), _to_t(batch), _to_t(glob), _to_t(prev))
    _close(tv.item(), float(rv), "loss", rtol=1e-5)
    _close(tm["moon"].item(), float(rm["moon"]), "moon term", rtol=1e-5)
    _close_trees(tg, jax.device_get(rg), "grad")
    # the global and previous representations carry no gradient
    tg_glob = torch.func.grad(lambda g: tl(_to_t(w), _to_t(batch), g,
                                           _to_t(prev))[0])(_to_t(glob))
    assert all(not x.any() for x in tree_leaves(tg_glob))
    with pytest.raises(ValueError, match="repr_fn"):
        make_loss(t_base, moon_mu=0.5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("groupwise", [False, True])
def test_per_leaf_delta_sgd_matches_the_reference(groupwise, dtype):
    npdt, _ = DTYPES[dtype]
    params, grads, _ = _inputs(5 + groupwise, npdt)
    rs = r_dsgd.delta_sgd_init(jax.tree.map(jnp.asarray, params), eta0=0.2,
                               theta0=1.0, groupwise=groupwise)
    ts = delta_sgd_init(_to_t(params), eta0=0.2, theta0=1.0,
                        groupwise=groupwise)
    rs = r_dsgd.delta_sgd_reset(rs, eta0=0.2, theta0=1.0)
    ts = delta_sgd_reset(ts, eta0=0.2, theta0=1.0)
    rp, tp = jax.tree.map(jnp.asarray, params), _to_t(params)
    rupdate = jax.jit(lambda p, g, s: r_dsgd.delta_sgd_update(p, g, s,
                                                              **GW))
    for k in range(STEPS):
        rp, rs = rupdate(rp, jax.tree.map(jnp.asarray, grads[k]), rs)
        tp, ts = delta_sgd_update(tp, _to_t(grads[k]), ts, **GW)
        _close_trees(tp, jax.device_get(rp), f"step {k} params")
        _close_trees(tuple(ts), tuple(jax.device_get(rs)), f"step {k} state")
    assert int(ts.k) == STEPS
    assert isinstance(ts.eta, dict) == groupwise


@pytest.mark.parametrize("cohort", [None, 4])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_delta_sgd_update_matches_the_references_kernel_route(
        cohort, dtype):
    """The plain version of the kernel route, on one client's tree (the
    reference's C = 1 call) and on a stacked cohort of 4 (``jax.vmap``
    of it), for three steps from a reset state: the first step's η₀ and
    then Eq. (4). Two launches a step, whatever the cohort."""
    npdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(17)
    lead = () if cohort is None else (cohort,)
    params = _tree(rng, npdt, 0.5, lead)
    grads = [_tree(rng, npdt, 0.3, lead) for _ in range(STEPS)]
    one = jax.tree.map(lambda a: a[0], params) if cohort else params
    rs = r_dsgd.delta_sgd_reset(r_dsgd.delta_sgd_init(
        jax.tree.map(jnp.asarray, one), eta0=0.2, theta0=1.0),
        eta0=0.2, theta0=1.0)
    ts = delta_sgd_reset(delta_sgd_init(_to_t(one), eta0=0.2, theta0=1.0),
                         eta0=0.2, theta0=1.0)

    def rstep(p, g, s):
        return r_dsgd.delta_sgd_update(p, g, s, use_pallas=True, **GW)

    if cohort:
        rs = jax.tree.map(lambda x: jnp.broadcast_to(x, (cohort,) + x.shape),
                          rs)
        ts = DeltaSGDState(*(tree_map(
            lambda x: x.expand((cohort,) + tuple(x.shape)), f) for f in ts))
        rstep = jax.vmap(rstep)
    rstep = jax.jit(rstep)
    rp, tp = jax.tree.map(jnp.asarray, params), _to_t(params)
    tk.reset_launch_count()
    for k in range(STEPS):
        rp, rs = rstep(rp, jax.tree.map(jnp.asarray, grads[k]), rs)
        tp, ts = tops.fused_delta_sgd_update(tp, _to_t(grads[k]), ts, **GW)
        _close_trees(tp, jax.device_get(rp), f"step {k} params")
        _close_trees(tuple(ts), tuple(jax.device_get(rs)), f"step {k} state")
    assert dict(tk.LAUNCHES) == {("batched_norms", "cpu"): STEPS,
                                 ("batched_apply", "cpu"): STEPS}
    # delta_sgd_update(use_pallas=True) reaches the same route
    tk.reset_launch_count()
    delta_sgd_update(tp, _to_t(grads[0]), ts, use_pallas=True, **GW)
    assert tk.launch_count() == 2


@pytest.mark.parametrize("name", SERVER_OPTS)
def test_interop_carries_the_server_state_both_ways(name):
    """A reference FLState with its server state (fedavgm's m, fedadam's
    and fedyogi's f32 m, v and t) crosses to the port and back with its
    dtypes and bits; the port's round counter is an int."""
    from repro.core import FLState as RFLState
    from repro.core import init_fl_state as r_init
    rng = np.random.default_rng(13)
    params = jax.tree.map(jnp.asarray, _tree(rng, ml_dtypes.bfloat16, 0.5))
    mean = jax.tree.map(lambda p: (p + 0.01).astype(p.dtype), params)
    rop = r_sopt(name)
    state = r_init(params, rop)
    new, sstate = rop.update(params, mean, state.server_state)
    state = jax.device_get(state._replace(params=new, server_state=sstate,
                                          round=jnp.asarray(3, jnp.int32)))
    port = interop.fl_state_from_numpy(state)
    assert port.round == 3 and isinstance(port.round, int)
    back = RFLState(*interop.fl_state_to_numpy(port))
    assert np.asarray(back.round).dtype == np.int32
    ra, rt = jax.tree_util.tree_flatten(state)
    ba, bt = jax.tree_util.tree_flatten(back)
    assert rt == bt
    for a, b in zip(ra, ba):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    # the port's server optimizer takes the carried state as its own
    tp, ts = get_server_opt(name).update(port.params,
                                         _to_t(jax.device_get(mean)),
                                         port.server_state)
    rp, rs = rop.update(new, mean, sstate)
    _close_trees(tp, jax.device_get(rp), f"{name} carried step")


@pytest.mark.parametrize("groupwise", [False, True])
def test_interop_carries_a_delta_sgd_state(groupwise):
    """Both packages continue from the same per-leaf Δ-SGD state: two
    reference steps, the state carried across, a third step on each."""
    params, grads, _ = _inputs(23 + groupwise, np.float32)
    rs = r_dsgd.delta_sgd_reset(r_dsgd.delta_sgd_init(
        jax.tree.map(jnp.asarray, params), eta0=0.2, theta0=1.0,
        groupwise=groupwise), eta0=0.2, theta0=1.0)
    rp = jax.tree.map(jnp.asarray, params)
    for g in grads[:2]:
        rp, rs = r_dsgd.delta_sgd_update(rp, jax.tree.map(jnp.asarray, g),
                                         rs, **GW)
    ts = interop.delta_sgd_state_from_numpy(jax.device_get(rs))
    back = r_dsgd.DeltaSGDState(*interop.delta_sgd_state_to_numpy(ts))
    for a, b in zip(jax.tree_util.tree_leaves(jax.device_get(rs)),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    tp = _to_t(jax.device_get(rp))
    rp, rs = r_dsgd.delta_sgd_update(rp, jax.tree.map(jnp.asarray, grads[2]),
                                     rs, **GW)
    tp, ts = delta_sgd_update(tp, _to_t(grads[2]), ts, **GW)
    _close_trees(tp, jax.device_get(rp), "carried step params")
    _close_trees(tuple(ts), tuple(jax.device_get(rs)), "carried step state")
