"""Port parity for the flat Δ-SGD engine: ``repro_torch.core.delta_sgd
.flat_delta_sgd_step`` against the reference's ``backend="xla"`` step on
the same numpy inputs, one step and a K-step loop, with NaN lanes and
heterogeneous ``active`` masks: ≤ 1e-5 on params and step state, and
equal η-clamp counts and ``valid`` latches."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta_sgd as rd
from repro.core import flat as rflat
from repro_torch.core import delta_sgd as td
from repro_torch.core import flat as tflat
from repro_torch.kernels.delta_sgd import delta_sgd as tk

HYPER = dict(gamma=2.0, delta=0.1, eta0=0.2)


def _layouts(n, bf16=False):
    dt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                      torch.float32)
    r = rflat.layout_of({"a": jnp.zeros((n - 5,), jnp.float32),
                         "b": jnp.zeros((5,), dt[0])})
    t = tflat.layout_of({"a": torch.zeros(n - 5),
                         "b": torch.zeros(5, dtype=dt[1])})
    assert r.padded_size == t.padded_size
    return r, t


def _compare(rP, rS, tP, tS):
    np.testing.assert_allclose(tP.numpy(), np.asarray(rP), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tS.prev_grads.numpy(),
                               np.asarray(rS.prev_grads), rtol=1e-5)
    for f in ("eta", "theta", "prev_grad_norm"):
        np.testing.assert_allclose(getattr(tS, f).numpy(),
                                   np.asarray(getattr(rS, f)), rtol=1e-5,
                                   err_msg=f)
    np.testing.assert_array_equal(tS.valid.numpy(), np.asarray(rS.valid))
    np.testing.assert_array_equal(tS.clips.numpy(), np.asarray(rS.clips))
    assert tS.k == int(rS.k)


def _run(C, n, K, seed, *, nan_lane=None, k_budget=None, bf16=False,
         tiny_dg=False, eta0=0.2):
    rng = np.random.default_rng(seed)
    rl, tl = _layouts(n, bf16)
    N = rl.padded_size
    P0 = np.zeros((C, N), np.float32)
    P0[:, :n] = rng.normal(size=(C, n))
    if bf16:
        P0 = np.asarray(jnp.asarray(P0).astype(jnp.bfloat16)
                        .astype(jnp.float32))
    rmask = rflat.round_mask(rl)
    tmask = tflat.round_mask(tl)
    hyper = dict(HYPER, eta0=eta0)
    rS = rd.flat_delta_sgd_init(C, rl, eta0=eta0, theta0=1.0)
    tS = td.flat_delta_sgd_init(C, tl, eta0=eta0, theta0=1.0)
    rP, tP = jnp.asarray(P0), torch.from_numpy(P0.copy())
    base = rng.normal(size=(C, N)).astype(np.float32)
    for k in range(K):
        G = np.zeros((C, N), np.float32)
        if tiny_dg:   # ‖Δg‖ ≈ 0: cand1 stays far above ETA_CLAMP
            G[:, :n] = base[:, :n] * (1.0 + 1e-7 * k)
        else:
            G[:, :n] = rng.normal(size=(C, n))
        if nan_lane is not None and k >= 1:
            G[nan_lane, 3] = np.nan
        active = None if k_budget is None else k < k_budget
        rP, rS = rd.flat_delta_sgd_step(
            rP, jnp.asarray(G), rS, mask=rmask, backend="xla",
            active=None if active is None else jnp.asarray(active),
            **hyper)
        tP, tS = td.flat_delta_sgd_step(
            tP, torch.from_numpy(G), tS, mask=tmask,
            active=None if active is None else torch.from_numpy(active),
            **hyper)
        _compare(rP, rS, tP, tS)
    return tS


def test_one_step_matches_reference():
    _run(4, 300, 1, 0)


def test_k_step_loop_matches_reference():
    _run(5, 1000, 6, 1)


def test_nan_lane_latches_invalid_and_is_sanitised():
    S = _run(4, 300, 4, 2, nan_lane=1)
    assert S.valid.tolist() == [True, False, True, True]
    assert torch.all(S.prev_grads[1] == 0)


def test_heterogeneous_active_masks_freeze_lanes():
    _run(4, 300, 5, 3, k_budget=np.array([5, 3, 1, 2]))


def test_nan_lane_with_budgets_and_bf16_leaves():
    _run(4, 300, 4, 4, nan_lane=2, k_budget=np.array([4, 2, 3, 1]),
         bf16=True)


def test_eta_clamp_counts_match_reference():
    # η₀ above the ceiling clips the first step; after it cand2 =
    # sqrt(1 + δθ)·ETA_CLAMP keeps η above the ceiling
    S = _run(3, 300, 4, 5, tiny_dg=True, eta0=5e3,
             k_budget=np.array([4, 2, 3]))
    assert S.clips.tolist() == [4, 2, 3]


def test_step_makes_exactly_two_launches():
    tk.reset_launch_count()
    _run(3, 300, 4, 6)
    assert tk.LAUNCHES[("batched_norms", "cpu")] == 4
    assert tk.LAUNCHES[("batched_apply", "cpu")] == 4
    assert tk.launch_count() == 8


@pytest.mark.parametrize("field", ["eta", "theta"])
def test_eta_rule_matches_reference_bitwise(field):
    """Eq. (4) itself is elementwise f32 math: bitwise equal on the CPU."""
    r = np.random.default_rng(7)
    args = [r.uniform(0.0, 2.0, 64).astype(np.float32) for _ in range(4)]
    args[3][::5] = 0.0   # dg_norm = 0 takes the inf branch
    want = rd._eta_rule(*map(jnp.asarray, args), 2.0, 0.1)
    got = td._eta_rule(*map(torch.from_numpy, args), 2.0, 0.1)
    i = 0 if field == "eta" else 1
    np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
