"""The port's correctly rounded square root (``utils.numerics.sqrt``).

XLA's f32 sqrt is correctly rounded, and numpy's is too; torch's CPU
kernel is not on every host (its vectorised path on an AVX-512 CPU is
one ulp off on about a fifth of f32 inputs in [0, 4)). The Δ-SGD rule
and its norms are held bitwise against the reference
(``tests/test_torch_delta_sgd.py``), so they take the root in f64 and
round it once, which is correctly rounded for f32 (53 ≥ 2·24 + 2) on
the CPU and on the card alike.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta_sgd as rd
from repro_torch.core import delta_sgd as td
from repro_torch.utils import numerics

N = 2 ** 16


def _values(kind):
    rng = np.random.default_rng(16)
    if kind == "uniform_0_4":
        return rng.uniform(0.0, 4.0, N).astype(np.float32)
    if kind == "every_exponent":
        # random mantissas over every finite exponent, denormals and 0
        bits = rng.integers(0, 0x7F800000, N, dtype=np.int64)
        return bits.astype(np.uint32).view(np.float32)
    return np.array([0.0, -0.0, np.inf, np.nan, -1.0, 1e-45, 1.0,
                     np.finfo(np.float32).max, np.finfo(np.float32).tiny],
                    np.float32)


@pytest.mark.parametrize("kind", ["uniform_0_4", "every_exponent",
                                  "edges"])
def test_sqrt_is_numpys_bitwise(kind):
    x = _values(kind)
    with np.errstate(invalid="ignore"):
        want = np.sqrt(x)
    got = numerics.sqrt(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    # a NaN's sign is no value (numpy's root of −1 sets it, torch's not)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))


def test_sqrt_is_xlas_bitwise():
    x = _values("uniform_0_4")
    want = np.asarray(jnp.sqrt(jnp.asarray(x)))
    np.testing.assert_array_equal(numerics.sqrt(torch.from_numpy(x)).numpy(),
                                  want)


def test_plain_torch_sqrt_is_what_the_helper_repairs():
    """Where this host's ``torch.sqrt`` misses numpy's bits (on an
    AVX-512 CPU about 12,858 of 2¹⁶ values in [0, 4)), each miss is one
    ulp and the helper's root is numpy's; on a host whose kernel is
    correctly rounded there is no miss to repair."""
    x = _values("uniform_0_4")
    want = np.sqrt(x).view(np.int32).astype(np.int64)
    plain = torch.sqrt(torch.from_numpy(x)).numpy().view(np.int32)
    miss = np.flatnonzero(plain != want)
    assert np.abs(plain[miss].astype(np.int64) - want[miss]).max(
        initial=0) <= 1
    fixed = numerics.sqrt(torch.from_numpy(x[miss])).numpy().view(np.int32)
    np.testing.assert_array_equal(fixed, want[miss])
    print(f"torch.sqrt misses {miss.size} of {N} values on this host "
          f"({torch.backends.cpu.get_cpu_capability()})")


def test_eta_rule_matches_reference_bitwise_on_the_missed_values():
    """Eq. (4)'s sqrt(1 + δ·θ)·η on θ where plain ``torch.sqrt`` would
    miss: η and θ keep the reference's bits."""
    x = _values("uniform_0_4")
    theta = ((x - 1.0) / 0.1).astype(np.float32)      # 1 + 0.1·θ ≈ x
    eta = np.full_like(theta, 0.5)
    dx = np.ones_like(theta)
    dg = np.full_like(theta, 1e-3)                     # cand1 = 500
    want = rd._eta_rule(*map(jnp.asarray, (eta, theta, dx, dg)), 2.0, 0.1)
    got = td._eta_rule(*map(torch.from_numpy, (eta, theta, dx, dg)), 2.0,
                       0.1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
