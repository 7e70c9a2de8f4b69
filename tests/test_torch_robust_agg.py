"""Port parity for robust aggregation on the CPU: the trimmed-mean
wrapper (which runs its plain version on CPU tensors) against the
reference's Pallas kernel in interpret mode, at the tolerance of the
reference's conformance cell (``repro/conformance/kernels.py``: rtol
1e-6, atol 1e-7), and ``robust_aggregate`` for mean, clip, trimmed and
median against the reference's, with valid masks and weights. The CUDA
kernel runs only on the card (``tests/test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federation import RobustAgg as RRobustAgg
from repro.federation import robust_aggregate as r_robust_aggregate
from repro.kernels.robust_agg import ref as rref
from repro.kernels.robust_agg import robust_agg as rk
from repro_torch.federation import (ROBUST_AGG_KINDS, RobustAgg,
                                    robust_aggregate)
from repro_torch.kernels.robust_agg import ref as tref
from repro_torch.kernels.robust_agg import robust_agg as tk

N = 256


def _x(C, seed):
    """Normals on a 2^-12 grid: every partial sum of up to 256 of them is
    exact in f32, so the window sum does not depend on the summation
    order and the comparison checks the sort, the window and the final
    division. (The orders differ: XLA's is not PyTorch's or the CUDA
    kernel's, and on unrounded normals the reference's own kernel and
    ref.py differ by 1.3e-7 at C = 50, t = 0, above the atol of 1e-7.)"""
    r = np.random.default_rng(seed)
    x = np.round(np.clip(r.normal(size=(C, N)), -8, 8) * 4096) / 4096
    x = x.astype(np.float32)
    x[:, :16] = np.round(x[:, :16])        # ties across clients
    x[: C // 2, 16:32] = 0.0               # zeroed (invalid) rows
    return x


@pytest.mark.parametrize("C", [1, 2, 3, 7, 10, 16, 50])
def test_trimmed_mean_matches_reference_kernel(C):
    x = _x(C, C)
    tk.reset_launch_count()
    for t in range((C - 1) // 2 + 1):
        got = tk.batched_trimmed_mean(torch.from_numpy(x), t).numpy()
        pal = rk.batched_trimmed_mean(jnp.asarray(x), t, interpret=True)
        np.testing.assert_allclose(got, np.asarray(pal), rtol=1e-6,
                                   atol=1e-7, err_msg=f"t={t}")
        np.testing.assert_allclose(
            got, np.asarray(rref.batched_trimmed_mean_ref(jnp.asarray(x),
                                                          t)),
            rtol=1e-6, atol=1e-7)
    assert tk.LAUNCHES == {("batched_trimmed_mean", "cpu"):
                           (C - 1) // 2 + 1}


def test_trimmed_mean_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(4, N)
    for bad in (lambda: tk.batched_trimmed_mean(x, 2),
                lambda: tk.batched_trimmed_mean(x, -1),
                lambda: tk.batched_trimmed_mean(torch.zeros(4, 100), 0),
                lambda: tk.batched_trimmed_mean(x.double(), 0),
                lambda: tk.batched_trimmed_mean(
                    torch.zeros(tk.MAX_CLIENTS + 1, 128), 0)):
        with pytest.raises((ValueError, TypeError)):
            bad()
    with pytest.raises(ValueError):
        tref.batched_trimmed_mean_ref(x, 2)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ROBUST_AGG_KINDS)
def test_robust_aggregate_matches_reference(kind, weighted):
    C = 10
    r = np.random.default_rng(7)
    x = (r.normal(size=(C, N)) * r.uniform(0.1, 30, (C, 1))
         ).astype(np.float32)
    valid = r.random(C) < 0.7
    w = r.uniform(1, 5, C).astype(np.float32) if weighted else None
    spec = RobustAgg(kind, clip_norm=150.0, trim_frac=0.2)
    rspec = RRobustAgg(kind, clip_norm=150.0, trim_frac=0.2)
    got, info = robust_aggregate(
        torch.from_numpy(x), spec, torch.from_numpy(valid),
        weights=torch.from_numpy(w) if weighted else None)
    want, rinfo = r_robust_aggregate(
        jnp.asarray(x), rspec, jnp.asarray(valid),
        weights=jnp.asarray(w) if weighted else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert set(info) == set(rinfo)
    if kind == "clip":
        assert 0.0 < float(info["agg_clip_rate"]) < 1.0
        np.testing.assert_allclose(float(info["agg_clip_rate"]),
                                   float(rinfo["agg_clip_rate"]), rtol=1e-6)


def test_robust_aggregate_without_valid_mask_and_all_invalid():
    x = np.random.default_rng(8).normal(size=(5, N)).astype(np.float32)
    for kind in ROBUST_AGG_KINDS:
        got, _ = robust_aggregate(torch.from_numpy(x), RobustAgg(kind))
        want, _ = r_robust_aggregate(jnp.asarray(x), RRobustAgg(kind))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        none = torch.zeros(5, dtype=torch.bool)
        got, _ = robust_aggregate(torch.from_numpy(x), RobustAgg(kind),
                                  none)
        assert torch.equal(got, torch.zeros(N))


@pytest.mark.parametrize("C", [1, 2, 5, 10, 11, 50])
def test_trim_counts_and_validation_match_reference(C):
    for kind in ROBUST_AGG_KINDS:
        for frac in (0.0, 0.2, 0.45):
            assert RobustAgg(kind, trim_frac=frac).trim_count(C) == \
                RRobustAgg(kind, trim_frac=frac).trim_count(C)
    for bad, err in ((dict(kind="krum"), KeyError),
                     (dict(trim_frac=0.5), ValueError),
                     (dict(clip_norm=0.0), ValueError)):
        with pytest.raises(err):
            RobustAgg(**bad)
        with pytest.raises(err):
            RRobustAgg(**bad)
