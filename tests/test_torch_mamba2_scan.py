"""The port's SSD chunk wrapper and ``ssd_scan`` on the CPU (the plain
version) against the reference's interpret-mode ``ssd_chunks``, its
``ops.ssd_scan`` and the naive recurrence ``ssd_ref``, on the same numpy
inputs. Tolerance rtol 1e-3 / atol 1e-4, the kernel matrix's
(``repro/conformance/kernels.py``). S covers one chunk (64), L = 48
(96), two chunks (128) and L = 1 (67, prime)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_scan.mamba2_scan import ssd_chunks as jchunks
from repro.kernels.mamba2_scan.ops import ssd_scan as jscan
from repro.kernels.mamba2_scan.ref import ssd_ref
from repro_torch.kernels.mamba2_scan import mamba2_scan as m2
from repro_torch.kernels.mamba2_scan.ops import chunk_len, ssd_scan

TOL = dict(rtol=1e-3, atol=1e-4)
SEQS = [64, 96, 128, 67]


def _inputs(B, S, H, P, G, N, seed=0):
    r = np.random.default_rng(seed)
    f = np.float32
    return (r.normal(size=(B, S, H, P)).astype(f),
            r.uniform(0.001, 0.1, (B, S, H)).astype(f),
            np.log(r.uniform(1, 16, (H,))).astype(f),
            r.normal(size=(B, S, G, N)).astype(f),
            r.normal(size=(B, S, G, N)).astype(f))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_chunk_length_rule_is_the_references():
    assert [chunk_len(S) for S in (64, 96, 128, 67, 1, 32, 100)] == [
        64, 48, 64, 1, 1, 32, 50]


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("S", SEQS)
def test_chunks_match_the_reference_kernel(S, G):
    B, H, P, N = 2, 4, 16, 8
    x, dt, A_log, Bm, Cm = _inputs(B, S, H, P, G, N, seed=S)
    dA = dt * -np.exp(A_log)
    L = chunk_len(S)
    m2.reset_launch_count()
    got = m2.ssd_chunks(*_t(x, dt, dA, Bm, Cm), chunk=L)
    assert m2.LAUNCHES == {("ssd_chunks", "cpu"): 1}
    rep = H // G
    want = jchunks(x, dt, dA, jnp.repeat(Bm, rep, axis=2),
                   jnp.repeat(Cm, rep, axis=2), chunk=L, interpret=True)
    for name, a, b in zip(("y", "S_c", "chunk_decay", "exp_cs"), got, want):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("S", SEQS)
def test_scan_matches_reference_scan_and_recurrence(S):
    B, H, P, G, N = 2, 6, 16, 2, 8
    x, dt, A_log, Bm, Cm = _inputs(B, S, H, P, G, N, seed=10 + S)
    y, h = ssd_scan(*_t(x, dt, A_log, Bm, Cm))
    assert y.dtype == torch.float32 and h.shape == (B, H, P, N)
    for yr, hr in (jscan(x, dt, A_log, Bm, Cm), ssd_ref(x, dt, A_log, Bm,
                                                        Cm)):
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(hr), **TOL)


def test_scan_carries_an_initial_state():
    B, S, H, P, G, N = 1, 96, 4, 16, 1, 8
    x, dt, A_log, Bm, Cm = _inputs(B, S, H, P, G, N, seed=3)
    h0 = np.random.default_rng(4).normal(size=(B, H, P, N)).astype(
        np.float32)
    y, h = ssd_scan(*_t(x, dt, A_log, Bm, Cm), h0=torch.from_numpy(h0))
    yr, hr = ssd_ref(x, dt, A_log, Bm, Cm, h0=h0)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), **TOL)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, dt, A_log, Bm, Cm = _t(*_inputs(1, 64, 4, 8, 1, 4))
    dA = (dt * -torch.exp(A_log)).contiguous()
    with pytest.raises(RuntimeError, match="backward"):
        m2.ssd_chunks(x.clone().requires_grad_(), dt, dA, Bm, Cm)
    with pytest.raises(ValueError, match="not divisible"):
        m2.ssd_chunks(x, dt, dA, Bm, Cm, chunk=5)
    with pytest.raises(ValueError, match="group"):
        m2.ssd_chunks(x[:, :, :3].contiguous(), dt[:, :, :3].contiguous(),
                      dA[:, :, :3].contiguous(), Bm.repeat(1, 1, 2, 1), Cm
                      .repeat(1, 1, 2, 1))
    with pytest.raises(TypeError, match="float32"):
        m2.ssd_chunks(x.double(), dt, dA, Bm, Cm)
    strided = torch.zeros(1, 64, 1, 8)[..., ::2]       # (1, 64, 1, 4)
    with pytest.raises(ValueError, match="contiguous"):
        m2.ssd_chunks(x, dt, dA, strided, Cm)
