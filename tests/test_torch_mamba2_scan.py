"""The port's SSD chunk wrapper and ``ssd_scan`` on the CPU (the plain
version) against the reference's interpret-mode ``ssd_chunks``, its
``ops.ssd_scan`` and the naive recurrence ``ssd_ref``, on the same numpy
inputs. Tolerance rtol 1e-3 / atol 1e-4, the kernel matrix's
(``repro/conformance/kernels.py``). S covers one chunk (64), L = 48
(96), two chunks (128) and L = 1 (67, prime).

The CUDA kernel's arithmetic is emulated here too: its three products
run on TF32 tensor cores with each f32 operand split into a TF32 hi and
lo part (3xTF32). The emulation rounds hi to TF32 as ``cvt.rna`` does,
by bit operations, and reads lo as the tensor core does (the low 13
bits dropped); it is held against the reference, the plain version and
an f64 computation, and a single TF32 pass is shown to miss what the
split keeps. The kernel's grid rule is checked at the Zamba2 shapes."""
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


def _tf32(a):
    """f32 -> TF32 as ``cvt.rna.tf32.f32``: 10 mantissa bits, nearest,
    ties away from zero (the magnitude bits are rounded up at half)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_read(a):
    """The TF32 part of f32 bits as the tensor core reads it: the low 13
    mantissa bits dropped."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the kernel takes it: hi = tf32(a), lo = a − hi read as
    TF32, the products lo·hi + hi·lo + hi·hi summed in f32 (TF32
    products of f32 operands are exact in f32)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32_read(a - ah), _tf32_read(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_tf32(a, b):
    """One TF32 pass: what the tensor cores give without the split."""
    return _tf32(a) @ _tf32(b)


def _chunks_by(x, dt, dA, Bm, Cm, L, mm, dtype=torch.float32):
    """The kernel's outputs y (B,S,H,P) and S_c (B,nc,H,P,N) with its
    three products taken by ``mm``: M = C·Bᵀ ⊙ decay ⊙ dt, y = M·x,
    S_c = (x ⊙ w)ᵀ·B; the cumulative sum serial in ``dtype``."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep, nc = H // G, S // L

    def rs(t):
        return t.to(dtype).reshape(B, nc, L, *t.shape[2:])

    xc, dtc, dAc, Bc, Cc = map(rs, (x, dt, dA, Bm, Cm))
    cs = torch.empty_like(dAc)
    acc = torch.zeros_like(dAc[:, :, 0])
    for q in range(L):
        acc = acc + dAc[:, :, q]
        cs[:, :, q] = acc
    Bh = Bc.repeat_interleave(rep, 3).transpose(2, 3)        # (B,nc,H,L,N)
    Ch = Cc.repeat_interleave(rep, 3).transpose(2, 3)
    csh, dth = cs.transpose(2, 3), dtc.transpose(2, 3)       # (B,nc,H,L)
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool))
    decay = torch.where(tril, torch.exp(csh[..., :, None] - csh[..., None, :]),
                        0.0)
    M = mm(Ch, Bh.transpose(-1, -2)) * decay * dth[..., None, :]
    xh = xc.transpose(2, 3)                                   # (B,nc,H,L,P)
    y = mm(M, xh).transpose(2, 3).reshape(B, S, H, P)
    w = torch.exp(csh[..., -1:] - csh) * dth
    S_c = mm((xh * w[..., None]).transpose(-1, -2), Bh)       # (B,nc,H,P,N)
    return y, S_c


def test_tf32_rounding_is_nearest_ties_away():
    one_ulp = 2.0 ** -10                       # TF32's ulp at 1
    a = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2),
                      1 + one_ulp / 2 - 2.0 ** -23, 1 + 3 * one_ulp / 2,
                      0.0, -0.0])
    want = torch.tensor([1 + one_ulp, -(1 + one_ulp), 1.0, 1 + 2 * one_ulp,
                         0.0, -0.0])
    assert torch.equal(_tf32(a).view(torch.int32), want.view(torch.int32))
    v = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(
        np.float32))
    hi = _tf32(v)
    lo = _tf32_read(v - hi)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32_read(lo), lo)
    assert float(((hi + lo - v).abs() / v.abs()).max()) <= 2.0 ** -20


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("S", SEQS)
def test_3xtf32_products_match_the_reference_kernel(S, G):
    """The emulated kernel (L = 64, 48, 1) against the reference's Pallas
    kernel in interpret mode and the port's plain version."""
    B, H, P, N = 2, 4, 16, 8
    x, dt, A_log, Bm, Cm = _inputs(B, S, H, P, G, N, seed=S)
    dA = dt * -np.exp(A_log)
    L = chunk_len(S)
    y, S_c = _chunks_by(*_t(x, dt, dA, Bm, Cm), L, _mm_3xtf32)
    rep = H // G
    want = jchunks(x, dt, dA, jnp.repeat(Bm, rep, axis=2),
                   jnp.repeat(Cm, rep, axis=2), chunk=L, interpret=True)
    plain = m2.ssd_chunks(*_t(x, dt, dA, Bm, Cm), chunk=L)
    for name, a, b, c in zip(("y", "S_c"), (y, S_c), want, plain):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)
        np.testing.assert_allclose(a.numpy(), c.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("S", SEQS)
def test_3xtf32_keeps_f32_accuracy_and_one_pass_does_not(S, G):
    """Against an f64 computation of the same outputs: the split lands
    within 1e-5 of max|out|, a single TF32 pass beyond 1e-4."""
    B, H, P, N = 2, 4, 32, 16
    x, dt, A_log, Bm, Cm = _inputs(B, S, H, P, G, N, seed=20 + S)
    dA = dt * -np.exp(A_log)
    L = chunk_len(S)
    args = _t(x, dt, dA, Bm, Cm)
    exact = _chunks_by(*args, L, torch.matmul, torch.float64)

    def worst(outs):
        return max(float((a.double() - b).abs().max() / b.abs().max())
                   for a, b in zip(outs, exact))

    assert worst(_chunks_by(*args, L, _mm_3xtf32)) <= 1e-5
    assert worst(_chunks_by(*args, L, _mm_tf32)) > 1e-4


@pytest.mark.parametrize("shape,want", [
    ((1, 64, 112, 64, 64), (1, 1, True)),      # Zamba2 prefill: 112 blocks
    ((1, 2048, 112, 64, 64), (1, 1, False)),   # 3,584 blocks
    ((1, 96, 112, 64, 48), (1, 1, False)),     # 224 blocks
    ((1, 67, 112, 64, 1), (32, 1, False)),     # L = 1: 32 chunks a block
    ((1, 2048, 112, 128, 64), (1, 2, False)),  # P = 128: two slices
    ((1, 64, 2, 64, 64), (1, 1, True)),        # a few blocks: no slicing
    ((1, 64, 66, 128, 64), (1, 2, True)),      # 132 blocks just fit
    ((1, 64, 67, 128, 64), (1, 2, False)),     # 134 do not
    ((1, 335, 3, 18, 5), (6, 1, True)),        # 6 chunks a block, 36 blocks
])
def test_grid_rule_at_132_sms(shape, want):
    """``ssd_grid`` on 132 SMs: chunks shorter than PACK_ROWS share a
    block, up to CHUNK rows; P takes the fewest slices of at most
    MAX_SLICE columns (slicing it to fill the SMs was measured slower);
    blocks take two warp groups when every block has an SM of its own."""
    B, S, H, P, L = shape
    cpb, split, two = m2.ssd_grid(B, S, H, P, L, 132)
    assert (cpb, split, two) == want
    assert cpb * L <= m2.CHUNK and -(-P // split) <= m2.MAX_SLICE
    assert two == (B * H * -(-(S // L) // cpb) * split <= 132)
