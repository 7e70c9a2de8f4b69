"""The port's flash-attention wrapper on the CPU (its plain version)
against the reference's ``attention_ref`` and its Pallas kernel in
interpret mode at 64-row tiles, on the same numpy inputs. f32 within
2e-5 and bf16 within 3e-2: the kernel matrix's tolerances
(``repro/conformance/kernels.py``). The CUDA kernel itself is held
against the same plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import (
    flash_attention as jflash)
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ref as faref

# (B, S, H, KV, hd, window): GQA ratios 1/2/4/8, head dims 64 and 112,
# S = 1, 50 (< one tile), 64 (one tile) and 130 (ragged), with windows
CASES = [(1, 1, 4, 4, 64, None), (2, 50, 4, 2, 64, None),
         (1, 64, 8, 2, 112, None), (1, 130, 8, 1, 64, None),
         (1, 130, 4, 2, 112, 32), (2, 64, 8, 8, 64, 16),
         (1, 50, 8, 1, 112, 7), (1, 130, 4, 4, 112, None)]


def _inputs(B, S, H, KV, hd, seed=0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, S, H, hd)).astype(np.float32),
            r.normal(size=(B, S, KV, hd)).astype(np.float32),
            r.normal(size=(B, S, KV, hd)).astype(np.float32))


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_version_matches_reference_and_its_kernel_f32(case):
    B, S, H, KV, hd, window = case
    q, k, v = _inputs(B, S, H, KV, hd)
    fa.reset_launch_count()
    got = fa.flash_attention(*(_torch(a, torch.float32) for a in (q, k, v)),
                             causal=True, window=window).numpy()
    assert fa.LAUNCHES == {("flash_attention", "cpu"): 1}
    want = np.asarray(jref(q, k, v, causal=True, window=window))
    kern = np.asarray(jflash(q, k, v, causal=True, window=window,
                             block_q=64, block_k=64, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, kern, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", CASES[1::2], ids=str)
def test_plain_version_matches_reference_bf16(case):
    B, S, H, KV, hd, window = case
    q, k, v = _inputs(B, S, H, KV, hd, seed=1)
    got = fa.flash_attention(*(_torch(a, torch.bfloat16)
                               for a in (q, k, v)),
                             causal=True, window=window)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jref(jq, jk, jv, causal=True, window=window),
                      np.float32)
    kern = np.asarray(jflash(jq, jk, jv, causal=True, window=window,
                             block_q=64, block_k=64, interpret=True),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)
    np.testing.assert_allclose(got.float().numpy(), kern, rtol=3e-2,
                               atol=3e-2)


def test_bidirectional_attention_matches_reference():
    q, k, v = _inputs(1, 64, 4, 2, 64, seed=2)
    for window in (None, 20):
        got = fa.flash_attention(*(_torch(a, torch.float32)
                                   for a in (q, k, v)),
                                 causal=False, window=window).numpy()
        want = np.asarray(jref(q, k, v, causal=False, window=window))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_masked_scores_are_minus_1e30_not_inf():
    """A row whose only visible key is itself attends to it alone: the
    −1e30 masking leaves no NaN even with a window of one."""
    q, k, v = _inputs(1, 70, 2, 1, 64, seed=3)
    got = fa.flash_attention(*(_torch(a, torch.float32) for a in (q, k, v)),
                             causal=True, window=1).numpy()
    want = np.repeat(v, 2, axis=2)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = (_torch(a, torch.float32) for a in _inputs(1, 70, 4, 2, 64))
    with pytest.raises(RuntimeError, match="backward"):
        fa.flash_attention(q.clone().requires_grad_(), k, v)
    # the reference's error: bidirectional keys that need padding to its
    # 128-key tiles
    q2, k2, v2 = (_torch(a, torch.float32) for a in _inputs(1, 130, 4, 2, 64))
    with pytest.raises(ValueError, match="non-causal padding"):
        fa.flash_attention(q2, k2, v2, causal=False)
    with pytest.raises(ValueError, match="at least as many keys"):
        fa.flash_attention(q, k[:, :60].contiguous(), v[:, :60].contiguous())
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, window=0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), v)
    strided = torch.zeros(1, 70, 4, 128)[..., ::2]      # (1, 70, 4, 64)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(strided, k, v)


def test_plain_version_blocks_rows_like_one_block():
    """The plain version takes queries in blocks of BLOCK_Q rows; across
    a block edge it equals one whole block."""
    q, k, v = (_torch(a, torch.float32)
               for a in _inputs(1, faref.BLOCK_Q + 9, 2, 1, 64, seed=4))
    got = faref.attention_ref(q, k, v, window=40)
    whole = faref.BLOCK_Q
    try:
        faref.BLOCK_Q = 10 ** 6
        want = faref.attention_ref(q, k, v, window=40)
    finally:
        faref.BLOCK_Q = whole
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------- the CUDA kernels' q tiles
@pytest.mark.parametrize("shape,sms,rows", [
    ((1, 64, 32), 132, 16),        # TinyLlama / Zamba2 prefill: 128 blocks
    ((1, 2048, 32), 132, 64),      # a long prefill fills the card at 64
    ((1, 200, 32), 132, 32),       # 7 tiles of 32 rows x 32 heads
    ((4, 64, 32), 132, 32),        # 4 requests: 128 blocks at 64 rows
    ((5, 64, 32), 132, 64),        # 5 requests: 160 blocks at 64 rows
    ((1, 64, 32), 32, 64),         # a card of 32 SMs
    ((1, 1, 4), 132, 16)])         # nothing fills it: the smallest tile
def test_q_tile_rows_fill_the_card(shape, sms, rows):
    assert fa.q_tile_rows(*shape, sms, torch.float32) == rows


@pytest.mark.parametrize("shape,sms", [((1, 64, 32), 132), ((1, 2048, 32), 132),
                                       ((4, 64, 32), 132), ((1, 1, 4), 132)])
def test_q_tile_rows_bf16_keeps_64_rows(shape, sms):
    """The bf16 kernel is built for 64-row tiles alone: 16 and 32 rows
    measured no faster at either serve prefill shape."""
    assert fa.q_tile_rows(*shape, sms, torch.bfloat16) == 64


# --------------------------- the bf16 kernel's arithmetic, emulated here
def _emulate_bf16_kernel(q, k, v, *, causal, window, split=True):
    """The bf16 tensor-core kernel's arithmetic on the CPU: exact bf16
    products summed in f32 (a bf16 x bf16 product is exact in f32), the
    scale on the f32 scores after the product, -1e30 masking, an online
    softmax over 64-key tiles in f32, and P·V with P split as
    P_hi = bf16(P), P_lo = bf16(P - P_hi) (``split``) or P rounded once
    to bf16 (SDPA's way). Returns the f32 output before its rounding."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().permute(0, 2, 1, 3)                        # (B,H,S,hd)
    kf = k.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    scale = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)
    rows = torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    for k0 in range(0, T, 64):
        cols = torch.arange(k0, min(k0 + 64, T))[None, :]
        s = (qf @ kf[:, :, k0:k0 + 64].transpose(-1, -2)) * scale
        ok = torch.ones((S, cols.shape[1]), dtype=torch.bool)
        if causal:
            ok &= cols <= rows
        if window is not None:
            ok &= rows - cols < window
        s = torch.where(ok, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        vt = vf[:, :, k0:k0 + 64]
        pv = hi @ vt
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vt
        acc = alpha * acc + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).permute(0, 2, 1, 3)


# the kernel matrix's bf16 flash cells (repro/conformance/kernels.py) and
# the serve paths' head dims: (B, S, H, KV, hd, causal, window)
BF16_CASES = [(1, 64, 2, 2, 16, True, 16), (1, 128, 4, 1, 64, True, None),
              (2, 128, 4, 4, 32, False, None), (1, 64, 8, 2, 64, True, None),
              (1, 130, 4, 2, 112, True, None), (1, 64, 4, 4, 112, True, 20)]


@pytest.mark.parametrize("case", BF16_CASES, ids=str)
def test_bf16_kernel_arithmetic_matches_reference(case):
    """The emulated bf16 kernel against the reference's attention_ref and
    its Pallas kernel in interpret mode (bf16, within 3e-2) and the port's
    plain version; with P split into hi + lo it stays far closer to the
    exact f32 attention of the same bf16 inputs than P rounded once."""
    B, S, H, KV, hd, causal, window = case
    q, k, v = (a.astype(jnp.bfloat16).astype(np.float32)
               for a in _inputs(B, S, H, KV, hd, seed=11))
    tq, tk, tv = (_torch(a, torch.bfloat16) for a in (q, k, v))
    got = _emulate_bf16_kernel(tq, tk, tv, causal=causal, window=window)
    once = _emulate_bf16_kernel(tq, tk, tv, causal=causal, window=window,
                                split=False)
    out = got.bfloat16().float().numpy()
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    for want in (jref(jq, jk, jv, causal=causal, window=window),
                 jflash(jq, jk, jv, causal=causal, window=window,
                        block_q=64, block_k=64, interpret=True)):
        np.testing.assert_allclose(out, np.asarray(want, np.float32),
                                   rtol=3e-2, atol=3e-2)
    plain = faref.attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(out, plain.float().numpy(), rtol=3e-2,
                               atol=3e-2)
    exact = np.asarray(jref(q, k, v, causal=causal, window=window))
    err_split = float(np.abs(got.numpy() - exact).max())
    err_once = float(np.abs(once.numpy() - exact).max())
    print(f"{case}: max |out - exact f32| with P split {err_split:.3g}, "
          f"P rounded once {err_once:.3g}")
    assert err_split < 1e-4 < err_once
