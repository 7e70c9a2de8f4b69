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
