"""Port parity for delta compression on the CPU: the wrappers of
``repro_torch.kernels.compress`` (which run their plain versions on CPU
tensors) against the reference's Pallas kernels in interpret mode and its
``ref.py``, bitwise; ``CompressionSpec`` wire accounting; and
``compress_flat`` with and without bandwidth levels against the
reference's ``compress_flat(backend="xla")``. The CUDA kernels run only
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compression import CompressionSpec as RSpec
from repro.compression import compress_flat as r_compress_flat
from repro.compression import get_compression as r_get
from repro.kernels.compress import compress as rk
from repro.kernels.compress import ref as rref
from repro_torch.compression import (KINDS, LEVELS, CompressionSpec,
                                     compress_flat, get_compression)
from repro_torch.kernels.compress import compress as tk

SHAPES = [(3, 256), (2, 1024 * 128), (10, 71808)]


def _inputs(C, N, seed):
    """Mixed per-chunk scales, a zero chunk, a constant chunk, ties."""
    r = np.random.default_rng(seed)
    scale = np.exp(r.normal(size=(C, N // 128, 1)) * 3).repeat(128, axis=2)
    x = (r.normal(size=(C, N)) * scale.reshape(C, N)).astype(np.float32)
    x[:, :128] = 0.0
    x[:, 128:256] = -0.75
    if N > 256:
        x[:, 256:384] = np.round(x[:, 256:384] * 2) / 2
    return x


def _bits(a):
    return np.asarray(a).view(np.uint8 if np.asarray(a).itemsize == 1
                              else np.uint32)


@pytest.mark.parametrize("C,N", SHAPES)
def test_quantize_dequantize_bitwise(C, N):
    x = _inputs(C, N, 1)
    q, s = tk.quantize_int8(torch.from_numpy(x))
    out = tk.dequantize_int8(q, s)
    rq, rs = rref.quantize_int8_ref(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(rs))
    np.testing.assert_array_equal(
        _bits(out.numpy()), _bits(rref.dequantize_int8_ref(rq, rs)))
    if C * N <= 2 ** 18:   # interpret mode is slow at the paper width
        # The reference's kernel in interpret mode agrees with its own
        # ref.py on q, but at a 1024-row block XLA computes absmax/127 as
        # absmax·(1/127): one ulp off the true division in 74 of the 2048
        # scales at (2, 131072). The port follows ref.py (and the kernel
        # source's division), so its scales are held to 1 ulp here and
        # bitwise against ref.py above; the interpret-mode dequantize of
        # the port's own (q, s) is bitwise the port's reconstruction.
        pq, ps = rk.quantize_int8(jnp.asarray(x), interpret=True)
        np.testing.assert_array_equal(q.numpy(), np.asarray(pq))
        np.testing.assert_array_max_ulp(s.numpy(), np.asarray(ps), 1)
        np.testing.assert_array_equal(
            _bits(out.numpy()),
            _bits(rk.dequantize_int8(jnp.asarray(q.numpy()),
                                     jnp.asarray(s.numpy()),
                                     interpret=True)))


def test_quantize_rounds_half_to_even_with_true_divisions():
    """Chunk absmax 127 makes inv exactly 1, so x·inv hits the .5 ties;
    an absmax that is not a power of two checks the true divisions."""
    x = np.zeros((1, 256), np.float32)
    x[0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    x[0, 128:131] = [3.0, 1.0, -2.9]
    q, s = tk.quantize_int8(torch.from_numpy(x))
    assert q[0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]
    rq, rs = rref.quantize_int8_ref(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(rs))
    assert s[0, 1].item() == np.float32(3.0) / np.float32(127.0)


@pytest.mark.parametrize("k", [1, 32, 128])
@pytest.mark.parametrize("C,N", SHAPES)
def test_topk_exact_with_ties_and_constant_chunks(C, N, k):
    x = _inputs(C, N, 2)
    got = tk.topk_mask(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(
        _bits(got), _bits(rref.topk_mask_ref(jnp.asarray(x), k)))
    kept = (got.reshape(C, -1, 128) != 0).sum(-1)
    assert (kept[:, 1] == k).all()        # the constant chunk keeps k
    np.testing.assert_array_equal(got[:, 128:128 + k], x[:, 128:128 + k])
    if C * N <= 2 ** 18:
        np.testing.assert_array_equal(
            _bits(got), _bits(rk.topk_mask(jnp.asarray(x), k,
                                           interpret=True)))


def test_wrappers_count_launches_and_reject_bad_input():
    tk.reset_launch_count()
    x = torch.zeros(2, 256)
    tk.dequantize_int8(*tk.quantize_int8(x))
    tk.topk_mask(x, 5)
    assert tk.LAUNCHES == {("quantize_int8", "cpu"): 1,
                           ("dequantize_int8", "cpu"): 1,
                           ("topk_mask", "cpu"): 1}
    assert tk.launch_count("cuda") == 0
    for bad in (lambda: tk.topk_mask(x, 0), lambda: tk.topk_mask(x, 129),
                lambda: tk.quantize_int8(torch.zeros(2, 200)),
                lambda: tk.quantize_int8(x.double()),
                lambda: tk.dequantize_int8(torch.zeros(2, 256,
                                                       dtype=torch.int8),
                                           torch.zeros(2, 3)),
                lambda: tk.quantize_int8(torch.zeros(256, 2).t())):
        with pytest.raises((ValueError, TypeError)):
            bad()


@pytest.mark.parametrize("n", [1, 127, 128, 6922, 71754])
@pytest.mark.parametrize("k_frac", [0.25, 0.01, 1.0])
def test_wire_accounting_matches_reference(n, k_frac):
    spec, rspec = CompressionSpec("topk", k_frac), RSpec("topk", k_frac)
    assert spec.k == rspec.k
    np.testing.assert_array_equal(spec.level_wire_bytes(n),
                                  rspec.level_wire_bytes(n))
    levels = np.array([0, 2, 1, 1, 0], np.int32)
    np.testing.assert_array_equal(
        spec.wire_bytes(n, levels=torch.from_numpy(levels)).numpy(),
        np.asarray(rspec.wire_bytes(n, levels=jnp.asarray(levels))))
    for kind in KINDS:
        s, r = CompressionSpec(kind, k_frac), RSpec(kind, k_frac)
        np.testing.assert_array_equal(
            s.wire_bytes(n, num_clients=3).numpy(),
            np.asarray(r.wire_bytes(n, num_clients=3)))


def test_spec_fields_and_validation_match_reference():
    assert KINDS == LEVELS == ("none", "int8", "topk")
    for kind in KINDS:
        for ef in (False, True):
            s, r = CompressionSpec(kind, 0.5, ef), RSpec(kind, 0.5, ef)
            assert (s.k, s.level, s.active(), s.active(None)) == \
                (r.k, r.level, r.active(), r.active(None))
    assert get_compression(None) == CompressionSpec()
    assert get_compression("int8", k_frac=0.5).k == r_get("int8",
                                                          k_frac=0.5).k
    spec = CompressionSpec("int8")
    assert get_compression(spec) is spec
    for bad, err in ((dict(kind="fp8"), KeyError),
                     (dict(k_frac=0.0), ValueError),
                     (dict(k_frac=1.5), ValueError)):
        with pytest.raises(err):
            CompressionSpec(**bad)
        with pytest.raises(err):
            RSpec(**bad)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_levels", [False, True])
def test_compress_flat_matches_reference(kind, with_levels):
    C, N = 5, 1024 * 128 // 4
    x = _inputs(C, N, 3)
    levels = np.array([0, 1, 2, 2, 1], np.int32) if with_levels else None
    spec, rspec = CompressionSpec(kind, 0.1), RSpec(kind, 0.1)
    tk.reset_launch_count()
    got = compress_flat(torch.from_numpy(x), spec,
                        levels=(torch.from_numpy(levels) if with_levels
                                else None)).numpy()
    want = r_compress_flat(jnp.asarray(x), rspec,
                           levels=jnp.asarray(levels) if with_levels
                           else None, backend="xla")
    np.testing.assert_array_equal(_bits(got), _bits(want))
    want_launches = (3 if with_levels
                     else {"none": 0, "int8": 2, "topk": 1}[kind])
    assert tk.launch_count() == want_launches
