"""Port parity for the Δ-SGD kernel pair on the CPU: the wrappers of
``repro_torch.kernels.delta_sgd`` (which run the plain PyTorch version on
a CPU tensor) against the reference's jnp versions (``ref.py``) and its
Pallas kernels in interpret mode, at the tolerances of the reference's
kernel matrix (``repro/conformance/kernels.py``: norms rtol 1e-5; apply
rtol 1e-5, atol 1e-6). The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.delta_sgd import delta_sgd as rk
from repro.kernels.delta_sgd import ref as rref
from repro_torch.kernels import build
from repro_torch.kernels.delta_sgd import delta_sgd as tk
from repro_torch.kernels.delta_sgd import ref as tref

SHAPES = [(3, 256), (4, 1024 * 128 + 256), (10, 71808)]


def _inputs(C, N, seed):
    r = np.random.default_rng(seed)
    g = r.normal(size=(C, N)).astype(np.float32)
    gp = (g * -0.3 + 0.1).astype(np.float32)
    p = r.normal(size=(C, N)).astype(np.float32)
    eta = r.uniform(0.01, 1.0, C).astype(np.float32)
    mask = r.integers(0, 2, N).astype(np.float32)
    return g, gp, p, eta, mask


@pytest.mark.parametrize("C,N", SHAPES)
def test_batched_norms_matches_reference(C, N):
    g, gp, *_ = _inputs(C, N, 1)
    got = torch.stack(tk.batched_norms(torch.from_numpy(g),
                                       torch.from_numpy(gp))).numpy()
    want = np.stack(rref.batched_norms_ref(jnp.asarray(g), jnp.asarray(gp)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)
    if C * N <= 4 * 2 ** 17:   # interpret mode is slow at the paper width
        pal = np.stack(rk.batched_norms(jnp.asarray(g), jnp.asarray(gp),
                                        interpret=True))
        np.testing.assert_allclose(got, pal, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("C,N", SHAPES)
def test_batched_apply_matches_reference(C, N, masked):
    g, _, p, eta, mask = _inputs(C, N, 2)
    m = mask if masked else None
    P = torch.from_numpy(p.copy())
    out = tk.batched_apply(P, torch.from_numpy(g), torch.from_numpy(eta),
                           mask=torch.from_numpy(m) if masked else None)
    assert out is P, "batched_apply updates P in place"
    jm = jnp.asarray(m) if masked else None
    want = np.asarray(rref.batched_apply_ref(jnp.asarray(p), jnp.asarray(g),
                                             jnp.asarray(eta), mask=jm))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)
    if C * N <= 4 * 2 ** 17:
        pal = np.asarray(rk.batched_apply(jnp.asarray(p), jnp.asarray(g),
                                          jnp.asarray(eta), mask=jm,
                                          interpret=True))
        np.testing.assert_allclose(out.numpy(), pal, rtol=1e-5, atol=1e-6)
    if masked:   # masked lanes hold bf16-representable values
        sel = out[:, torch.from_numpy(mask) > 0]
        assert torch.equal(sel, sel.to(torch.bfloat16).to(torch.float32))


def test_apply_rounds_multiply_and_subtract_separately():
    """The plain version is p - (η·g) with two roundings, which is what
    the CUDA kernel's __fmul_rn/__fsub_rn reproduce bitwise."""
    _, _, p, eta, _ = _inputs(2, 128, 3)
    g = np.random.default_rng(4).normal(size=(2, 128)).astype(np.float32)
    got = tref.batched_apply_ref(torch.from_numpy(p), torch.from_numpy(g),
                                 torch.from_numpy(eta)).numpy()
    want = p - (eta[:, None] * g).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_launch_counter_counts_each_call_by_device():
    tk.reset_launch_count()
    g, gp, p, eta, _ = _inputs(2, 256, 5)
    tk.batched_norms(torch.from_numpy(g), torch.from_numpy(gp))
    tk.batched_apply(torch.from_numpy(p), torch.from_numpy(g),
                     torch.from_numpy(eta))
    tk.batched_apply(torch.from_numpy(p), torch.from_numpy(g),
                     torch.from_numpy(eta))
    assert tk.LAUNCHES[("batched_norms", "cpu")] == 1
    assert tk.LAUNCHES[("batched_apply", "cpu")] == 2
    assert tk.launch_count() == 3 and tk.launch_count("cuda") == 0
    tk.reset_launch_count()
    assert tk.launch_count() == 0


@pytest.mark.parametrize("case", ["ragged", "dtype", "shape", "noncontig",
                                  "eta", "mask", "device"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    g = torch.zeros(2, 256)
    p = torch.zeros(2, 256)
    eta = torch.zeros(2)
    with pytest.raises((ValueError, TypeError)):
        if case == "ragged":
            tk.batched_norms(torch.zeros(2, 200), torch.zeros(2, 200))
        elif case == "dtype":
            tk.batched_norms(g.double(), g.double())
        elif case == "shape":
            tk.batched_norms(g, torch.zeros(3, 256))
        elif case == "noncontig":
            tk.batched_apply(torch.zeros(256, 2).t(), g, eta)
        elif case == "eta":
            tk.batched_apply(p, g, torch.zeros(3))
        elif case == "mask":
            tk.batched_apply(p, g, eta, mask=torch.zeros(128))
        else:   # neither the CPU plain version nor a CUDA kernel
            m = torch.zeros(2, 256, device="meta")
            tk.batched_norms(m, m)


def test_library_path_is_keyed_on_the_sources(tmp_path):
    """A changed source gets a new library name, so a stale build is never
    loaded; nothing is compiled to compute the name."""
    src = tmp_path / "k.cu"
    src.write_text("// one")
    first = build.library_path("k", [src])
    assert first == build.library_path("k", [src])
    src.write_text("// two")
    second = build.library_path("k", [src])
    assert first != second
    assert first.parent == second.parent == build.BUILD_DIR
    assert first.name.startswith("k-") and first.suffix == ".so"
    assert not first.exists() and not second.exists()
