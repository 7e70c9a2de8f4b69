"""The CUDA kernels and the slice on the card. These tests need an NVIDIA
GPU (and nvcc to build the kernels) and skip without one; they import no
``jax``, so they run where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` checks the same properties at the paper's width."""
import numpy as np
import pytest
import torch

from repro_torch.configs import paper_tasks as tcfg
from repro_torch.kernels.delta_sgd import delta_sgd as tk
from repro_torch.kernels.delta_sgd import ref as tref

pytestmark = pytest.mark.cuda

# ragged last norms chunk, a single 128-lane row, the paper's CNN width
SHAPES = [(3, 128 * 67), (1, 128), (10, 71808)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested on the CPU)")
    from repro_torch.device import resolve_device
    return resolve_device("cuda")


def _inputs(C, N, dev, seed=0):
    r = np.random.default_rng(seed)
    def t(*shape):
        return torch.from_numpy(r.normal(size=shape).astype(np.float32)).to(
            dev)
    eta = torch.from_numpy(r.uniform(0.01, 1.0, C).astype(np.float32))
    mask = torch.from_numpy(r.integers(0, 2, N).astype(np.float32))
    return t(C, N), t(C, N), t(C, N), eta.to(dev), mask.to(dev)


@pytest.mark.parametrize("C,N", SHAPES)
def test_norms_kernel_matches_plain_and_is_deterministic(C, N, dev):
    g, gp, *_ = _inputs(C, N, dev)
    tk.reset_launch_count()
    a = torch.stack(tk.batched_norms(g, gp))
    b = torch.stack(tk.batched_norms(g, gp))
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    torch.testing.assert_close(a, torch.stack(tref.batched_norms_ref(g, gp)),
                               rtol=1e-5, atol=0.0)
    assert tk.LAUNCHES[("batched_norms", "cuda")] == 2


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("C,N", SHAPES)
def test_apply_kernel_is_bitwise_plain(C, N, masked, dev):
    g, _, p, eta, mask = _inputs(C, N, dev, seed=1)
    m = mask if masked else None
    want = tref.batched_apply_ref(p, g, eta, m)
    P = p.clone()
    out = tk.batched_apply(P, g, eta, mask=m)
    torch.cuda.synchronize()
    assert out.data_ptr() == P.data_ptr()
    assert torch.equal(out, want)
    if masked:
        sel = out[:, mask > 0]
        assert torch.equal(sel, sel.bfloat16().float())


def test_unaligned_input_is_rejected(dev):
    g = torch.zeros(2, 256, device=dev)
    bad = torch.zeros(2 * 256 + 1, device=dev)[1:].view(2, 256)
    with pytest.raises(ValueError, match="aligned"):
        tk.batched_norms(bad, g)


def test_fused_equals_host_loop_bitwise_on_the_card(dev):
    from repro_torch.launch import train
    common = ["--device", "cuda", "--task", "image", "--model", "cnn",
              "--num-clients", "20", "--batch", "32", "--rounds", "2"]
    tk.reset_launch_count()
    fused = train.main(common + ["--rounds-per-call", "2"])
    K = 500 // 32
    assert tk.launch_count("cuda") == tk.launch_count() == 2 * K * 2
    host = train.main(common + ["--flat"])
    for a, b in zip(fused.history, host.history):
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    assert tcfg.CNN_PAPER.fc_dim == fused.state.params["fc1"]["w"].shape[1]
