"""The CUDA kernels and the slice on the card. These tests need an NVIDIA
GPU (and nvcc to build the kernels) and skip without one; they import no
``jax``, so they run where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` checks the same properties at the paper's width."""
import numpy as np
import pytest
import torch

from repro_torch.configs import paper_tasks as tcfg
from repro_torch.kernels.compress import compress as tcomp
from repro_torch.kernels.compress import ref as tcref
from repro_torch.kernels.delta_sgd import delta_sgd as tk
from repro_torch.kernels.delta_sgd import ref as tref
from repro_torch.kernels.robust_agg import ref as traref
from repro_torch.kernels.robust_agg import robust_agg as tra
from repro_torch.kernels.telemetry import telemetry as tt

pytestmark = pytest.mark.cuda

# a ragged last norms block, a single 128-lane row, the paper's CNN
# width, the CNN at the fleet's cohort of 50, many clients on a short
# row, a long row
SHAPES = [(3, 128 * 67), (1, 128), (10, 71808), (50, 71808), (200, 1024),
          (10, 2 ** 20)]


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


# CUDA runtime and driver calls that put work on the device
_ENQUEUE_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemset", "cuMemset",
                  "cudaMemcpy", "cuMemcpy")


def _device_ops(fn):
    """Device operations (kernels, copies, fills) of one call of fn: the
    CUDA runtime and driver calls that put them on the device, as
    torch.profiler records them on the host. Its device records of a
    kernel launched from the port's libraries go missing now and then
    (after other tests have run in the process); the calls do not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CPU
            and e.name.startswith(_ENQUEUE_CALLS)]


@pytest.mark.parametrize("C,N", [(10, 71808), (10, 2 ** 20)])
def test_batched_pair_is_one_device_op_a_call(C, N, dev):
    """No counter fill, memset or copy beside the kernel."""
    g, gp, p, eta, mask = _inputs(C, N, dev, seed=2)
    tk.batched_norms(g, gp)
    torch.cuda.synchronize()
    for fn in (lambda: tk.batched_norms(g, gp),
               lambda: tk.batched_apply(p, g, eta),
               lambda: tk.batched_apply(p, g, eta, mask=mask)):
        ops = _device_ops(fn)
        assert len(ops) == 1, ops


def test_batched_pair_refuses_a_grid_the_kernels_do_not_cut(dev):
    """The library holds the wrappers' mirrors of its constants: a norms
    grid of other than ceil(N / NORMS_CHUNK) blocks a row, or a group
    past APPLY_GROUP, is refused before any launch."""
    C, N = 3, 128 * 67
    g, gp, p, eta, _ = _inputs(C, N, dev, seed=6)
    lib = tk.library()
    stream = torch.cuda.current_stream().cuda_stream
    chunks = tk.norms_grid(C, N)
    partial, tickets = tk._norms_workspace(g.device, stream, C, chunks + 1)
    out = torch.empty((2, C), device=dev)
    for blocks in (chunks, chunks + 1, chunks - 1):
        got = lib.dsgd_batched_norms(
            g.data_ptr(), gp.data_ptr(), C, N, blocks, partial.data_ptr(),
            tickets.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), stream)
        assert (got == 0) == (blocks == chunks), (blocks, got)
    for group in (tk.APPLY_GROUP, tk.APPLY_GROUP + 1):
        got = lib.dsgd_batched_apply(
            p.data_ptr(), g.data_ptr(), eta.data_ptr(), None, C, N, group,
            32, 1, 0, stream)
        assert (got == 0) == (group == tk.APPLY_GROUP), (group, got)
    torch.cuda.synchronize()


@pytest.mark.parametrize("C,N", [(10, 71808), (3, 128 * 67), (10, 2 ** 20)])
def test_batched_norms_keeps_nan_and_inf_in_their_clients(C, N, dev):
    g, gp, *_ = _inputs(C, N, dev, seed=3)
    clean = torch.stack(tk.batched_norms(g, gp))
    bad = g.clone()
    bad[0, N // 2 + 1] = float("nan")
    bad[C - 1, 5] = float("inf")
    dirty = torch.stack(tk.batched_norms(bad, gp))
    torch.cuda.synchronize()
    assert not torch.isfinite(dirty[:, 0]).any()
    assert not torch.isfinite(dirty[:, C - 1]).any()
    assert torch.equal(dirty[:, 1:C - 1], clean[:, 1:C - 1])


@pytest.mark.parametrize("C,N", [(10, 71808), (10, 2 ** 20)])
def test_batched_pair_bits_do_not_depend_on_the_sm_count(C, N, dev,
                                                          monkeypatch):
    """With the H100 PCIe's 114 SMs in place of the card's own count (or
    132 on a card of 114): the norms keep their bits (their grid is a
    function of (C, N), ``norms_grid``), and the apply, whose grid
    follows the SM count (it does at (10, 2**20)), stays bitwise plain."""
    from repro_torch.kernels import common
    own_sms = common.sm_count(torch.cuda.current_device())
    other = 132 if own_sms == 114 else 114
    if N == 2 ** 20:
        assert tk.apply_grid(C, N, other) != tk.apply_grid(C, N, own_sms)
    g, gp, p, eta, mask = _inputs(C, N, dev, seed=4)
    own = torch.stack(tk.batched_norms(g, gp))
    monkeypatch.setattr(common, "sm_count", lambda index: other)
    assert torch.equal(torch.stack(tk.batched_norms(g, gp)), own)
    for m in (None, mask):
        out = tk.batched_apply(p.clone(), g, eta, mask=m)
        assert torch.equal(out, tref.batched_apply_ref(p, g, eta, m))


@pytest.mark.parametrize("masked", [False, True])
def test_batched_apply_with_a_short_client_group(masked, dev):
    """C = 17 on a row long enough for groups (6, 6, 5): the last group
    of clients is not full."""
    from repro_torch.kernels import common
    C, N = 17, tk.APPLY_GROUP_N
    sms = common.sm_count(torch.cuda.current_device())
    assert C % tk.apply_grid(C, N, sms).group
    g, _, p, eta, mask = _inputs(C, N, dev, seed=5)
    m = mask if masked else None
    want = tref.batched_apply_ref(p, g, eta, m)
    out = tk.batched_apply(p.clone(), g, eta, mask=m)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


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


def _deltas(C, N, dev, seed):
    """Round-delta-like slabs: mixed scales per chunk, exact ties, a zero
    chunk, a constant chunk and a denormal-scaled chunk."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(C, N)) * np.exp(r.normal(size=(C, N // 128, 1)) * 3
                                       ).repeat(128, axis=2).reshape(C, N)
    x = x.astype(np.float32)
    x[:, :128] = 0.0
    if N >= 512:
        x[:, 128:256] = -0.5
        x[:, 256:384] = np.round(x[:, 256:384] * 4) / 4   # many ties
        x[:, 384:512] *= np.float32(1e-39)
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("C,N", SHAPES)
def test_quantize_dequantize_kernels_are_bitwise_plain(C, N, dev):
    x = _deltas(C, N, dev, 2)
    tcomp.reset_launch_count()
    q, s = tcomp.quantize_int8(x)
    want_q, want_s = tcref.quantize_int8_ref(x)
    out = tcomp.dequantize_int8(q, s)
    torch.cuda.synchronize()
    assert torch.equal(q, want_q)
    assert torch.equal(s.view(torch.int32), want_s.view(torch.int32))
    assert torch.equal(out.view(torch.int32),
                       tcref.dequantize_int8_ref(q, s).view(torch.int32))
    assert tcomp.launch_count("cuda") == 2


def test_quantize_kernel_keeps_a_nan_chunk_like_the_plain_version(dev):
    x = _deltas(2, 512, dev, 3)
    x[0, 5] = float("nan")
    x[1, 300] = float("inf")
    q, s = tcomp.quantize_int8(x)
    want_q, want_s = tcref.quantize_int8_ref(x)
    torch.cuda.synchronize()
    assert torch.isnan(s[0, 0]) and torch.isinf(s[1, 2])
    assert torch.equal(q, want_q)
    assert torch.equal(torch.nan_to_num(s, nan=-1.0),
                       torch.nan_to_num(want_s, nan=-1.0))


# (clients, chunks a row): one chunk, a ragged warp (7), a ragged last
# warp after whole ones (4k + 3), three rows of 7, a part-filled last
# block (32k + 5)
QUANT_RAGGED = [(1, 1), (1, 7), (1, 4 * 1000 + 3), (3, 7), (1, 32 * 41 + 5)]


@pytest.mark.parametrize("sms", [None, 114])
@pytest.mark.parametrize("C,M", QUANT_RAGGED)
def test_quantize_kernel_is_bitwise_plain_at_ragged_chunk_counts(
        C, M, sms, dev, monkeypatch):
    """Every chunk of a ragged warp or block is quantized once, a NaN and
    an inf chunk as the plain version has them; the SM count (patched to
    114) moves no bit; two calls give the same bits, one device op each."""
    from repro_torch.kernels import common
    x = _deltas(C, M * 128, dev, 7)
    if M >= 3:
        x[0, 130] = float("nan")
        x[C - 1, 300] = float("inf")
    if sms is not None:
        monkeypatch.setattr(common, "sm_count", lambda index: sms)
    q, s = tcomp.quantize_int8(x)
    q2, s2 = tcomp.quantize_int8(x)
    want_q, want_s = tcref.quantize_int8_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(q, want_q) and torch.equal(q2, q)
    assert torch.equal(s.nan_to_num(-1.0).view(torch.int32),
                       want_s.nan_to_num(-1.0).view(torch.int32))
    assert torch.equal(s2.nan_to_num(-1.0).view(torch.int32),
                       s.nan_to_num(-1.0).view(torch.int32))
    assert len(_device_ops(lambda: tcomp.quantize_int8(x))) == 1


@pytest.mark.parametrize("C,M", QUANT_RAGGED)
def test_dequantize_kernel_is_bitwise_plain_at_ragged_chunk_counts(C, M,
                                                                    dev):
    """Every chunk of a ragged warp or block is dequantized once, NaN,
    ±inf and zero scales beside zero codes (0 · inf is NaN) as the plain
    version has them; two calls give the same bits, one device op each."""
    r = np.random.default_rng(C * M + 1)
    q = r.integers(-127, 128, (C, M * 128)).astype(np.int8)
    s = np.exp(r.normal(size=(C, M)) * 3).astype(np.float32)
    q[:, :64] = 0
    s.reshape(-1)[:4] = np.array([np.nan, np.inf, -np.inf, 0.0],
                                 np.float32)[:min(4, C * M)]
    q, s = torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev)
    out = tcomp.dequantize_int8(q, s)
    again = tcomp.dequantize_int8(q, s)
    want = tcref.dequantize_int8_ref(q, s)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert torch.equal(again.view(torch.int32), out.view(torch.int32))
    assert len(_device_ops(lambda: tcomp.dequantize_int8(q, s))) == 1


@pytest.mark.parametrize("k", [1, 32, 128])
@pytest.mark.parametrize("C,N", SHAPES)
def test_topk_kernel_is_exact(C, N, k, dev):
    x = _deltas(C, N, dev, 4)
    got = tcomp.topk_mask(x, k)
    want = tcref.topk_mask_ref(x, k)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    kept = (got.view(C, -1, 128) != 0).sum(-1)
    assert int(kept.max()) <= k


# top-k chunks that stress the select: zeros of both signs, constants,
# ties, ±inf, NaN (fewer and more than k), denormals, values one ulp
# apart, a wide exponent spread (tests/test_torch_select.py runs the
# select's CPU emulation on them)
def _chunk(kind, r):
    f32 = np.float32
    tiny = np.finfo(f32).tiny
    if kind == "zeros":
        return np.zeros(128, f32)
    if kind == "signed_zeros":
        return np.where(r.random(128) < 0.5, -0.0, 0.0).astype(f32)
    if kind == "constant":
        return np.full(128, -0.75, f32)
    if kind == "ties":
        v = r.integers(1, 4, 128).astype(f32)
        return np.where(r.random(128) < 0.5, -v, v).astype(f32)
    if kind == "inf":
        v = r.normal(size=128).astype(f32)
        v[r.permutation(128)[:40]] = np.inf
        v[r.permutation(128)[:5]] = -np.inf
        return v
    if kind == "all_inf":
        return np.where(r.random(128) < 0.5, -np.inf, np.inf).astype(f32)
    if kind == "few_nan":
        v = r.normal(size=128).astype(f32)
        v[r.permutation(128)[:20]] = np.nan
        v[:3] = -np.nan
        return v
    if kind == "many_nan":
        v = r.normal(size=128).astype(f32)
        v[r.permutation(128)[:100]] = np.nan
        return v
    if kind == "all_nan":
        return np.full(128, np.nan, f32)
    if kind == "nan_inf_zero":
        return r.choice(np.asarray([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0],
                                   f32), 128)
    if kind == "denormal":
        v = (r.integers(-40, 41, 128) * tiny / 64).astype(f32)
        v[:4] = f32(1.4e-45)
        return v
    if kind == "denormal_mixed":
        v = r.normal(size=128).astype(f32)
        v[r.permutation(128)[:90]] = (r.integers(1, 9, 90) * tiny / 16
                                        ).astype(f32)
        return v
    if kind == "ulps":
        b = 0x3F800000 + r.integers(0, 5, 128)
        v = b.astype(np.uint32).view(f32)
        return np.where(r.random(128) < 0.5, -v, v).astype(f32)
    if kind == "ulps_at_max":
        b = 0x7F7FFFFF - r.integers(0, 4, 128)
        v = b.astype(np.uint32).view(f32).copy()
        v[:6] = np.inf
        return v
    if kind == "spread":
        v = (10.0 ** r.uniform(-44, 38, 128)).astype(f32)
        return np.where(r.random(128) < 0.5, -v, v).astype(f32)
    if kind == "normal":
        return (r.normal(size=128) * np.exp(3 * r.normal())).astype(f32)
    raise ValueError(kind)


CHUNKS = ("zeros", "signed_zeros", "constant", "ties", "inf", "all_inf",
          "few_nan", "many_nan", "all_nan", "nan_inf_zero", "denormal",
          "denormal_mixed", "ulps", "ulps_at_max", "spread", "normal")


def adversarial_chunks(seed, copies=2):
    """(copies, 128·len(CHUNKS)) f32: one chunk of each kind a row."""
    r = np.random.default_rng(seed)
    rows = [np.concatenate([_chunk(kind, r) for kind in CHUNKS])
            for _ in range(copies)]
    return np.stack(rows)



@pytest.mark.parametrize("k", [1, 32, 128])
def test_topk_kernel_is_exact_on_adversarial_chunks(k, dev):
    x = torch.from_numpy(adversarial_chunks(k, copies=3)).to(dev)
    got = tcomp.topk_mask(x, k)
    want = tcref.topk_mask_ref(x, k)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# every register network of the trimmed mean (P2 = 2 .. 64, each at its
# smallest and largest C) and the shared-memory path past 64 clients, at
# rows whose last block of coordinates is part-filled and at rows long
# enough for the grid-stride loop
@pytest.mark.parametrize("N", [128 * 1031, 128 * 8195])
@pytest.mark.parametrize("C", [2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 64, 65])
def test_trimmed_mean_kernel_every_network_is_bitwise_plain(C, N, dev):
    x = _deltas(C, N, dev, 6)
    for t in sorted({0, (C - 1) // 4, (C - 1) // 2}):
        got = tra.batched_trimmed_mean(x, t)
        want = traref.batched_trimmed_mean_ref(x, t)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("C,N", [(10, 71808), (50, 71808), (10, 2 ** 20)])
def test_select_kernels_are_one_device_op_a_call(C, N, dev):
    x = _deltas(C, N, dev, 7)
    tcomp.topk_mask(x, 32)
    tra.batched_trimmed_mean(x, (C - 1) // 2)
    torch.cuda.synchronize()
    for fn in (lambda: tcomp.topk_mask(x, 32),
               lambda: tra.batched_trimmed_mean(x, 2),
               lambda: tra.batched_trimmed_mean(x, (C - 1) // 2)):
        ops = _device_ops(fn)
        assert len(ops) == 1, ops


@pytest.mark.parametrize("C", [1, 2, 3, 7, 10, 16, 50, 256])
def test_trimmed_mean_kernel_matches_plain_and_repeats(C, dev):
    x = _deltas(C, 128 * 67, dev, 5)
    for t in sorted({0, (C - 1) // 4, (C - 1) // 2}):
        a = tra.batched_trimmed_mean(x, t)
        b = tra.batched_trimmed_mean(x, t)
        want = traref.batched_trimmed_mean_ref(x, t)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        torch.testing.assert_close(a, want, rtol=1e-6, atol=1e-7)
        # the plain version sums the window in the kernel's order
        assert torch.equal(a, want)
    with pytest.raises(ValueError, match="limit"):
        tra.batched_trimmed_mean(torch.zeros(257, 128, device=dev), 0)


def test_scenario_paths_launch_their_kernels_on_the_card(dev):
    from repro_torch.launch import train
    common = ["--device", "cuda", "--task", "image", "--model", "cnn",
              "--num-clients", "20", "--batch", "32", "--rounds", "2",
              "--participation", "0.5"]
    scenario = ["--scenario", "bandwidth_tiered", "--robust-agg", "median",
                "--error-feedback"]
    for mod in (tk, tcomp, tra):
        mod.reset_launch_count()
    fused = train.main(common + scenario + ["--rounds-per-call", "2"])
    assert tcomp.launch_count("cuda") == tcomp.launch_count() == 3 * 2
    assert tra.launch_count("cuda") == tra.launch_count() == 2
    host = train.main(common + scenario + ["--flat"])
    for a, b in zip(fused.history, host.history):
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)


# ------------------------------------------------------- LM serving slice
def _qkv(B, S, H, KV, hd, dtype, dev, seed):
    r = np.random.default_rng(seed)
    def t(*shape):
        return torch.from_numpy(r.normal(size=shape).astype(np.float32)).to(
            dev, dtype)
    return t(B, S, H, hd), t(B, S, KV, hd), t(B, S, KV, hd)


# (B, S, H, KV, hd, window): a single row, a ragged tile, exactly one
# tile, several ragged tiles, the GQA ratios 1/2/4/8 and the three head
# dims of the zoo (64 TinyLlama, 112 Zamba2's shared block, 128); then
# the hd-128 prefill shapes of OLMoE (16/16), Qwen2.5 (40/8) and
# Granite (48/1, MQA)
FA_CASES = [(1, 1, 4, 4, 64, None), (2, 50, 8, 4, 64, None),
            (1, 64, 32, 4, 64, None), (2, 130, 8, 1, 112, None),
            (1, 130, 8, 8, 128, None), (1, 300, 4, 2, 112, 100),
            (1, 257, 16, 2, 64, 64), (1, 64, 32, 32, 112, None),
            (1, 64, 16, 16, 128, None), (1, 64, 40, 8, 128, None),
            (1, 64, 48, 1, 128, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FA_CASES, ids=str)
def test_flash_attention_kernel_matches_plain(case, dtype, dev):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as faref
    B, S, H, KV, hd, window = case
    q, k, v = _qkv(B, S, H, KV, hd, dtype, dev, 6)
    fa.reset_launch_count()
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    want = faref.attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    # f32 within 2e-5; bf16 within about one bf16 ulp of the output
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (8e-3, 4e-3)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    assert fa.LAUNCHES == {("flash_attention", "cuda"): 1}


# bf16 on the tensor cores, (B, S, H, KV, hd, window, causal): both serve
# prefill shapes, every head dim of the zoo and the matrix (16, 32, 64,
# 112, 128), S = 64, 67, 130 and 2048, GQA, MQA, windows, and
# bidirectional attention at B = 2
FA_BF16_CASES = [(1, 64, 32, 4, 64, None, True),
                 (1, 64, 32, 32, 112, None, True),
                 (1, 67, 8, 2, 16, None, True),
                 (1, 130, 8, 1, 32, None, True),
                 (1, 2048, 8, 2, 128, None, True),
                 (1, 2048, 32, 4, 64, None, True),
                 (2, 130, 4, 4, 112, 40, True),
                 (2, 2048, 4, 1, 64, 256, True),
                 (2, 128, 4, 2, 64, None, False),
                 (2, 256, 8, 8, 128, 100, False)]


@pytest.mark.parametrize("case", FA_BF16_CASES, ids=str)
def test_flash_attention_bf16_kernel_matches_plain_and_repeats(case, dev):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as faref
    B, S, H, KV, hd, window, causal = case
    q, k, v = _qkv(B, S, H, KV, hd, torch.bfloat16, dev, 9)
    fa.reset_launch_count()
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    again = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = faref.attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.equal(got, again)
    # bf16 output rounding: within about one bf16 ulp of the plain version
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=4e-3)
    assert fa.LAUNCHES == {("flash_attention", "cuda"): 2}


@pytest.mark.parametrize("case", [(1, 64, 32, 4, 64, None, True),
                                  (2, 300, 4, 2, 112, 100, True),
                                  (1, 128, 4, 1, 32, None, False)], ids=str)
def test_flash_attention_q_tile_changes_no_value(case, dev, monkeypatch):
    """The f32 kernel's 16-, 32- and 64-row q tiles give the same output:
    the tile decides which block computes a row, not how. Each tile is
    chosen by the SM count the rule reads."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    B, S, H, KV, hd, window, causal = case
    q, k, v = _qkv(B, S, H, KV, hd, torch.float32, dev, 10)
    outs = []
    for rows in fa.Q_TILE_ROWS:
        sms = -(-S // rows) * H * B     # the grid at ``rows`` just fills it
        assert fa.q_tile_rows(B, S, H, sms, q.dtype) == rows
        monkeypatch.setattr(fa, "sm_count", lambda index, sms=sms: sms)
        outs.append(fa.flash_attention(q, k, v, causal=causal,
                                       window=window))
    torch.cuda.synchronize()
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)


def test_flash_attention_kernel_refuses_grad_and_odd_head_dims(dev):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    q, k, v = _qkv(1, 8, 2, 1, 64, torch.float32, dev, 7)
    with pytest.raises(RuntimeError, match="backward"):
        fa.flash_attention(q.requires_grad_(), k, v)
    q, k, v = _qkv(1, 8, 2, 1, 72, torch.float32, dev, 7)
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.flash_attention(q, k, v)
    # the bf16 kernel copies 16-byte pieces: an unaligned view is refused
    q, k, v = _qkv(1, 8, 2, 1, 64, torch.bfloat16, dev, 7)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=dev)
    bad = flat[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(bad, k, v)


def _ssd_inputs(B, S, H, P, G, N, dev, seed):
    r = np.random.default_rng(seed)
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    dt = t(r.uniform(0.001, 0.1, (B, S, H)))
    A_log = t(np.log(r.uniform(1, 16, (H,))))
    return (t(r.normal(size=(B, S, H, P))), dt, A_log,
            t(r.normal(size=(B, S, G, N))), t(r.normal(size=(B, S, G, N))))


# (B, S, H, P, G, N): L = 64 one chunk, L = 48, L = 1 (prime S), several
# chunks with groups, the reduced Zamba2 widths, then the full-width
# Zamba2 prefill (L = 64) and its prime-length case (L = 1)
SSD_CASES = [(1, 64, 8, 64, 1, 64), (2, 96, 4, 64, 2, 64),
             (1, 67, 4, 64, 1, 64), (1, 256, 6, 32, 3, 16),
             (2, 128, 16, 32, 1, 16), (1, 64, 112, 64, 1, 64),
             (1, 67, 112, 64, 1, 64)]


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_chunks_kernel_matches_plain(case, dev):
    from repro_torch.kernels.mamba2_scan import mamba2_scan as m2
    from repro_torch.kernels.mamba2_scan import ref as m2ref
    from repro_torch.kernels.mamba2_scan.ops import chunk_len, ssd_scan
    x, dt, A_log, Bm, Cm = _ssd_inputs(*case, dev, 8)
    dA = (dt * -torch.exp(A_log)).contiguous()
    L = chunk_len(case[1])
    m2.reset_launch_count()
    got = m2.ssd_chunks(x, dt, dA, Bm, Cm, chunk=L)
    want = m2ref.ssd_chunks_ref(x, dt, dA, Bm, Cm, L)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)
    y, h = ssd_scan(x, dt, A_log, Bm, Cm)
    yc, hc = ssd_scan(*(a.cpu() for a in (x, dt, A_log, Bm, Cm)))
    torch.testing.assert_close(y.cpu(), yc, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(h.cpu(), hc, rtol=1e-3, atol=1e-4)
    assert m2.LAUNCHES[("ssd_chunks", "cuda")] == 2


# chunks of 5 steps packed six to a block with odd widths (P, N not
# multiples of 4 take the 4-byte copies), chunks of 8 steps packed four
# to a block, P = N = 128 (two slices), one chunk of 35 steps
SSD_GRID_CASES = SSD_CASES + [(1, 335, 3, 18, 1, 10),
                              (1, 536, 2, 64, 1, 64),
                              (2, 96, 4, 128, 2, 128),
                              (1, 35, 6, 24, 3, 12)]


@pytest.mark.parametrize("case", SSD_GRID_CASES, ids=str)
def test_ssd_chunks_every_grid_gives_the_same_bits(case, dev, monkeypatch):
    """Blocks of one and of two warp groups (set through the SM count
    ``ssd_grid`` reads), each called twice, give the same bits at one
    chunk a block and at every packing up to CHUNK rows (through
    PACK_ROWS). Packings give the same bits as each other where every
    chunk starts on an 8-row k tile (L = 1 or a multiple of 8); at other
    L each is within the plain version's tolerance."""
    from repro_torch.kernels.mamba2_scan import mamba2_scan as m2
    from repro_torch.kernels.mamba2_scan import ref as m2ref
    from repro_torch.kernels.mamba2_scan.ops import chunk_len
    B, S, H, P = case[:4]
    x, dt, A_log, Bm, Cm = _ssd_inputs(*case, dev, 9)
    dA = (dt * -torch.exp(A_log)).contiguous()
    L = chunk_len(S)
    by_packing = []
    for cpb in sorted({c for c in (1, 2, m2.CHUNK // L) if c * L <= m2.CHUNK}):
        monkeypatch.setattr(m2, "PACK_ROWS", cpb * L)
        outs = []
        for sms, two in ((0, False), (2 ** 30, True)):
            monkeypatch.setattr(m2, "sm_count", lambda index, sms=sms: sms)
            assert m2.ssd_grid(B, S, H, P, L, sms)[::2] == (cpb, two)
            outs.append(m2.ssd_chunks(x, dt, dA, Bm, Cm, chunk=L))
            outs.append(m2.ssd_chunks(x, dt, dA, Bm, Cm, chunk=L))
        torch.cuda.synchronize()
        for got in outs[1:]:
            for a, b in zip(got, outs[0]):
                assert torch.equal(a, b)
        by_packing.append(outs[0])
    want = m2ref.ssd_chunks_ref(x, dt, dA, Bm, Cm, L)
    for got in by_packing:
        if L == 1 or L % 8 == 0:
            for a, b in zip(got, by_packing[0]):
                assert torch.equal(a, b)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("arch,layers", [("tinyllama-1.1b", 2),
                                         ("zamba2-7b", 7),
                                         ("olmoe-1b-7b", 2),
                                         ("deepseek-v3-671b", 2),
                                         ("granite-20b", 2)])
def test_serving_runs_the_kernels_once_per_site_and_matches_cpu(arch, layers,
                                                                dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.mamba2_scan import mamba2_scan as m2
    from repro_torch.models.model import build_model
    from repro_torch.serving import DecodeEngine
    from repro_torch.utils.tree import tree_map
    cfg = get_config(arch).reduced(num_layers=layers, vocab=500)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, 500, (5, 16))
    engine = DecodeEngine(model, params, slots=2, cache_len=28,
                          flush_tokens=5)
    fa.reset_launch_count()
    m2.reset_launch_count()
    rids = [engine.submit(p, 12) for p in prompts]
    done = {c.request_id: c.tokens for c in engine.run_until_idle()}
    # MLA runs no flash attention
    attn_sites = 0 if cfg.use_mla else sum(
        t in ("attn", "shared_attn", "moe") for t in cfg.layer_types)
    ssd_sites = sum(t == "mamba2" for t in cfg.layer_types)
    assert fa.launch_count() == fa.launch_count("cuda") == 5 * attn_sites
    assert m2.launch_count() == m2.launch_count("cuda") == 5 * ssd_sites
    # the card's prefill logits are the CPU's
    toks = torch.from_numpy(np.stack([np.concatenate([prompts[i], done[r]])
                                      for i, r in enumerate(rids)]))
    cpu = tree_map(lambda a: a.cpu(), params)
    card, _ = model.apply(params, {"tokens": toks.to(dev)})
    host, _ = model.apply(cpu, {"tokens": toks})
    torch.testing.assert_close(card.cpu(), host, rtol=2e-3, atol=2e-3)


# ----------------------------------------- telemetry, single-tensor pair
def _telemetry_lanes(C, seed, dev, nan=True):
    """Lanes with NaN of both signs, ±0, ±inf and ties."""
    r = np.random.default_rng(seed)
    x = (10.0 ** r.uniform(-6.0, 3.0, C)).astype(np.float32)
    special = [np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0, 1.0, -0.0]
    if not nan:
        special = special[2:]
    n = min(C, len(special))
    x[r.permutation(C)[:n]] = np.asarray(special[:n], np.float32)
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("C", [1, 10, 50, 1000, 2048, 2049, 16384, 16385,
                               100000])
def test_telemetry_kernels_equal_their_plain_versions(C, dev):
    from repro_torch.kernels.telemetry import ref as ttref
    from repro_torch.kernels.telemetry import telemetry as tt
    from repro_torch.telemetry import TelemetrySpec
    x = _telemetry_lanes(C, C, dev)
    edges = TelemetrySpec().edges_on(dev)
    tt.reset_launch_count()
    hist = tt.lane_histogram(x.abs(), edges)
    quant = tt.lane_quantiles(x)
    torch.cuda.synchronize()
    assert torch.equal(hist, ttref.lane_histogram_ref(x.abs(), edges))
    want = ttref.lane_quantiles_ref(x)
    assert torch.equal(quant.view(torch.int32), want.view(torch.int32))
    assert tt.LAUNCHES == {("lane_histogram", "cuda"): 1,
                           ("lane_quantiles", "cuda"): 1}
    with pytest.raises(ValueError, match=f"at most {tt.MAX_LANES} lanes"):
        tt.lane_quantiles(torch.zeros(tt.MAX_LANES + 1, device=dev))


def _hist_edges(B, mixed):
    """B + 1 log-spaced edges from 0, or the same shuffled with a NaN
    edge and an empty bin of equal edges."""
    e = np.concatenate([[0.0], np.logspace(-6, 3, B)]).astype(np.float32)
    if mixed:
        r = np.random.default_rng(B)
        e = r.permutation(e)
        e[r.integers(0, B + 1)] = np.nan
        e[min(B, 1)] = e[0]
    return e


@pytest.mark.parametrize("B", [1, 16, 33, 4096])
@pytest.mark.parametrize("C", [1, 10, tt.HIST_WARP_LANES - 1,
                               tt.HIST_WARP_LANES, tt.HIST_WARP_LANES + 1,
                               16384, 100000])
def test_lane_histogram_is_exact_on_both_paths(C, B, dev):
    """Exact on the one-warp path (up to the crossover HIST_WARP_LANES)
    and on the grid (past it), with ascending and shuffled edges; two
    calls give the same bits and one device op each."""
    from repro_torch.kernels.telemetry import ref as ttref
    x = _telemetry_lanes(C, C + B, dev).abs()
    for mixed in (False, True):
        e = torch.from_numpy(_hist_edges(B, mixed)).to(dev)
        got, again = tt.lane_histogram(x, e), tt.lane_histogram(x, e)
        torch.cuda.synchronize()
        assert torch.equal(got, ttref.lane_histogram_ref(x, e))
        assert torch.equal(got, again)
        assert len(_device_ops(lambda: tt.lane_histogram(x, e))) == 1


@pytest.mark.parametrize("C", [16385, 100000, 1 << 17])
def test_lane_quantiles_multi_block_repeats_and_takes_every_q(C, dev):
    """Two calls give the same bits; Q = 2 and Q = 256 (repeated
    positions) equal the plain version; the two launches count once."""
    from repro_torch.kernels.telemetry import ref as ttref
    from repro_torch.kernels.telemetry import telemetry as tt
    x = _telemetry_lanes(C, C + 1, dev)
    tt.reset_launch_count()
    a, b = tt.lane_quantiles(x), tt.lane_quantiles(x)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for Q in (2, 256):
        got = tt.lane_quantiles(x, Q)
        want = ttref.lane_quantiles_ref(x, Q)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert tt.LAUNCHES == {("lane_quantiles", "cuda"): 4}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7,), (257, 33), (71808,), (3, 5, 129)])
def test_single_tensor_pair_matches_plain(shape, dtype, dev):
    r = np.random.default_rng(len(shape))
    def t(*s):
        return torch.from_numpy(r.normal(size=s).astype(np.float32)).to(
            dev, dtype)
    g, gp, p = t(*shape), t(*shape), t(*shape)
    tk.reset_launch_count()
    a = torch.stack(tk.norms(g, gp))
    b = torch.stack(tk.norms(g, gp))
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    torch.testing.assert_close(a, torch.stack(tref.norms_ref(g, gp)),
                               rtol=1e-5 if dtype == torch.float32 else 3e-3,
                               atol=0.0)
    eta = torch.tensor(0.37, device=dev)
    for e in (0.37, eta):
        out = tk.apply_update(p, g, e)
        assert out.dtype == dtype and out.shape == p.shape
        assert torch.equal(out, tref.apply_ref(p, g, e))
    # unaligned views take the one-element path and agree too
    flat_g, flat_p = g.reshape(-1)[1:], p.reshape(-1)[1:]
    assert torch.equal(tk.apply_update(flat_p, flat_g, 0.37),
                       tref.apply_ref(flat_p, flat_g, 0.37))
    torch.testing.assert_close(
        torch.stack(tk.norms(flat_g, flat_p)),
        torch.stack(tref.norms_ref(flat_g, flat_p)),
        rtol=1e-5 if dtype == torch.float32 else 3e-3, atol=0.0)
    assert tk.LAUNCHES == {("norms", "cuda"): 3, ("apply_update", "cuda"): 3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [71808, 2 ** 20 + 3])
def test_norms_is_one_device_op_and_leaves_its_ticket_at_zero(n, dtype,
                                                              dev):
    """One device op a call (no counter fill, no scratch) on each of two
    streams, the same bits on both; each stream's ticket is back at zero
    after its calls."""
    r = np.random.default_rng(n)
    g, gp = (torch.from_numpy(r.normal(size=n).astype(np.float32)).to(
        dev, dtype) for _ in range(2))
    torch.cuda.synchronize()
    got = []
    for stream in (torch.cuda.current_stream(), torch.cuda.Stream()):
        with torch.cuda.stream(stream):
            tk.norms(g, gp)   # makes this stream's workspace
            ops = _device_ops(lambda: tk.norms(g, gp))
            assert len(ops) == 1, ops
            got.append(torch.stack(tk.norms(g, gp)))
            torch.cuda.synchronize()
            _, tickets = tk._NORMS_WORKSPACE[(g.device.index,
                                              stream.cuda_stream)]
            assert not tickets.any()
    assert torch.equal(got[0], got[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,offset", [(71808, 0), (71809, 0), (71808, 1),
                                      (2 ** 20 + 3, 0)])
def test_apply_update_grid_is_bitwise_plain(n, offset, dtype, dev):
    """apply_update at the paper's width (the grid sized to the SMs), one
    past it (a ragged end), an unaligned view (one element a thread) and
    past the large-grid threshold: bitwise equal to the plain version for
    η a float and a device tensor."""
    r = np.random.default_rng(n + offset)
    def t():
        full = torch.from_numpy(r.normal(size=n + offset).astype(
            np.float32)).to(dev, dtype)
        return full[offset:]
    p, g = t(), t()
    assert (p.data_ptr() % 16 == 0) == (offset == 0)
    tk.reset_launch_count()
    for e in (0.37, torch.tensor(0.37, device=dev)):
        out = tk.apply_update(p, g, e)
        assert out.dtype == dtype and out.shape == p.shape
        assert torch.equal(out, tref.apply_ref(p, g, e))
    assert tk.LAUNCHES == {("apply_update", "cuda"): 2}


def test_kernel_matrix_passes_on_the_card(dev):
    from repro_torch.conformance import KERNEL_MATRIX, check_cell
    bad = [v for c in KERNEL_MATRIX for v in check_cell(c, 0, "cuda")]
    assert bad == []


def test_telemetry_path_is_bitwise_neutral_and_sync_free(dev, tmp_path):
    import warnings
    from repro_torch.core import flatten_fl_state
    from repro_torch.kernels.telemetry import telemetry as tt
    from repro_torch.launch import train
    from repro_torch.telemetry import load_events
    common = ["--device", "cuda", "--task", "image", "--model", "cnn",
              "--num-clients", "20", "--batch", "32", "--rounds", "2"]
    off = train.main(common + ["--rounds-per-call", "2"])
    tk.reset_launch_count()
    tt.reset_launch_count()
    ev = tmp_path / "e.jsonl"
    on = train.main(common + ["--rounds-per-call", "2", "--telemetry",
                              "--events", str(ev)])
    K = 500 // 32
    assert tk.launch_count("cuda") == 2 * K * 2
    assert tt.LAUNCHES == {("lane_histogram", "cuda"): 2,
                           ("lane_quantiles", "cuda"): 2}
    for a, b in zip(off.history, on.history):
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)
        assert float(b["eta_hist"].sum()) == 2      # C = 0.1 · 20 clients
    _, events = load_events(str(ev))
    assert [e["kind"] for e in events].count("round") == 2

    def block_fn(telemetry):
        args = train.build_parser().parse_args(
            common + ["--rounds-per-call", "2"] +
            (["--telemetry"] if telemetry else []))
        pt = train.setup_paper_task(args)
        run = train.BlockRunner(pt, args)
        fs = flatten_fl_state(train.init_state(pt), run.layout)
        fs, _ = run(fs, run.stage(0, 2))
        staged = run.stage(2, 2)
        torch.cuda.synchronize()
        return lambda: run(fs, staged)

    def syncs(block):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                block()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message) for w in caught)

    blocks = [block_fn(False), block_fn(True)]
    for b in blocks:        # reports torch makes once per process
        syncs(b)
    assert syncs(blocks[1]) == syncs(blocks[0])


def test_event_log_flush_is_one_copy(dev, tmp_path, monkeypatch):
    from repro_torch.telemetry import EventLog, load_events
    calls = []
    real = torch.Tensor.cpu

    def counted(self, *a, **kw):
        calls.append(self.device.type)
        return real(self, *a, **kw)

    with EventLog(str(tmp_path / "e.jsonl"), device=dev) as log:
        for t in range(3):
            log.emit("round", t=t, loss=torch.tensor(0.5, device=dev),
                     hist=torch.arange(4.0, device=dev),
                     ids=torch.arange(3, device=dev))
        monkeypatch.setattr(torch.Tensor, "cpu", counted)
        log.flush()
        monkeypatch.undo()
    assert calls == ["cuda"]
    header, events = load_events(str(tmp_path / "e.jsonl"))
    assert header["device_name"] == torch.cuda.get_device_name(dev)
    assert events[2] == {"kind": "round", "t": 2, "loss": 0.5,
                         "hist": [0.0, 1.0, 2.0, 3.0], "ids": [0, 1, 2]}


def _vmap_rounds(device, rounds, client_opt="delta_sgd", **copt_kw):
    """The CNN paper task's rounds on the vmap engine -> (metric rows,
    final params, Δ-SGD launches by (kernel, device))."""
    from repro_torch.core import get_client_opt, make_fl_round
    from repro_torch.launch import train
    args = train.build_parser().parse_args(
        ["--device", device, "--task", "image", "--model", "cnn",
         "--num-clients", "20", "--batch", "32", "--rounds", str(rounds)])
    pt = train.setup_paper_task(args)
    rnd = make_fl_round(pt.loss_fn, get_client_opt(client_opt, **copt_kw),
                        pt.server_opt, num_rounds=rounds)
    state, rows = train.init_state(pt), []
    tk.reset_launch_count()
    for t in range(rounds):
        batches, _, _ = pt.fed.sample_round(pt.participation, pt.local_steps,
                                            args.batch, round_idx=t)
        state, m, _ = rnd(state, {k: torch.from_numpy(v).to(pt.device)
                                  for k, v in batches.items()})
        rows.append({k: v.item() for k, v in m.items()})
    if device == "cuda":
        torch.cuda.synchronize()
    return rows, state.params, dict(tk.LAUNCHES)


def test_vmap_kernel_route_matches_the_plain_route_on_the_card(dev):
    """Global-rule Δ-SGD with use_pallas: one fused_delta_sgd_update a
    step on the stacked cohort, 2 launches a step (2·K a round), within
    1e-5 of the plain per-leaf route (the kernels' sum order)."""
    K = 500 // 32
    plain, p_plain, n_plain = _vmap_rounds("cuda", 2)
    kern, p_kern, n_kern = _vmap_rounds("cuda", 2, use_pallas=True)
    assert n_plain == {}
    assert n_kern == {("batched_norms", "cuda"): 2 * K,
                      ("batched_apply", "cuda"): 2 * K}
    for a, b in zip(plain, kern):
        for k in ("loss", "loss_last_step", "eta_mean", "eta_min",
                  "eta_max"):
            assert b[k] == pytest.approx(a[k], rel=1e-5), k
    for name, layer in p_plain.items():
        for leaf, v in layer.items():
            torch.testing.assert_close(p_kern[name][leaf], v, rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("client_opt,kw", [("delta_sgd", {}),
                                           ("adam", dict(lr=0.01))])
def test_vmap_round_on_the_card_matches_the_cpu(dev, client_opt, kw):
    card, _, _ = _vmap_rounds("cuda", 1, client_opt, **kw)
    cpu, _, _ = _vmap_rounds("cpu", 1, client_opt, **kw)
    for k in ("loss", "eta_mean"):
        assert card[0][k] == pytest.approx(cpu[0][k], rel=1e-4,
                                           nan_ok=True), k


@pytest.mark.parametrize("client_opt,kw,scenario", [
    ("adam", dict(lr=0.01), None),
    ("sgdm", dict(lr=0.05), None),
    ("delta_sgd", {}, None),
    ("delta_sgd", dict(use_pallas=True), None),
    ("adam", dict(lr=0.01), "dirichlet_stragglers")])
def test_vmap_round_makes_no_host_sync(dev, client_opt, kw, scenario):
    """The per-leaf scalars stay on the host as 0-d tensors, the
    optimizer state is filled on the card and heterogeneous K's step
    counts leave pinned memory: a vmap round syncs the host nowhere."""
    import warnings
    from repro_torch.core import get_client_opt, make_fl_round
    from repro_torch.launch import train
    args = train.build_parser().parse_args(
        ["--device", "cuda", "--task", "image", "--model", "cnn",
         "--num-clients", "20", "--batch", "32", "--rounds", "2"]
        + (["--scenario", scenario] if scenario else []))
    pt = train.setup_paper_task(args)
    rnd = make_fl_round(pt.loss_fn, get_client_opt(client_opt, **kw),
                        pt.server_opt, num_rounds=2, scenario=pt.scenario)
    state = train.init_state(pt)
    batches, _, _ = pt.fed.sample_round(pt.participation, pt.local_steps,
                                        args.batch, round_idx=0)
    batches = {k: torch.from_numpy(v).to(pt.device)
               for k, v in batches.items()}
    rnd(state, batches)             # reports torch makes once a process
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, metrics, _ = rnd(state, batches)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert [str(w.message) for w in caught
            if "synchroniz" in str(w.message)] == []
    assert np.isfinite(metrics["loss"].item())


# ------------------------------------------- async, fleet and resume
def _train(*flags, device="cuda"):
    from repro_torch.launch import train
    return train.main(["--device", device, "--task", "easy", "--model",
                       "mlp", "--num-clients", "20", "--batch", "128",
                       "--seed", "0", *flags])


def _same_state(a, b):
    from repro_torch.utils.tree import tree_leaves
    leaves = [tree_leaves(s.params) + tree_leaves(s.server_state)
              + ([] if s.buffer is None else tree_leaves(s.buffer.delta)
                 + list(s.buffer[1:])) for s in (a, b)]
    return a.round == b.round and all(
        torch.equal(x, y) for x, y in zip(*leaves))


@pytest.mark.parametrize("name", ["zipf_async", "byzantine_async"])
def test_async_presets_on_the_card(name, dev):
    """C = 5 against M = 8, so rounds hold and flush: 2·K·R Δ-SGD
    launches; fused == host loop bitwise (params, server state, buffer,
    metrics); round 0 = the CPU within 1e-4."""
    K, R = 500 // 128, 4
    flags = ["--scenario", name, "--participation", "0.25", "--rounds",
             str(R)]
    tk.reset_launch_count()
    fused = _train(*flags, "--rounds-per-call", "2")
    torch.cuda.synchronize()
    assert tk.LAUNCHES == {("batched_norms", "cuda"): K * R,
                           ("batched_apply", "cuda"): K * R}
    host = _train(*flags, "--flat")
    assert _same_state(fused.state, host.state)
    for a, b in zip(fused.history, host.history):
        assert a.keys() == b.keys()
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    assert 0 < sum(float(r["flushed"]) for r in fused.history) < R
    cpu = _train(*flags[:-1], "1", device="cpu")
    for k in ("loss", "eta_mean"):
        assert float(fused.history[0][k]) == pytest.approx(
            float(cpu.history[0][k]), rel=1e-4), k


def test_plain_async_tail_fused_block_makes_no_host_sync(dev):
    """zipf_async's fused block, its draws staged beforehand, syncs the
    host nowhere: the staleness draw is queued to the card and the
    buffer's flush or hold is selected there."""
    import warnings
    from repro_torch.core import flatten_fl_state
    from repro_torch.launch import train
    args = train.build_parser().parse_args(
        ["--device", "cuda", "--task", "easy", "--model", "mlp",
         "--num-clients", "20", "--batch", "128", "--scenario",
         "zipf_async", "--participation", "0.25", "--rounds-per-call",
         "2"])
    pt = train.setup_paper_task(args)
    run = train.BlockRunner(pt, args)
    fs = flatten_fl_state(train.init_state(pt), run.layout)
    fs, _ = run(fs, run.stage(0, 2))
    staged = run.stage(2, 2)
    torch.cuda.synchronize()
    counts = []
    for _ in range(2):      # the first pass takes once-a-process reports
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run(fs, staged)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("synchronizing" in str(w.message)
                          for w in caught))
    assert counts[1] == 0


def test_fleet_preset_on_the_card_touches_only_the_drawn_rows(dev):
    """fleet_zipf at its scale (100,000 registered, C = 50) with the η
    carry and telemetry: 2·K·R Δ-SGD launches and one histogram and one
    quantiles launch a round; every row outside the drawn cohorts keeps
    arena_init's bits; rounds_seen sums to C·R."""
    from repro_torch.kernels.telemetry import telemetry as tt
    K, R = 500 // 128, 4
    tk.reset_launch_count()
    tt.reset_launch_count()
    out = _train("--scenario", "fleet_zipf", "--rounds", str(R),
                 "--rounds-per-call", "2", "--eta-carry", "--telemetry")
    torch.cuda.synchronize()
    assert tk.LAUNCHES == {("batched_norms", "cuda"): K * R,
                           ("batched_apply", "cuda"): K * R}
    assert tt.LAUNCHES == {("lane_histogram", "cuda"): R,
                           ("lane_quantiles", "cuda"): R}
    ids = np.concatenate([r["cohort_ids"] for r in out.history])
    assert ids.shape == (50 * R,)
    seen = np.zeros(100_000, bool)
    seen[ids] = True
    ar = out.arena
    assert ar.eta.device.type == "cuda"
    assert int(ar.rounds_seen.sum()) == 50 * R
    np.testing.assert_array_equal(ar.eta.cpu().numpy()[~seen],
                                  np.float32(0.2))
    np.testing.assert_array_equal(ar.rounds_seen.cpu().numpy()[~seen], 0)
    np.testing.assert_array_equal(ar.last_round.cpu().numpy()[~seen], -1)


@pytest.mark.parametrize("flags", [
    [], ["--scenario", "zipf_async", "--participation", "0.5"],
    ["--scenario", "fleet_uniform", "--num-registered", "1000",
     "--participation", "0.05", "--eta-carry"]],
    ids=["plain", "zipf_async", "fleet_uniform"])
def test_resume_on_the_card_is_bitwise(flags, dev, tmp_path):
    def run(ckpt, rounds, *extra):
        return _train(*flags, "--rounds", str(rounds), "--rounds-per-call",
                      "2", "--ckpt-dir", str(ckpt), "--ckpt-every", "2",
                      *extra)
    straight = run(tmp_path / "a", 4)
    run(tmp_path / "b", 2)
    resumed = run(tmp_path / "b", 2, "--resume")
    assert _same_state(straight.state, resumed.state)
    assert (straight.arena is None) == (resumed.arena is None)
    if straight.arena is not None:
        for x, y in zip(straight.arena, resumed.arena):
            assert (x is None and y is None) or torch.equal(x, y)


def test_flat_engine_past_two_to_the_31_elements(dev):
    """The Δ-SGD pair on a (2, 2**30 + 1024) slab, 2**31 + 2048 elements
    (the 22-layer TinyLlama's 2.2e9 is of this kind): each row's sums
    against f64 sums taken in slices (rtol 1e-5), the apply bitwise
    equal to its plain version."""
    C, N = 2, 2 ** 30 + 1024
    gen = torch.Generator(device=dev).manual_seed(5)
    g = torch.randn((C, N), generator=gen, device=dev)
    gp = torch.randn((C, N), generator=gen, device=dev)
    dg, gg = tk.batched_norms(g, gp)
    for c in range(C):
        want_dg = want_gg = 0.0
        for off in range(0, N, 2 ** 26):
            a = g[c, off:off + 2 ** 26].double()
            b = gp[c, off:off + 2 ** 26].double()
            want_dg += float(((a - b) ** 2).sum())
            want_gg += float((a * a).sum())
        assert float(dg[c]) == pytest.approx(want_dg, rel=1e-5)
        assert float(gg[c]) == pytest.approx(want_gg, rel=1e-5)
    eta = torch.tensor([0.25, 0.5], device=dev)
    want = tref.batched_apply_ref(gp, g, eta, None)
    got = tk.batched_apply(gp, g, eta)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-7b",
                                  "olmoe-1b-7b", "deepseek-v3-671b"])
def test_lm_fused_round_on_the_card_matches_the_cpu(arch, dev):
    """One fused round of a reduced LM on the card: 2·K Δ-SGD launches,
    no attention or SSD kernel (training takes the plain route), and
    round 0's loss, η and params within 1e-4 of the same round on the
    CPU from the same initial params (a generator on the card draws
    other bits than one on the CPU)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.mamba2_scan import mamba2_scan as m2
    from repro_torch.launch import train as ttrain
    from repro_torch.utils.tree import tree_map
    argv = ["--arch", arch, "--reduced", "--layers", "2", "--d-model", "64",
            "--clients-per-round", "2", "--local-steps", "2", "--batch",
            "2", "--seq", "32", "--rounds", "1", "--rounds-per-call", "2"]
    cpu_args = ttrain.build_parser().parse_args(argv + ["--device", "cpu"])
    lt_cpu = ttrain.setup_lm(cpu_args)
    args = ttrain.build_parser().parse_args(argv + ["--device", "cuda"])
    lt = ttrain.setup_lm(args)._replace(
        params=tree_map(lambda t: t.to(dev), lt_cpu.params))
    for mod in (tk, fa, m2):
        mod.reset_launch_count()
    card = ttrain.train_lm(args, lt)
    torch.cuda.synchronize()
    assert tk.launch_count("cuda") == 2 * 2
    assert fa.launch_count() == m2.launch_count() == 0
    cpu = ttrain.train_lm(cpu_args, lt_cpu)
    for k in ("loss", "eta_mean"):
        assert float(card.history[0][k]) == pytest.approx(
            float(cpu.history[0][k]), rel=1e-4)
    from repro_torch.utils.tree import tree_leaves
    for a, b in zip(tree_leaves(card.state.params),
                    tree_leaves(cpu.state.params)):
        a = a.cpu()
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v3-671b"])
def test_moe_layer_repeats_its_bits_on_the_card(arch, dev):
    """The MoE layer's forward and vmap(grad) over a client axis give
    the same bits twice on the card: dispatch and combine are reads and
    a fixed-order sum, never an atomic scatter-add. T = 1,024 tokens, 4
    experts at capacity 1.25: choices are dropped."""
    from torch.func import grad, vmap
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(arch).reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = moe.init_moe(gen, cfg, torch.float32)
    pc = {k: v for k, v in params.items() if k != "shared"}
    pc = {k: torch.stack([v, v * 1.01, v * 0.99]) for k, v in pc.items()}
    if "shared" in params:
        pc["shared"] = {k: torch.stack([v] * 3)
                        for k, v in params["shared"].items()}
    x = torch.randn((3, 4, 256, cfg.d_model), generator=gen, device=dev)

    def loss(q, xx):
        out, aux = moe.apply_moe(q, xx, cfg)
        return torch.sum(out ** 2) + aux

    outs = [moe.apply_moe(params, x[0], cfg) for _ in range(2)]
    grads = [vmap(grad(loss))(pc, x) for _ in range(2)]
    torch.cuda.synchronize()
    assert moe._capacity(4 * 256, 4, 2) < 4 * 256
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    from repro_torch.utils.tree import tree_leaves
    for a, b in zip(tree_leaves(grads[0]), tree_leaves(grads[1])):
        assert torch.equal(a, b)
    assert float(grads[0]["router"].abs().sum()) > 0
