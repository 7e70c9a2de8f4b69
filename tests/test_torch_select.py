"""The selection arithmetic of two CUDA kernels, emulated on the CPU.

``csrc/robust_agg.cu`` sorts each coordinate's client values in
registers with Batcher's odd-even merge network on P2 (the next power of
two at or above C, lanes past C holding +inf) and sums the window
[t, C−t) over the network's constant indices. ``odd_even_merge`` below
builds that network from the kernel's own loops; the tests check it by
the 0-1 principle, count its compare-exchanges, and run the predicated
window sum in f32 against the plain version and the reference's Pallas
kernel in interpret mode: bitwise where C−2t is a power of two (but for
the sign of a zero sum: the reference's sum of a window of −0.0s is
−0.0, the port's starts from +0.0), within one ulp elsewhere, where XLA
multiplies by the divisor's rounded reciprocal.

``csrc/compress.cu``'s ``topk_mask`` finds the k-th largest |x| of each
128-chunk by a binary search on its bit pattern that starts below the
bits the chunk's largest and smallest |x| share and stops once exactly k
lie at or above the prefix, with NaN counted apart, and ranks the
elements equal to the threshold only when they exceed the slots left.
``topk_emulation`` runs the same steps with torch on every chunk at
once; the tests hold it bitwise to the plain version and to the
reference's kernel in interpret mode on adversarial chunks. XLA on the
CPU reads denormals as zero, so the reference sees a copy of the input
with denormals flushed to ±0; the plain version, like the card, sees
every input as it is.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.compress import compress as rk_compress
from repro.kernels.robust_agg import robust_agg as rk_robust
from repro_torch.kernels.compress import ref as cref
from repro_torch.kernels.robust_agg import ref as rref
from repro_torch.kernels.robust_agg import robust_agg as tra
from test_torch_cuda import CHUNKS, adversarial_chunks

LANES = 128
P2S = (2, 4, 8, 16, 32, 64)
# compare-exchanges of the odd-even merge network per P2 (a bitonic
# network takes P2/2 · log2 P2 · (log2 P2 + 1)/2: 1, 6, 24, 80, 240, 672)
CE_COUNT = {2: 1, 4: 5, 8: 19, 16: 63, 32: 191, 64: 543}


def odd_even_merge(p2):
    """The (lo, hi) compare-exchanges of sorted_kernel<P2>, in order:
    the loops of ``odd_even_merge_sort`` in csrc/robust_agg.cu."""
    net = []
    p = 1
    while p < p2:
        k = p
        while k >= 1:
            for j in range(k % p, p2 - k, 2 * k):
                for i in range(k):
                    lo, hi = i + j, i + j + k
                    if hi < p2 and lo // (2 * p) == hi // (2 * p):
                        net.append((lo, hi))
            k //= 2
        p *= 2
    return net


def run_network(net, v):
    """Apply ``net`` along axis 0 of ``v`` (P2, ...) with min/max."""
    v = v.copy()
    for lo, hi in net:
        a, b = v[lo].copy(), v[hi].copy()
        v[lo], v[hi] = np.minimum(a, b), np.maximum(a, b)
    return v


def trimmed_mean_emulation(x, t):
    """sorted_kernel's arithmetic on a (C, N) f32 array: pad to P2 with
    +inf, sort by the network, sum [t, C−t) in ascending order from +0.0
    in f32, divide by C−2t."""
    C = x.shape[0]
    p2 = max(2, 1 << (C - 1).bit_length())
    v = np.full((p2, x.shape[1]), np.inf, np.float32)
    v[:C] = x
    v = run_network(odd_even_merge(p2), v)
    acc = np.zeros(x.shape[1], np.float32)
    for i in range(p2):
        if t <= i < C - t:
            acc = (acc + v[i]).astype(np.float32)
    return (acc / np.float32(C - 2 * t)).astype(np.float32)


@pytest.mark.parametrize("p2", P2S)
def test_network_sorts_every_zero_one_input(p2):
    net = odd_even_merge(p2)
    assert len(net) == CE_COUNT[p2]
    assert all(0 <= lo < hi < p2 for lo, hi in net)
    if p2 <= 16:       # all 2^P2 inputs
        codes = np.arange(2 ** p2, dtype=np.int64)
        v = ((codes[None, :] >> np.arange(p2)[:, None]) & 1).astype(np.int8)
    else:              # random ones, every count of ones represented
        r = np.random.default_rng(p2)
        ones = r.integers(0, p2 + 1, 20000)
        v = (r.random((p2, 20000)).argsort(0).argsort(0)
             < ones[None, :]).astype(np.int8)
    got = run_network(net, v)
    assert (np.diff(got, axis=0) >= 0).all()
    assert (got.sum(0) == v.sum(0)).all()


@pytest.mark.parametrize("p2", P2S)
def test_network_sorts_floats_with_ties_and_padding(p2):
    r = np.random.default_rng(100 + p2)
    v = np.round(r.normal(size=(p2, 4000)) * 2).astype(np.float32)
    v[p2 // 2 + 1:, :1000] = np.inf          # padded lanes
    v[:, 1000:1100] = -0.0
    got = run_network(odd_even_merge(p2), v)
    np.testing.assert_array_equal(got, np.sort(v, axis=0))


def _grid(C, N, seed):
    """Normals on a 2^-12 grid (every partial sum of up to 256 is exact in
    f32, so XLA's summation order cannot move the reference's bits),
    ties across clients, zeroed rows, ±0."""
    r = np.random.default_rng(seed)
    x = np.round(np.clip(r.normal(size=(C, N)), -8, 8) * 4096) / 4096
    x = x.astype(np.float32)
    x[:, :16] = np.round(x[:, :16])
    x[: C // 2, 16:32] = 0.0
    x[C // 2:, 32:40] = -0.0
    return x


def _raw(C, N, seed):
    """Unrounded values of mixed scale: the window sum rounds."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(C, N)) * np.exp(r.normal(size=(C, 1)) * 2)
    x = x.astype(np.float32)
    x[:, :8] = -0.0
    return x


@pytest.mark.parametrize("C", [1, 2, 3, 5, 10, 16, 17, 33, 50, 64])
def test_window_sum_is_bitwise_plain_and_reference(C):
    N = 256
    for x, to_reference in ((_grid(C, N, C), True),
                            (_raw(C, N, 50 + C), False)):
        for t in sorted({0, 1 % C if 2 < C else 0, (C - 1) // 4,
                         (C - 1) // 2}):
            if 2 * t >= C:
                continue
            got = trimmed_mean_emulation(x, t)
            plain = tra.batched_trimmed_mean(torch.from_numpy(x), t).numpy()
            np.testing.assert_array_equal(got.view(np.uint32),
                                          plain.view(np.uint32))
            np.testing.assert_array_equal(
                got.view(np.uint32),
                rref.batched_trimmed_mean_ref(torch.from_numpy(x),
                                              t).numpy().view(np.uint32))
            if to_reference:
                pal = np.asarray(rk_robust.batched_trimmed_mean(
                    jnp.asarray(x), t, interpret=True))
                w = C - 2 * t
                if w & (w - 1):
                    # XLA on the CPU divides by a constant as a multiply
                    # by its rounded reciprocal: within one ulp
                    np.testing.assert_array_max_ulp(got, pal, maxulp=1)
                    continue
                # bitwise but for the sign of a zero: XLA's sum of a
                # window of −0.0s is −0.0, the port's (from +0.0) +0.0
                np.testing.assert_array_equal(got, pal)
                nz = got != 0
                np.testing.assert_array_equal(got[nz].view(np.uint32),
                                              pal[nz].view(np.uint32))


def topk_emulation(x, k):
    """compress.cu's topk_mask on a (C, N) f32 tensor: returns the output,
    the number of search steps each chunk took and whether it ranked its
    ties."""
    x3 = x.reshape(-1, LANES)
    a = x3.abs()
    nan = torch.isnan(a)
    n_nan = nan.sum(-1)
    bits = a.view(torch.int32)
    top = torch.where(nan, 0, bits).amax(-1)
    bottom = torch.where(nan, 0x7F800000, bits).amin(-1)
    diff = top ^ bottom
    start = torch.zeros_like(diff) - 1            # highest differing bit
    for b in range(31):
        start = torch.where((diff >> b) & 1 == 1, b, start)
    low_bits = torch.where(start >= 0, (2 << start.clamp(min=0)) - 1, 0)
    prefix = top & ~low_bits
    at_or_above = torch.full_like(n_nan, LANES)
    steps = torch.zeros_like(n_nan)
    for b in range(30, -1, -1):
        active = (b <= start) & (at_or_above != k) & (n_nan < k)
        probe = prefix | (1 << b)
        p = probe.view(torch.float32)[:, None]
        c = (a >= p).sum(-1) + n_nan
        take = active & (c >= k)
        prefix = torch.where(take, probe, prefix)
        at_or_above = torch.where(take, c, at_or_above)
        steps += active.long()
    p = prefix.view(torch.float32)[:, None]
    least = torch.where(a >= p, a, torch.inf).amin(-1)
    thr = torch.where(n_nan < k, least, torch.nan)[:, None]
    greater = a > thr
    eq = a == thr
    n_greater = greater.sum(-1, keepdim=True)
    # the rank of ties is taken only when they exceed the slots left
    scan = n_greater + eq.sum(-1, keepdim=True) > k
    rank = torch.cumsum(eq.int(), -1)
    keep = torch.where(scan, greater | (eq & (rank <= k - n_greater)),
                       a >= thr)
    return torch.where(keep, x3, 0.0).reshape(x.shape), steps, scan[:, 0]


def _flushed(x):
    """x with denormals set to ±0, as XLA on the CPU reads them."""
    tiny = np.finfo(np.float32).tiny
    return np.where(np.abs(x) < tiny, np.copysign(np.float32(0), x),
                    x).astype(np.float32)


def _u32(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("k", [1, 2, 20, 32, 64, 100, 127, 128])
def test_topk_emulation_is_bitwise_plain_and_reference(k):
    x = adversarial_chunks(k)
    got, steps, scanned = topk_emulation(torch.from_numpy(x), k)
    np.testing.assert_array_equal(
        _u32(got), _u32(cref.topk_mask_ref(torch.from_numpy(x), k)))
    flushed = _flushed(x)
    assert (flushed != x).any()               # denormals were there
    got_f, _, _ = topk_emulation(torch.from_numpy(flushed), k)
    np.testing.assert_array_equal(
        _u32(got_f), _u32(cref.topk_mask_ref(torch.from_numpy(flushed), k)))
    np.testing.assert_array_equal(
        _u32(got_f), _u32(rk_compress.topk_mask(jnp.asarray(flushed), k,
                                                interpret=True)))
    # a constant or all-zero chunk takes no search step; none takes more
    # than the 31 bits of a non-negative float
    per_kind = steps.reshape(2, len(CHUNKS))
    for name in ("zeros", "signed_zeros", "constant", "all_inf"):
        assert (per_kind[:, CHUNKS.index(name)] == 0).all(), name
    assert int(steps.max()) <= 31
    if k == LANES:
        assert int(steps.max()) == 0
    # a constant chunk ranks its ties unless it keeps them all; distinct
    # normals never do
    scanned = scanned.reshape(2, len(CHUNKS))
    assert bool(scanned[:, CHUNKS.index("constant")].all()) == (k < LANES)
    assert not scanned[:, CHUNKS.index("normal")].any()


@pytest.mark.parametrize("k", [1, 32, 128])
def test_topk_emulation_keeps_k_slots_and_ties_by_first_index(k):
    x = adversarial_chunks(7 + k, copies=3)
    got, _, _ = topk_emulation(torch.from_numpy(x), k)
    g3 = got.numpy().reshape(3, len(CHUNKS), LANES)
    x3 = x.reshape(3, len(CHUNKS), LANES)
    nan = np.isnan(x3).sum(-1)
    kept = (g3.view(np.uint32) == x3.view(np.uint32)) & (g3 != 0)
    for name in ("normal", "ties", "ulps", "spread", "constant"):
        c = CHUNKS.index(name)
        assert (kept[:, c].sum(-1) == k).all(), name
    # k or more NaN: the threshold is NaN and nothing is kept
    c = CHUNKS.index("all_nan")
    assert (nan[:, c] >= k).all() and (g3[:, c] == 0).all()
    c = CHUNKS.index("constant")
    np.testing.assert_array_equal(g3[:, c, :k], x3[:, c, :k])
    assert (g3[:, c, k:] == 0).all()
    assert (_u32(g3[:, c, k:]) == 0).all()    # dropped slots are +0.0


def test_topk_emulation_on_round_deltas_takes_few_steps():
    """Round-delta-like chunks (normals, a scale per chunk, as
    chip_smoke.py makes them) at k = 32 stop after about a third of the
    31 steps; the count is what the kernel's time at 2^24 rests on."""
    r = np.random.default_rng(3)
    x = (r.normal(size=(64, LANES)) * np.exp(3 * r.normal(size=(64, 1)))
         ).astype(np.float32).reshape(1, -1)
    got, steps, _ = topk_emulation(torch.from_numpy(x), 32)
    np.testing.assert_array_equal(
        _u32(got), _u32(cref.topk_mask_ref(torch.from_numpy(x), 32)))
    assert 6 <= float(steps.float().mean()) <= 16
