"""The grid rules of the Δ-SGD batched pair, checked on the CPU.

``batched_norms`` cuts each client row into blocks of NORMS_CHUNK
elements (``norms_grid``), and ``batched_apply`` gives each thread one
16-byte column of a group of clients (``apply_grid``). The CUDA kernels
run only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``);
what they are handed is computed here, so these tests hold the index
arithmetic: every element summed once and in an order that depends on
(C, N) alone, every column of every client updated once, at SM counts
of 132 (H100 SXM) and 114 (H100 PCIe). The summation order is also
emulated in f32 and held against the reference's ``batched_norms_ref``
(rtol 1e-5, the kernel matrix's norms tolerance)."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.delta_sgd import ref as rref
from repro_torch.kernels import common
from repro_torch.kernels.delta_sgd import delta_sgd as tk

SHAPES = [(1, 128), (3, 128 * 67), (10, 71808), (200, 1024), (10, 2 ** 24)]
SMS = [132, 114]


def norms_partition(N):
    """The elements of a row each block sums, in the order the blocks'
    pairs are added up -> [(start, stop) per block]."""
    return [(b * tk.NORMS_CHUNK, min(N, (b + 1) * tk.NORMS_CHUNK))
            for b in range(tk.norms_grid(1, N))]


@pytest.mark.parametrize("C,N", SHAPES)
def test_norms_grid_covers_each_element_once(C, N):
    blocks = tk.norms_grid(C, N)
    assert 1 <= blocks <= 2 ** 31 - 1   # the grid's x limit
    seen = np.zeros(N, np.int8)
    for start, stop in norms_partition(N):
        assert 0 <= start < stop <= N
        assert start % 128 == 0 and (stop - start) % 128 == 0
        seen[start:stop] += 1
    assert (seen == 1).all()


def test_norms_grid_does_not_take_the_sm_count(monkeypatch):
    """Its only inputs are (C, N), it reads no device property, and rows
    are cut alike whatever C is."""
    assert list(inspect.signature(tk.norms_grid).parameters) == ["C", "N"]

    def no_sm_count(index):
        raise AssertionError("norms_grid read the SM count")
    monkeypatch.setattr(common, "sm_count", no_sm_count)
    for C, N in SHAPES:
        assert tk.norms_grid(C, N) == tk.norms_grid(1, N)


def _apply_units(grid, C, N):
    """The units the kernel's grid-stride loop visits, in any order:
    thread t of the flat grid takes t, t + stride, ... while < units."""
    units = -(-C // grid.group) * (N // 4)
    stride = grid.blocks * grid.threads
    t = np.arange(stride, dtype=np.int64)
    trips = -(-units // stride)
    u = (t[None, :] + stride * np.arange(trips, dtype=np.int64)[:, None])
    return units, u[u < units]


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("C,N", SHAPES + [(17, 71808), (17, 2 ** 22)])
def test_apply_grid_covers_every_column_and_client_once(C, N, sms):
    grid = tk.apply_grid(C, N, sms)
    assert 1 <= grid.group <= tk.APPLY_GROUP
    assert 1 <= grid.threads <= tk.APPLY_THREADS
    assert 1 <= grid.blocks <= 2 ** 31 - 1
    n4 = N // 4
    units, u = _apply_units(grid, C, N)
    assert np.bincount(u, minlength=units).tolist() == [1] * units
    # unit u -> column u % n4 of group u // n4: a bijection onto
    # groups x columns, so each (client, column) is covered once if the
    # groups partition the clients
    groups = units // n4
    clients = np.concatenate([np.arange(g * grid.group,
                                        min(C, (g + 1) * grid.group))
                              for g in range(groups)])
    assert clients.tolist() == list(range(C))
    if grid.stream:
        assert grid.threads == tk.APPLY_THREADS
        assert grid.blocks <= sms * tk.APPLY_WAVES
    else:   # one trip: no idle block, and every SM has one where it can
        assert grid.blocks * grid.threads >= units
        assert (grid.blocks - 1) * grid.threads < units
        assert grid.blocks >= sms or grid.threads == 32


@pytest.mark.parametrize("sms", SMS)
def test_apply_grid_groups_clients_only_on_long_rows(sms):
    """From APPLY_GROUP_N elements a row, where the mask would leave the
    L2 between clients, a thread takes a group of clients, the fewest
    groups of equal size: (10, 2**24) two of 5, (8, 2**22) one of 8.
    Shorter rows, the paper's width among them, take one client a
    thread, however many clients there are."""
    assert tk.apply_grid(10, 2 ** 24, sms).group == 5
    assert tk.apply_grid(8, 2 ** 22, sms).group == 8
    for C, N in ((10, 71808), (10, 2 ** 20), (200, 1024), (100, 71808)):
        assert tk.apply_grid(C, N, sms).group == 1


def test_apply_grid_leaves_a_group_short_where_c_does_not_divide():
    """C = 17 on a long row: groups of 6, 6 and 5."""
    assert tk.apply_grid(17, 2 ** 22, 132).group == 6
    assert tk.apply_grid(17, 2 ** 24, 114).group == 6


def _emulate_norms(g, gp):
    """The kernel's partition in f32: each block's (dg, gg) over its
    elements, then the blocks' pairs summed in block order."""
    C, N = g.shape
    dg = torch.zeros(C)
    gg = torch.zeros(C)
    for a, b in norms_partition(N):
        x, y = g[:, a:b], gp[:, a:b]
        d = x - y
        dg = dg + (d * d).sum(dim=1)
        gg = gg + (x * x).sum(dim=1)
    return dg, gg


# (10, 2**24) is left to the index checks above: its inputs are 1.3 GB
@pytest.mark.parametrize("C,N", [(1, 128), (3, 128 * 67), (10, 71808),
                                 (200, 1024), (10, 2 ** 20),
                                 (2, 2 ** 20 + 128)])
def test_norms_partition_matches_reference(C, N):
    r = np.random.default_rng(C * 7 + N)
    g = r.normal(size=(C, N)).astype(np.float32)
    gp = (g * -0.3 + r.normal(size=(C, N)) * 0.1).astype(np.float32)
    dg, gg = _emulate_norms(torch.from_numpy(g), torch.from_numpy(gp))
    want = np.stack(rref.batched_norms_ref(jnp.asarray(g), jnp.asarray(gp)))
    np.testing.assert_allclose(np.stack([dg.numpy(), gg.numpy()]), want,
                               rtol=1e-5, atol=0.0)


def test_batched_norms_refuses_more_clients_than_its_grid_holds():
    g = torch.zeros(tk._MAX_CLIENTS + 1, 128)
    with pytest.raises(ValueError, match="grid's y limit"):
        tk.batched_norms(g, g)


# the single-tensor norms: (n, dtype) from one element to 2**24, ragged
# ends of every length, both sides of each change of loads a thread
F32, BF16 = torch.float32, torch.bfloat16
SINGLE = [(1, F32), (3, F32), (7, BF16), (1023, F32), (8193, BF16),
          (71808, F32), (71808, BF16), (71809, BF16), (71811, F32),
          (64 * 1024 - 1, F32), (64 * 1024, F32), (64 * 2048 + 1, F32),
          (2 ** 20 + 3, BF16), (2 ** 24, F32), (2 ** 24, BF16)]


def single_norms_order(n, dtype, vec):
    """The elements ``norms`` sums, grouped as its kernel adds them up:
    [(start, stop) of each chunk, in the order the last block adds the
    chunks' pairs], then the (start, stop) of the ragged end it adds one
    element at a time."""
    grid = tk.single_norms_grid(n, dtype)
    chunk = tk._norms_chunk(grid.vecs, dtype)
    per = 16 // dtype.itemsize
    whole = n // per * per if vec else n
    return ([(b * chunk, min(whole, (b + 1) * chunk))
             for b in range(grid.chunks)], (whole, n))


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("n,dtype", SINGLE)
def test_single_norms_grid_covers_each_element_once(n, dtype, vec):
    grid = tk.single_norms_grid(n, dtype)
    assert grid.vecs in tk.NORMS_VECS
    assert grid.chunks == -(-n // tk._norms_chunk(grid.vecs, dtype))
    assert 1 <= grid.chunks <= 2 ** 31 - 1
    # as many loads a thread as still leave NORMS_MIN_CHUNKS blocks
    assert grid.chunks >= tk.NORMS_MIN_CHUNKS or grid.vecs == 1
    if grid.vecs < max(tk.NORMS_VECS):
        wider = tk._norms_chunk(2 * grid.vecs, dtype)
        assert -(-n // wider) < tk.NORMS_MIN_CHUNKS
    chunks, (tail0, tail1) = single_norms_order(n, dtype, vec)
    seen = np.zeros(n, np.int8)
    for a, b in chunks:
        seen[a:b] += 1
    seen[tail0:tail1] += 1
    assert (seen == 1).all()
    assert tail1 - tail0 == (n % (16 // dtype.itemsize) if vec else 0)


def test_single_norms_grid_takes_n_and_dtype_alone(monkeypatch):
    """Its only inputs are (n, dtype) and it reads no device property, so
    a card of 114 SMs and one of 132 sum in one order."""
    assert list(inspect.signature(tk.single_norms_grid).parameters) == [
        "n", "dtype"]

    def no_sm_count(index):
        raise AssertionError("single_norms_grid read the SM count")
    monkeypatch.setattr(common, "sm_count", no_sm_count)
    for n, dtype in SINGLE:
        tk.single_norms_grid(n, dtype)


def test_single_norms_grid_spreads_the_papers_width():
    """At the paper's width the tensor takes 71 blocks of one load a
    thread (36 in bf16), not the parent's 9 (5) of eight; from 2**20
    elements blocks take eight loads a thread again."""
    assert tk.single_norms_grid(71808, F32) == (1, 71)
    assert tk.single_norms_grid(71808, BF16) == (1, 36)
    assert tk.single_norms_grid(2 ** 18, F32) == (4, 64)
    for dtype in (F32, BF16):
        assert tk.single_norms_grid(2 ** 24, dtype).vecs == 8


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("n,dtype", [(1, F32), (1023, F32), (8193, BF16),
                                     (71808, F32), (71809, BF16),
                                     (64 * 2048 + 1, F32),
                                     (2 ** 20 + 3, BF16)])
def test_single_norms_order_matches_reference(n, dtype, vec):
    """The kernel's grouping of the sums, each group summed in f32, held
    to the reference's ``norms_ref`` (rtol 1e-5 f32, 3e-3 bf16, as the
    kernel matrix holds norms) and to the port's plain version."""
    r = np.random.default_rng(n)
    g = torch.from_numpy(r.normal(size=n).astype(np.float32)).to(dtype)
    gp = torch.from_numpy(r.normal(size=n).astype(np.float32)).to(dtype)
    x, y = g.float(), gp.float()
    chunks, (t0, t1) = single_norms_order(n, dtype, vec)
    dg = gg = torch.zeros(())
    for a, b in chunks:
        d = x[a:b] - y[a:b]
        dg, gg = dg + (d * d).sum(), gg + (x[a:b] * x[a:b]).sum()
    for e in range(t0, t1):
        d = x[e] - y[e]
        dg, gg = dg + d * d, gg + x[e] * x[e]
    got = np.array([float(dg), float(gg)], np.float32)
    rtol = 1e-5 if dtype == F32 else 3e-3
    want = np.array(rref.norms_ref(jnp.asarray(x.numpy()).astype(
        jnp.bfloat16 if dtype == BF16 else jnp.float32),
        jnp.asarray(y.numpy()).astype(
        jnp.bfloat16 if dtype == BF16 else jnp.float32)), np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0)
    np.testing.assert_allclose(got, torch.stack(tk.norms(g, gp)).numpy(),
                               rtol=rtol, atol=0.0)


class FakeLibrary:
    """Stands in for a built kernel library (``test_torch_hist_quant.py``
    uses it too): every entry point returns 0 unless ``returns`` names
    it; each takes argtypes and restype."""

    def __init__(self, **returns):
        self._returns = returns

    def __getattr__(self, name):
        value = self._returns.get(name, lambda *args: 0)

        def entry(*args):
            return value(*args)
        setattr(self, name, entry)
        return entry


def _chunk(code, vecs):
    return 256 * vecs * (4 if code == 0 else 8)


@pytest.mark.parametrize("returns,ok", [
    ({"dsgd_norms_chunk": _chunk}, True),
    ({"dsgd_norms_chunk": lambda code, vecs: 256 * vecs * 4}, False),
    ({"dsgd_norms_chunk": lambda code, vecs: _chunk(code, vecs) * (
        vecs != 2)}, False)])
def test_library_whose_norms_grid_disagrees_is_refused(returns, ok,
                                                       monkeypatch):
    """The wrapper checks the library's chunk for every (dtype, loads a
    thread) of ``single_norms_grid`` when it loads it, so a stale or
    edited source cannot be launched on a grid cut otherwise."""
    from repro_torch.kernels import build
    fake = FakeLibrary(**returns)
    monkeypatch.setattr(build, "load_library", lambda name, sources: fake)
    tk.library.cache_clear()
    try:
        if ok:
            assert tk.library() is fake
        else:
            with pytest.raises(RuntimeError, match="norms' grid"):
                tk.library()
    finally:
        tk.library.cache_clear()
