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
