"""The port's kernel parity matrix against the reference's.

``repro_torch.conformance.kernels`` mirrors the reference's 32 cells:
the same ids, the same numpy inputs and the same tolerances. On the CPU
each port cell's ``got`` is its kernel wrapper's plain version; it is
held against the reference cell's ``got`` (its Pallas kernel in
interpret mode) on the same seed at the cell's tolerance, and exact
cells are compared for equality. The card runs the same cells kernel
against plain version (``chip_smoke.py``).
"""
import numpy as np
import pytest

from repro.conformance import kernels as rk
from repro_torch.conformance import kernels as tk

PORT = {c.key: c for c in tk.KERNEL_MATRIX}
REF = {c.key: c for c in rk.KERNEL_MATRIX}


def test_the_matrix_mirrors_the_reference():
    assert list(PORT) == list(REF)
    assert len(PORT) == 32
    assert tk.NAMESPACES == rk.NAMESPACES
    for ns in tk.NAMESPACES:
        assert [c.key for c in tk.cells_for(ns)] == [
            c.key for c in rk.cells_for(ns)]


@pytest.mark.parametrize("key", list(PORT))
def test_port_cell_matches_the_reference_cell(key):
    got, want, rtol, atol = PORT[key].run(0, "cpu")
    rgot, _, rrtol, ratol = REF[key].run(0)
    assert (rtol, atol) == (rrtol, ratol)
    g = tk.host_f32(got)
    r = np.asarray(rgot, np.float32)
    assert g.shape == r.shape
    if rtol == 0.0 and atol == 0.0:
        np.testing.assert_array_equal(g, r)
    else:
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol)
    # on the CPU the wrappers run their plain versions, so the cell holds
    assert tk.check_cell(PORT[key], 0, "cpu") == []


def test_check_cell_reports_a_planted_violation():
    cell = PORT["telemetry:quant-77"]
    bad = tk.KernelCell(cell.ns, cell.cid, lambda seed, device: (
        lambda got, want, rt, at: (got + 1.0, want, rt, at))(
            *cell.run(seed, device)))
    (msg,) = tk.check_cell(bad, 0, "cpu")
    assert msg.startswith("telemetry:quant-77: max|Δ|=1.000e+00")
