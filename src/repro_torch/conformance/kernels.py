"""Table-driven kernel parity matrix: every kernel namespace of the port,
its kernel against its plain version, over a dtype × shape grid.

Port of ``repro/conformance/kernels.py``: the same 32 cells, the same
ids, the same numpy inputs from ``_rng(seed)`` and the same tolerances
(exact cells stay exact). One ``KernelCell`` is one (kernel, dtype,
shape) point whose ``run(seed, device)`` returns ``(got, want, rtol,
atol)``: ``got`` is the port's kernel wrapper on ``device`` (the CUDA
kernel on the card, its plain version on the CPU), ``want`` the port's
plain version of the same function on the same inputs. On the card the
matrix is the one table that runs all twelve kernels; on the CPU the
tests hold each cell's ``got`` against the reference cell's. The
reference's oracles, fuzzer and corpus (the rest of ROADMAP A18) are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np
import torch

NAMESPACES = ("delta_sgd", "compress", "robust_agg", "telemetry",
              "flash_attention", "mamba2_scan")


@dataclass(frozen=True)
class KernelCell:
    ns: str                            # kernel namespace
    cid: str                           # cell id, unique within the ns
    run: Callable[[int, str], Tuple]   # (seed, device) -> (got, want,
                                       #                    rtol, atol)

    @property
    def key(self) -> str:
        return f"{self.ns}:{self.cid}"


def _rng(seed):
    return np.random.default_rng(np.uint64(seed) + 101)


def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)


# ---------------------------------------------------------------- delta_sgd
def _delta_norms(shape, dtype):
    def run(seed, device):
        from repro_torch.kernels.delta_sgd import delta_sgd as dk
        from repro_torch.kernels.delta_sgd import ref as dref
        r = _rng(seed)
        g = _t(r.normal(size=shape), device, dtype)
        gp = _t(r.normal(size=shape), device, dtype)
        return (torch.stack(dk.norms(g, gp)),
                torch.stack(dref.norms_ref(g, gp)), 3e-3, 0.0)
    return run


def _delta_apply(shape, dtype):
    def run(seed, device):
        from repro_torch.kernels.delta_sgd import delta_sgd as dk
        from repro_torch.kernels.delta_sgd import ref as dref
        r = _rng(seed)
        p = _t(r.normal(size=shape), device, dtype)
        g = _t(r.normal(size=shape), device, dtype)
        return (dk.apply_update(p, g, 0.37), dref.apply_ref(p, g, 0.37),
                2e-2, 2e-2)
    return run


def _delta_batched_norms(C, N):
    def run(seed, device):
        from repro_torch.kernels.delta_sgd import delta_sgd as dk
        from repro_torch.kernels.delta_sgd import ref as dref
        r = _rng(seed)
        g = _t(r.normal(size=(C, N)), device)
        gp = g * -0.3 + 0.1
        return (torch.stack(dk.batched_norms(g, gp)),
                torch.stack(dref.batched_norms_ref(g, gp)), 1e-5, 0.0)
    return run


def _delta_batched_apply(C, N, masked):
    def run(seed, device):
        from repro_torch.kernels.delta_sgd import delta_sgd as dk
        from repro_torch.kernels.delta_sgd import ref as dref
        r = _rng(seed)
        p = _t(r.normal(size=(C, N)), device)
        g = _t(r.normal(size=(C, N)), device)
        eta = _t(r.uniform(0.01, 1.0, C), device)
        mask = _t(r.integers(0, 2, N), device) if masked else None
        # the wrapper updates its first argument in place
        return (dk.batched_apply(p.clone(), g, eta, mask=mask),
                dref.batched_apply_ref(p, g, eta, mask), 1e-5, 1e-6)
    return run


# ----------------------------------------------------------------- compress
def _compress(kind, C, chunks):
    def run(seed, device):
        from repro_torch.core.flat import LANES
        from repro_torch.kernels.compress import compress as ck
        from repro_torch.kernels.compress import ref as cr
        r = _rng(seed)
        x = _t(r.normal(size=(C, chunks * LANES)), device)
        if kind == "int8":
            q, s = ck.quantize_int8(x)
            qr, sr = cr.quantize_int8_ref(x)
            return (ck.dequantize_int8(q, s),
                    cr.dequantize_int8_ref(qr, sr), 1e-5, 1e-5)
        k = max(1, LANES // 4)
        return ck.topk_mask(x, k), cr.topk_mask_ref(x, k), 0.0, 0.0
    return run


# --------------------------------------------------------------- robust_agg
def _trimmed(C, N, t):
    def run(seed, device):
        from repro_torch.kernels.robust_agg import ref as rr
        from repro_torch.kernels.robust_agg import robust_agg as rk
        r = _rng(seed)
        x = _t(r.normal(size=(C, N)), device)
        return (rk.batched_trimmed_mean(x, t),
                rr.batched_trimmed_mean_ref(x, t), 1e-6, 1e-7)
    return run


# ---------------------------------------------------------------- telemetry
def _telemetry(which, n):
    def run(seed, device):
        from repro_torch.kernels.telemetry import ref as tr
        from repro_torch.kernels.telemetry import telemetry as tk
        r = _rng(seed)
        x = _t(r.normal(size=n), device)
        if which == "hist":
            from repro_torch.telemetry.spec import TelemetrySpec
            edges = TelemetrySpec(eta_bins=16).edges_on(device)
            return (tk.lane_histogram(x.abs(), edges),
                    tr.lane_histogram_ref(x.abs(), edges), 0.0, 0.0)
        return (tk.lane_quantiles(x, Q=11), tr.lane_quantiles_ref(x, Q=11),
                0.0, 0.0)
    return run


# ---------------------------------------------------------- flash_attention
def _flash(B, S, H, KV, hd, causal, window, dtype):
    def run(seed, device):
        from repro_torch.kernels.flash_attention import flash_attention as fa
        from repro_torch.kernels.flash_attention.ref import attention_ref
        r = _rng(seed)
        q = _t(r.normal(size=(B, S, H, hd)), device, dtype)
        k = _t(r.normal(size=(B, S, KV, hd)), device, dtype)
        v = _t(r.normal(size=(B, S, KV, hd)), device, dtype)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = attention_ref(q, k, v, causal=causal, window=window)
        tol = 2e-5 if dtype == torch.float32 else 3e-2
        return got, want, tol, tol
    return run


# -------------------------------------------------------------- mamba2_scan
def _mamba2(B, S, H, P, G, N):
    def run(seed, device):
        from repro_torch.kernels.mamba2_scan.ops import ssd_scan
        from repro_torch.kernels.mamba2_scan.ref import ssd_ref
        r = _rng(seed)
        x = _t(r.normal(size=(B, S, H, P)), device)
        dt = _t(r.uniform(0.001, 0.1, (B, S, H)), device)
        A_log = _t(np.log(r.uniform(1, 16, (H,))), device)
        Bm = _t(r.normal(size=(B, S, G, N)), device)
        Cm = _t(r.normal(size=(B, S, G, N)), device)
        y, h = ssd_scan(x, dt, A_log, Bm, Cm)
        yr, hr = ssd_ref(x, dt, A_log, Bm, Cm)
        return (torch.cat([y.reshape(-1), h.reshape(-1)]),
                torch.cat([yr.reshape(-1), hr.reshape(-1)]), 1e-3, 1e-4)
    return run


def _build_matrix() -> Tuple[KernelCell, ...]:
    f32, bf16 = (torch.float32, "f32"), (torch.bfloat16, "bf16")
    cells = []
    for shape in ((7,), (257, 33), (1000,)):
        for dt, dn in (f32, bf16):
            cells.append(KernelCell(
                "delta_sgd", f"norms-{'x'.join(map(str, shape))}-{dn}",
                _delta_norms(shape, dt)))
    for shape in ((5,), (130, 7)):
        for dt, dn in (f32, bf16):
            cells.append(KernelCell(
                "delta_sgd", f"apply-{'x'.join(map(str, shape))}-{dn}",
                _delta_apply(shape, dt)))
    for C, N in ((3, 256), (4, 128)):
        cells.append(KernelCell("delta_sgd", f"bnorms-{C}x{N}",
                                _delta_batched_norms(C, N)))
    for C, N, masked in ((3, 256, False), (4, 128, True)):
        cells.append(KernelCell(
            "delta_sgd", f"bapply-{C}x{N}{'-mask' if masked else ''}",
            _delta_batched_apply(C, N, masked)))
    for kind in ("int8", "topk"):
        for C, chunks in ((2, 3), (3, 5)):
            cells.append(KernelCell("compress", f"{kind}-{C}x{chunks}",
                                    _compress(kind, C, chunks)))
    for C, N, t in ((5, 256, 1), (8, 128, 2)):
        cells.append(KernelCell("robust_agg", f"trimmed-{C}x{N}-t{t}",
                                _trimmed(C, N, t)))
    for which, n in (("hist", 257), ("hist", 64), ("quant", 77),
                     ("quant", 130)):
        cells.append(KernelCell("telemetry", f"{which}-{n}",
                                _telemetry(which, n)))
    for args in ((1, 64, 2, 2, 16, True, 16),
                 (1, 128, 4, 1, 64, True, None),     # MQA
                 (2, 128, 4, 4, 32, False, None)):   # bidirectional
        for dt, dn in (f32, bf16):
            B, S, H, KV, hd, causal, window = args
            cells.append(KernelCell(
                "flash_attention",
                f"{B}x{S}x{H}x{KV}x{hd}-{'c' if causal else 'b'}"
                f"{f'-w{window}' if window else ''}-{dn}",
                _flash(*args, dt)))
    for args in ((1, 64, 2, 16, 1, 8), (2, 64, 4, 32, 1, 16)):
        cells.append(KernelCell(
            "mamba2_scan", "ssd-" + "x".join(map(str, args)),
            _mamba2(*args)))
    return tuple(cells)


KERNEL_MATRIX: Tuple[KernelCell, ...] = _build_matrix()


def cells_for(ns: str) -> Tuple[KernelCell, ...]:
    return tuple(c for c in KERNEL_MATRIX if c.ns == ns)


def host_f32(x: torch.Tensor) -> np.ndarray:
    """A cell's output as a numpy f32 array."""
    return x.detach().to(torch.float32).cpu().numpy()


def check_cell(cell: KernelCell, seed: int = 0,
               device: str = "cpu") -> List[str]:
    """Violation strings for one cell on ``device`` (empty = the kernel
    agrees with its plain version at the cell's tolerance)."""
    got, want, rtol, atol = cell.run(seed, device)
    g, w = host_f32(got), host_f32(want)
    if g.shape != w.shape:
        return [f"{cell.key}: shape {g.shape} vs {w.shape}"]
    if rtol == 0.0 and atol == 0.0:
        ok = np.array_equal(g, w, equal_nan=True)
    else:
        ok = np.allclose(g, w, rtol=rtol, atol=atol, equal_nan=True)
    if ok:
        return []
    return [f"{cell.key}: max|Δ|={float(np.nanmax(np.abs(g - w))):.3e} "
            f"(rtol={rtol:g} atol={atol:g})"]
