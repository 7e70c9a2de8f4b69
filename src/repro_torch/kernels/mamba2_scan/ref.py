"""Plain PyTorch version of the Mamba2 SSD chunk kernel.

The reference computes the same per-chunk quantities inside its Pallas
kernel (``repro/kernels/mamba2_scan/mamba2_scan.py``) and its plain
``models/ssm.py _ssd_chunked``. The wrapper in ``mamba2_scan.py`` uses
this version for CPU tensors; the tests and ``chip_smoke.py`` hold the
CUDA kernel against it. The cumulative sum runs in order in f32, one
step after the other, as the kernel takes it (``torch.cumsum`` on the
CPU accumulates in f64, and on the card in another order).
"""
from __future__ import annotations

import torch


def ssd_chunks_ref(x: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, chunk: int):
    """x: (B,S,H,P), dt/dA: (B,S,H), Bm/Cm: (B,S,G,N), all f32, S a
    multiple of ``chunk``. Returns (y_intra (B,S,H,P), S_c
    (B,nc,H,P,N), chunk_decay (B,nc,H), exp_cs (B,S,H)), all f32."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L, rep = chunk, H // G
    nc = S // L

    def rs(t):   # (B, S, ...) -> (B, nc, L, ...)
        return t.float().reshape(B, nc, L, *t.shape[2:])

    xc, dtc, dAc, Bc, Cc = rs(x), rs(dt), rs(dA), rs(Bm), rs(Cm)
    cs = torch.empty_like(dAc)
    acc = torch.zeros_like(dAc[:, :, 0])
    for q in range(L):
        acc = acc + dAc[:, :, q]
        cs[:, :, q] = acc
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]      # (B,nc,q,k,H)
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    decay = torch.where(tril[None, None, :, :, None], torch.exp(diff), 0.0)
    CB = torch.einsum("bcqgn,bckgn->bcqkg", Cc, Bc)
    CB = CB.repeat_interleave(rep, dim=-1)                  # (B,nc,q,k,H)
    M = CB * decay * dtc[:, :, None, :, :]
    y = torch.einsum("bcqkh,bckhp->bcqhp", M, xc)
    w = torch.exp(cs[:, :, -1:, :] - cs) * dtc               # (B,nc,L,H)
    xw = (xc * w[..., None]).reshape(B, nc, L, G, rep, P)
    S_c = torch.einsum("bckgrp,bckgn->bcgrpn", xw, Bc)
    return (y.reshape(B, S, H, P), S_c.reshape(B, nc, H, P, N),
            torch.exp(cs[:, :, -1, :]), torch.exp(cs).reshape(B, S, H))
