"""Plain PyTorch version of the Mamba2 SSD chunk kernel.

The reference computes the same per-chunk quantities inside its Pallas
kernel (``repro/kernels/mamba2_scan/mamba2_scan.py``) and its plain
``models/ssm.py _ssd_chunked``. ``ssd_ref`` is the port of the
reference's ``ref.ssd_ref``: the whole scan as the naive sequential
recurrence, which the kernel parity matrix holds ``ops.ssd_scan``
against. The wrapper in ``mamba2_scan.py`` uses ``ssd_chunks_ref`` for
CPU tensors; the tests and ``chip_smoke.py`` hold the
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


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor, h0=None):
    """The naive sequential recurrence in f32:
    ``h_t = exp(dt_t·A)·h_{t−1} + dt_t·x_t⊗B_t``, ``y_t = C_t·h_t``.
    x: (B,S,H,P), dt: (B,S,H) (post-softplus), A_log: (H,), Bm/Cm:
    (B,S,G,N). Returns (y (B,S,H,P), h_final (B,H,P,N))."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    f32 = torch.float32
    x, dt = x.to(f32), dt.to(f32)
    Bh = Bm.to(f32).repeat_interleave(rep, dim=2)          # (B,S,H,N)
    Ch = Cm.to(f32).repeat_interleave(rep, dim=2)
    dA = dt * (-torch.exp(A_log.to(f32)))                  # (B,S,H)
    h = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    ys = []
    for t in range(S):
        h = torch.exp(dA[:, t])[:, :, None, None] * h + torch.einsum(
            "bh,bhp,bhn->bhpn", dt[:, t], x[:, t], Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    return torch.stack(ys, dim=1), h
