"""The full SSD scan: the intra-chunk kernel plus the inter-chunk state
combine in plain PyTorch. Port of ``repro/kernels/mamba2_scan/ops.py``;
``models/ssm.py mamba2_full`` calls it."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.mamba2_scan.mamba2_scan import CHUNK, ssd_chunks


def chunk_len(S: int, chunk: int = CHUNK) -> int:
    """The reference's rule: the largest L <= min(chunk, S) dividing S."""
    L = min(chunk, S)
    while S % L:
        L -= 1
    return L


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             h0: Optional[torch.Tensor] = None, *, chunk: int = CHUNK):
    """x: (B,S,H,P), dt: (B,S,H) (post-softplus), A_log: (H,),
    Bm/Cm: (B,S,G,N).

    Returns (y: (B,S,H,P) in x.dtype, h_final: (B,H,P,N) f32)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    f32 = torch.float32
    dtf = dt.to(f32).contiguous()
    dA = (dtf * (-torch.exp(A_log.to(f32)))).contiguous()
    L = chunk_len(S, chunk)
    nc = S // L
    Cf = Cm.to(f32).contiguous()
    y_intra, S_c, cd, ecs = ssd_chunks(
        x.to(f32).contiguous(), dtf, dA, Bm.to(f32).contiguous(), Cf,
        chunk=L)

    h = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    h_prev = []
    for c in range(nc):        # h <- cd·h + S_c, keeping the state before
        h_prev.append(h)
        h = cd[:, c, :, None, None] * h + S_c[:, c]
    h_prev = torch.stack(h_prev, dim=1).reshape(B, nc, G, rep, P, N)

    # inter-chunk readout: y_q += C_q · h_prev(chunk(q)) · exp(cs_q)
    y_inter = torch.einsum("bcqgn,bcgrpn->bcqgrp",
                           Cf.reshape(B, nc, L, G, N), h_prev)
    y_inter = y_inter.reshape(B, nc, L, H, P) * ecs.reshape(
        B, nc, L, H)[..., None]
    y = y_intra + y_inter.reshape(B, S, H, P)
    return y.to(x.dtype), h
