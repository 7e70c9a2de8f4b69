"""Plain PyTorch version of the flash-attention kernel.

Port of ``repro/kernels/flash_attention/ref.py``: causal (optionally
sliding-window) GQA attention with a full-precision softmax. The wrapper
in ``flash_attention.py`` uses it for CPU tensors; the tests and
``chip_smoke.py`` hold the CUDA kernel against it. Queries are taken in
blocks of ``BLOCK_Q`` rows (as the reference's plain ``_sdpa`` path takes
them in chunks), so the score matrix held at once is (B, KV, G,
BLOCK_Q, T), not (B, KV, G, S, T); every row's softmax is still taken
over all T keys in one piece.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
BLOCK_Q = 256


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,T,KV,hd), H % KV == 0. Returns (B,S,H,hd)
    in q's dtype."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    kf, vf = k.float(), v.float()
    cols = torch.arange(T, device=q.device)
    out = []
    for r0 in range(0, S, BLOCK_Q):
        qc = qg[:, r0:r0 + BLOCK_Q]
        rows = torch.arange(r0, r0 + qc.shape[1], device=q.device)
        scores = torch.einsum("bskgh,btkh->bkgst", qc, kf) / math.sqrt(hd)
        mask = torch.ones((rows.shape[0], T), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= cols[None, :] <= rows[:, None]
        if window is not None:
            mask &= (rows[:, None] - cols[None, :]) < window
        scores = torch.where(mask, scores, NEG_INF)
        w = torch.softmax(scores, dim=-1)
        out.append(torch.einsum("bkgst,btkh->bskgh", w, vf))
    return torch.cat(out, dim=1).reshape(B, S, H, hd).to(q.dtype)
