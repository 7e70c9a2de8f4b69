"""The Mamba2 (SSD) mixer. Port of the Mamba2 part of
``repro/models/ssm.py``; mLSTM and sLSTM are not ported yet (ROADMAP
A15).

  mamba2_full(params, x, cfg, build_cache=...) -> (y, cache|None)  prefill
  mamba2_step(params, x, cfg, cache)           -> (y, cache)       decode

The full mode runs the SSD chunked algorithm on one of two routes,
chosen by the caller with ``use_pallas`` (the reference's keyword).
True, the default, goes through ``kernels/mamba2_scan/ops.ssd_scan``:
on the card its intra-chunk part is the CUDA kernel, on the CPU the
kernel's plain version; the inter-chunk state combine is plain torch.
Serving takes it. False takes ``_ssd_chunked``, the reference's plain
chunked scan, which autograd and ``torch.func`` differentiate; training
takes it, as the reference's does (the kernel wrapper refuses tensors
that require grad). The step mode is the O(1) recurrence in plain
torch, as the reference's jnp.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba2_scan.ops import ssd_scan
from repro_torch.models.common import (dense_init, ones_init, rmsnorm,
                                       zeros_init)


def mamba2_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_in // P
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    return d_in, H, P, G, N


def init_mamba2(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    D = cfg.d_model
    d_in, H, P, G, N = mamba2_dims(cfg)
    conv_ch = d_in + 2 * G * N
    dev = gen.device
    # dt bias: softplus^-1 of dt ~ U[1e-3, 1e-1] on a log scale (mamba2)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((H,), generator=gen, device=dev) * (hi - lo) + lo
    dt = torch.exp(u)
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    a = torch.rand((H,), generator=gen, device=dev) * 15.0 + 1.0
    return {
        "w_zx": dense_init(gen, (D, d_in + conv_ch), dtype, fan_in=D),
        "w_dt": dense_init(gen, (D, H), dtype, fan_in=D),
        "dt_bias": dt_bias.to(dtype),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_ch), dtype,
                             fan_in=cfg.ssm_conv),
        "conv_b": zeros_init(gen, (conv_ch,), dtype),
        "A_log": torch.log(a).to(dtype),
        "D_skip": ones_init(gen, (H,), dtype),
        "norm": ones_init(gen, (d_in,), dtype),
        "w_out": dense_init(gen, (d_in, D), dtype, fan_in=d_in),
    }


def _causal_conv_full(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """x: (B,S,C) depthwise causal conv, kernel (K,C)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
    return out + b


def _chunk_len(S: int, target: int = 64) -> int:
    """The largest chunk length ≤ target that divides S."""
    for c in range(min(target, S), 0, -1):
        if S % c == 0:
            return c
    return 1


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 64):
    """The SSD scan by chunks, in plain torch (the reference's
    ``_ssd_chunked``). xh: (B,S,H,P), dt: (B,S,H), A_log: (H,),
    Bm/Cm: (B,S,G,N).

      h_t = exp(dA_t)·h_{t−1} + dt_t·x_t⊗B_t ;   y_t = C_t·h_t

    The intra-chunk term is a masked (L, L) product, the chunks' states
    are combined in order. Returns (y (B,S,H,P) in xh's dtype, h_final
    (B,H,P,N) f32). The cumulative sum is ``torch.cumsum`` (on the CPU
    it accumulates in f64, where XLA sums in f32)."""
    B, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = _chunk_len(S, chunk)
    nc = S // L
    rep = H // G
    dA = dt.float() * (-torch.exp(A_log.float()))          # (B,S,H) <= 0

    def rs(t):  # (B,S,...) -> (nc,B,L,...)
        return t.reshape(B, nc, L, *t.shape[2:]).movedim(1, 0)

    xc = rs(xh.float())                                     # (nc,B,L,H,P)
    dtc = rs(dt.float())                                    # (nc,B,L,H)
    Bh = rs(Bm.float().repeat_interleave(rep, dim=2))       # (nc,B,L,H,N)
    Ch = rs(Cm.float().repeat_interleave(rep, dim=2))
    cs = torch.cumsum(rs(dA), dim=2)                        # (nc,B,L,H)

    # intra-chunk: M[q,k] = (C_q·B_k)·exp(cs_q − cs_k)·dt_k for k ≤ q.
    # The mask goes in before the exp (the reference masks after it): the
    # same values, but above the diagonal cs_q − cs_k > 0 can overflow
    # exp to inf, and there the reference's gradient is 0·inf = NaN
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]      # (nc,B,q,k,H)
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=xh.device))
    decay = torch.exp(torch.where(tril[None, None, :, :, None], diff,
                                  float("-inf")))
    CB = torch.einsum("cbqhn,cbkhn->cbqkh", Ch, Bh)
    M = CB * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("cbqkh,cbkhp->cbqhp", M, xc)

    # per-chunk summary state: S_c = Σ_k exp(cs_L − cs_k)·dt_k·B_k⊗x_k
    w_end = torch.exp(cs[:, :, -1:, :] - cs) * dtc          # (nc,B,L,H)
    S_c = torch.einsum("cbkh,cbkhn,cbkhp->cbhpn", w_end, Bh, xc)
    chunk_decay = torch.exp(cs[:, :, -1, :])                # (nc,B,H)

    # the chunks' states in order; each chunk reads the state before it
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = chunk_decay[c][:, :, None, None] * h + S_c[c]
    h_prev = torch.stack(h_prev)                            # (nc,B,H,P,N)
    y_inter = torch.einsum("cbqhn,cbhpn,cbqh->cbqhp", Ch, h_prev,
                           torch.exp(cs))
    y = (y_intra + y_inter).movedim(0, 1).reshape(B, S, H, P)
    return y.to(xh.dtype), h


def _split_conv(xc: torch.Tensor, d_in: int, G: int, N: int):
    """The conv output -> (x, B, C) with B and C by group."""
    lead = xc.shape[:-1]
    Bm = xc[..., d_in:d_in + G * N].reshape(*lead, G, N)
    Cm = xc[..., d_in + G * N:].reshape(*lead, G, N)
    return xc[..., :d_in], Bm, Cm


def mamba2_full(params: dict, x: torch.Tensor, cfg, *,
                build_cache: bool = False, use_pallas: bool = True):
    """x: (B,S,D). Returns (out (B,S,D), {"ssm", "conv"} | None).
    ``use_pallas``: the SSD chunk kernel (True) or ``_ssd_chunked``."""
    B, S, D = x.shape
    d_in, H, P, G, N = mamba2_dims(cfg)
    zx = torch.einsum("bsd,de->bse", x, params["w_zx"])
    z, xc = zx[..., :d_in], zx[..., d_in:]
    xc = F.silu(_causal_conv_full(xc, params["conv_w"], params["conv_b"]))
    xs, Bm, Cm = _split_conv(xc, d_in, G, N)
    xs = xs.reshape(B, S, H, P)
    dt = F.softplus(torch.einsum("bsd,dh->bsh", x, params["w_dt"]).float()
                    + params["dt_bias"].float())
    scan = ssd_scan if use_pallas else _ssd_chunked
    y, h_fin = scan(xs, dt, params["A_log"], Bm, Cm)
    y = y + xs * params["D_skip"].to(x.dtype)[None, None, :, None]
    y = rmsnorm(y.reshape(B, S, d_in) * F.silu(z), params["norm"])
    out = torch.einsum("bse,ed->bsd", y, params["w_out"])
    cache = None
    if build_cache:
        K = cfg.ssm_conv
        tail = zx[..., d_in:]
        tail = (tail[:, S - (K - 1):, :] if S >= K - 1
                else F.pad(tail, (0, 0, K - 1 - S, 0)))
        cache = {"ssm": h_fin.to(x.dtype), "conv": tail}
    return out, cache


def mamba2_step(params: dict, x: torch.Tensor, cfg, cache: dict):
    """x: (B,1,D). cache: ssm (B,H,P,N), conv (B,K−1,conv_ch)."""
    B = x.shape[0]
    d_in, H, P, G, N = mamba2_dims(cfg)
    zx = torch.einsum("bsd,de->bse", x, params["w_zx"])[:, 0]
    z, xc_new = zx[..., :d_in], zx[..., d_in:]
    conv_in = torch.cat([cache["conv"], xc_new[:, None, :]], dim=1)
    xc = (torch.einsum("bkc,kc->bc", conv_in, params["conv_w"])
          + params["conv_b"])
    xs, Bm, Cm = _split_conv(F.silu(xc), d_in, G, N)
    xs = xs.reshape(B, H, P)
    dt = F.softplus(torch.einsum("bd,dh->bh", x[:, 0], params["w_dt"])
                    .float() + params["dt_bias"].float())
    dA = torch.exp(dt * (-torch.exp(params["A_log"].float())))
    rep = H // G
    Bh = Bm.repeat_interleave(rep, dim=1).float()            # (B,H,N)
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    h = cache["ssm"].float()
    h = dA[:, :, None, None] * h + torch.einsum(
        "bh,bhp,bhn->bhpn", dt, xs.float(), Bh)
    y = torch.einsum("bhpn,bhn->bhp", h, Ch).to(x.dtype)
    y = y + xs * params["D_skip"].to(x.dtype)[None, :, None]
    y = rmsnorm(y.reshape(B, d_in) * F.silu(z), params["norm"])
    out = torch.einsum("be,ed->bd", y, params["w_out"])[:, None, :]
    return out, {"ssm": h.to(cache["ssm"].dtype), "conv": conv_in[:, 1:]}


def init_mamba2_cache(cfg, B: int, dtype: torch.dtype, device) -> dict:
    d_in, H, P, G, N = mamba2_dims(cfg)
    conv_ch = d_in + 2 * G * N
    return {"ssm": torch.zeros((B, H, P, N), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((B, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                                device=device)}
