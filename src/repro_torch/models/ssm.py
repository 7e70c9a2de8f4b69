"""The Mamba2 (SSD) mixer. Port of the Mamba2 part of
``repro/models/ssm.py``; mLSTM and sLSTM are not ported yet (ROADMAP
A15).

  mamba2_full(params, x, cfg, build_cache=...) -> (y, cache|None)  prefill
  mamba2_step(params, x, cfg, cache)           -> (y, cache)       decode

The full mode runs the SSD chunked algorithm through
``kernels/mamba2_scan/ops.ssd_scan``: on the card its intra-chunk part is
the CUDA kernel, on the CPU the kernel's plain version; the inter-chunk
state combine is plain torch. There is no flag. The step mode is the
O(1) recurrence in plain torch, as the reference's jnp.
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


def _split_conv(xc: torch.Tensor, d_in: int, G: int, N: int):
    """The conv output -> (x, B, C) with B and C by group."""
    lead = xc.shape[:-1]
    Bm = xc[..., d_in:d_in + G * N].reshape(*lead, G, N)
    Cm = xc[..., d_in + G * N:].reshape(*lead, G, N)
    return xc[..., :d_in], Bm, Cm


def mamba2_full(params: dict, x: torch.Tensor, cfg, *,
                build_cache: bool = False):
    """x: (B,S,D). Returns (out (B,S,D), {"ssm", "conv"} | None)."""
    B, S, D = x.shape
    d_in, H, P, G, N = mamba2_dims(cfg)
    zx = torch.einsum("bsd,de->bse", x, params["w_zx"])
    z, xc = zx[..., :d_in], zx[..., d_in:]
    xc = F.silu(_causal_conv_full(xc, params["conv_w"], params["conv_b"]))
    xs, Bm, Cm = _split_conv(xc, d_in, G, N)
    xs = xs.reshape(B, S, H, P)
    dt = F.softplus(torch.einsum("bsd,dh->bsh", x, params["w_dt"]).float()
                    + params["dt_bias"].float())
    y, h_fin = ssd_scan(xs, dt, params["A_log"], Bm, Cm)
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
