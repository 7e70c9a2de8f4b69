"""GQA attention and its ring-buffer KV cache. Port of the GQA part of
``repro/models/attention.py``.

Two modes:
  * full : whole-sequence causal attention (prefill, the full forward),
           through the flash-attention kernel wrapper: on the card the
           CUDA kernel, on the CPU its plain version. There is no flag.
  * step : one new token per row against the cache (decode), in plain
           torch, as the reference does it in jnp.

MLA, cross-attention and the int8 KV cache are not ported yet (ROADMAP
A15). The cache is written out of place, as JAX does: the serving
engine keeps the old state of rows that did not decode.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention)
from repro_torch.models.common import apply_rope, dense_init, zeros_init

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (D, H, hd), dtype, fan_in=D),
        "wk": dense_init(gen, (D, KV, hd), dtype, fan_in=D),
        "wv": dense_init(gen, (D, KV, hd), dtype, fan_in=D),
        "wo": dense_init(gen, (H, hd, D), dtype, fan_in=H * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_init(gen, (H, hd), dtype)
        p["bk"] = zeros_init(gen, (KV, hd), dtype)
        p["bv"] = zeros_init(gen, (KV, hd), dtype)
    return p


def _qkv(params: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Single-block SDPA with an explicit mask (decode: S = 1).
    q: (B,S,KV,G,hd), k/v: (B,T,KV,hd), mask broadcast to
    (B,KV,G,S,T)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) * scale
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.to(v.dtype)


def gqa_full(params: dict, x: torch.Tensor, cfg, *,
             positions: torch.Tensor, window: Optional[int] = None,
             build_cache: bool = False):
    """x: (B,S,D). Returns (out (B,S,D), {"k", "v"} (B,S,KV,hd) | None)."""
    q, k, v = _qkv(params, x, cfg, positions)
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=True, window=window)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, ({"k": k, "v": v} if build_cache else None)


def _cache_write(buf: torch.Tensor, val: torch.Tensor,
                 slot: torch.Tensor) -> torch.Tensor:
    """Row b of the (B, W, ...) ring buffer stores ``val[b, 0]`` at its
    own index ``slot[b]``; returns a new buffer."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    return buf.index_put((rows, slot.long()), val[:, 0])


def gqa_step(params: dict, x: torch.Tensor, cfg, cache: dict, *,
             t: torch.Tensor, slot: torch.Tensor,
             positions_buf: torch.Tensor, window: Optional[int] = None):
    """One decode step. x: (B,1,D); cache k/v: (B,W,KV,hd) ring buffers.

    t, slot: (B,) absolute position of each row's new token and its
    write index; positions_buf: (B,W) absolute position held by each
    slot (−1 = empty), already updated for this step. Every row decodes
    at its own position and masks against its own positions."""
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _qkv(params, x, cfg, t[:, None])
    kd = _cache_write(cache["k"], k, slot)
    vd = _cache_write(cache["v"], v, slot)
    tt = t[:, None]
    valid = (positions_buf >= 0) & (positions_buf <= tt)
    if window is not None:
        valid &= (tt - positions_buf) < window
    qg = q.reshape(B, 1, KV, H // KV, hd)
    out = _sdpa_masked(qg, kd, vd, valid[:, None, None, None, :])
    y = torch.einsum("bshk,hkd->bsd", out.reshape(B, 1, H, hd), params["wo"])
    return y, {"k": kd, "v": vd}


def init_gqa_cache(cfg, B: int, cache_len: int, dtype: torch.dtype,
                   device) -> dict:
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((B, cache_len, KV, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((B, cache_len, KV, hd), dtype=dtype,
                             device=device)}
