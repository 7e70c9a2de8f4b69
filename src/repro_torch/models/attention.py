"""GQA and MLA attention and their ring-buffer caches. Port of
``repro/models/attention.py`` but its cross-attention.

Two modes:
  * full : whole-sequence causal attention (prefill, the full forward).
           Two routes, chosen by the caller with ``use_pallas`` (the
           reference's keyword): True, the default, takes the
           flash-attention kernel wrapper (on the card the CUDA kernel,
           on the CPU its plain version), as serving always has; False
           takes ``_sdpa``, the reference's query-chunked attention in
           plain torch, which autograd and ``torch.func`` differentiate.
           Training takes it, as the reference's trains through its
           ``_sdpa``: the kernel wrapper refuses tensors that require
           grad, and the reference cannot differentiate its kernel
           either.
  * step : one new token per row against the cache (decode), in plain
           torch, as the reference does it in jnp.

MLA (DeepSeek-V3) caches only its latent (``c_kv``) and the shared rope
key; its full form expands per-head K and V and runs ``_sdpa`` whatever
``use_pallas`` says, as the reference's does: its qk head dim (nope +
rope, 192 at full width) passes the flash kernel's largest. Its decode
step absorbs the key up-projection into the query and attends against
the latent cache directly.

Cross-attention and the int8 KV cache are not ported yet (ROADMAP A15).
The cache is written out of place, as JAX does: the serving engine
keeps the old state of rows that did not decode.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention)
from repro_torch.models.common import (apply_rope, dense_init, ones_init,
                                       rmsnorm, zeros_init)

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


def init_mla(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    D, H = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": dense_init(gen, (D, qr), dtype, fan_in=D),
        "q_norm": ones_init(gen, (qr,), dtype),
        "wq_b": dense_init(gen, (qr, H, dn + dr), dtype, fan_in=qr),
        "wkv_a": dense_init(gen, (D, kvr + dr), dtype, fan_in=D),
        "kv_norm": ones_init(gen, (kvr,), dtype),
        "wk_b": dense_init(gen, (kvr, H, dn), dtype, fan_in=kvr),
        "wv_b": dense_init(gen, (kvr, H, dv), dtype, fan_in=kvr),
        "wo": dense_init(gen, (H, dv, D), dtype, fan_in=H * dv),
    }


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


# queries are processed in _NQ_TARGET chunks when S is a multiple of it
# and at least 2048 (the reference's rule), so the (S, T) scores are
# never whole
_NQ_TARGET = 8


def _sdpa_block(qc: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                rows: torch.Tensor, *,
                window: Optional[int]) -> torch.Tensor:
    """Causal. qc: (B,L,H,hd), k/v: (B,T,H,hd), rows: (L,) absolute
    positions."""
    scale = 1.0 / math.sqrt(qc.shape[-1])
    T = k.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", qc.float(), k.float()) * scale
    cols = torch.arange(T, device=qc.device)[None, :]
    mask = cols <= rows[:, None]
    if window is not None:
        mask = mask & ((rows[:, None] - cols) < window)
    scores = torch.where(mask[None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", w, v.float())
    return out.to(v.dtype)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          window: Optional[int] = None) -> torch.Tensor:
    """Causal attention, q: (B,S,KV,G,hd), k/v: (B,S,KV,hd) ->
    (B,S,KV,G,hd). K and V are repeated to the H = KV·G heads; the
    queries run in chunks of S/_NQ_TARGET rows at S ≥ 2048 (a Python
    loop where the reference scans). The reference's non-causal and
    query-offset cases have no caller here, and its bf16-softmax switch
    (off by default) is not ported."""
    B, S, KV, G, hd = q.shape
    H = KV * G
    qq = q.reshape(B, S, H, hd)
    kk = k.repeat_interleave(G, dim=2) if G > 1 else k
    vv = v.repeat_interleave(G, dim=2) if G > 1 else v
    nq = _NQ_TARGET if (S % _NQ_TARGET == 0 and S >= 2048) else 1
    L = S // nq
    outs = [_sdpa_block(qq[:, c * L:(c + 1) * L], kk, vv,
                        c * L + torch.arange(L, device=q.device),
                        window=window) for c in range(nq)]
    out = outs[0] if nq == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, S, KV, G, v.shape[-1])


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
             build_cache: bool = False, use_pallas: bool = True):
    """x: (B,S,D). Returns (out (B,S,D), {"k", "v"} (B,S,KV,hd) | None).
    ``use_pallas``: the flash-attention kernel (True) or ``_sdpa``."""
    q, k, v = _qkv(params, x, cfg, positions)
    if use_pallas:
        out = flash_attention(q.contiguous(), k.contiguous(),
                              v.contiguous(), causal=True, window=window)
    else:
        B, S, H, hd = q.shape
        out = _sdpa(q.reshape(B, S, cfg.num_kv_heads, H // cfg.num_kv_heads,
                              hd), k, v, window=window).reshape(B, S, H, hd)
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): compressed KV latent cache
# ---------------------------------------------------------------------------
def _mla_proj(params: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """-> (q_nope (B,S,H,dn), q_rope (B,S,H,dr), latent c_kv (B,S,kvr),
    k_rope (B,S,1,dr)), rope applied at ``positions``."""
    dn, kvr = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    cq = rmsnorm(torch.einsum("bsd,dr->bsr", x, params["wq_a"]),
                 params["q_norm"])
    q = torch.einsum("bsr,rhk->bshk", cq, params["wq_b"])   # (B,S,H,dn+dr)
    kv = torch.einsum("bsd,dr->bsr", x, params["wkv_a"])     # (B,S,kvr+dr)
    c_kv = rmsnorm(kv[..., :kvr], params["kv_norm"])
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    k_rope = apply_rope(kv[..., kvr:][:, :, None, :], positions,
                        cfg.rope_theta)
    return q[..., :dn], q_rope, c_kv, k_rope


def mla_full(params: dict, x: torch.Tensor, cfg, *,
             positions: torch.Tensor, window: Optional[int] = None,
             build_cache: bool = False, use_pallas: bool = True):
    """Expanded form (prefill, the full forward); the cache holds the
    latent only. ``use_pallas`` is taken and ignored, as the
    reference's is. Returns (out (B,S,D), {"c_kv", "k_rope"} | None)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_proj(params, x, cfg, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["wk_b"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, params["wv_b"])
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    out = _sdpa(qf.reshape(B, S, H, 1, dn + dr), kf, v,
                window=window).reshape(B, S, H, dv)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, ({"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}
               if build_cache else None)


def mla_step(params: dict, x: torch.Tensor, cfg, cache: dict, *,
             t: torch.Tensor, slot: torch.Tensor,
             positions_buf: torch.Tensor, window: Optional[int] = None):
    """Absorbed decode form: the query absorbs W_uk and attends against
    the latent cache (c_kv (B,W,kvr), k_rope (B,W,dr)) without expanding
    per-head K/V over the history. t, slot, positions_buf as in
    :func:`gqa_step`."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope, c_new, kr_new = _mla_proj(params, x, cfg, t[:, None])
    c_kv = _cache_write(cache["c_kv"], c_new, slot)
    k_rope = _cache_write(cache["k_rope"], kr_new[:, :, 0, :], slot)
    q_abs = torch.einsum("bshk,rhk->bhr", q_nope, params["wk_b"])
    scores = (torch.einsum("bhr,btr->bht", q_abs.float(), c_kv.float())
              + torch.einsum("bshk,btk->bht", q_rope.float(),
                             k_rope.float()))
    scores = scores * (1.0 / math.sqrt(dn + dr))
    tt = t[:, None]
    valid = (positions_buf >= 0) & (positions_buf <= tt)
    if window is not None:
        valid &= (tt - positions_buf) < window
    w = torch.softmax(torch.where(valid[:, None, :], scores, NEG_INF),
                      dim=-1)
    ctx = torch.einsum("bht,btr->bhr", w, c_kv.float())
    out = torch.einsum("bhr,rhk->bhk", ctx.to(x.dtype), params["wv_b"])
    y = torch.einsum("bhk,hkd->bd", out, params["wo"])[:, None, :]
    return y, {"c_kv": c_kv, "k_rope": k_rope}


def init_mla_cache(cfg, B: int, cache_len: int, dtype: torch.dtype,
                   device) -> dict:
    return {"c_kv": torch.zeros((B, cache_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((B, cache_len, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}
