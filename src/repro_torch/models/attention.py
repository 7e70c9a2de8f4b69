"""GQA, MLA and cross-attention, and the ring-buffer caches. Port of
``repro/models/attention.py``.

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

Cross-attention (the Whisper decoder) reads K and V that ``cross_kv``
computes once from the encoder output; ``cross_attend`` runs the plain
``_sdpa`` without a causal mask, as the reference does (the flash
kernel keeps its refusal of non-causal attention). Under rules both
take GQA's tensor-parallel branch (the ``xattn/*`` rules: query heads
split, KV heads where they divide, ``wo`` row-parallel); the cached
``enc_kv`` holds every KV head of the rank's rows.

The GQA cache has an int8 form (``init_gqa_cache(quant=True)``, reached
through ``Model.init_cache(quant_kv=True)``): int8 K and V entries with
one f16 scale per entry and KV head (``_quantize``: absmax / 127,
rounded half to even), dequantized with the f16 scale at every decode
step, as the reference's is. ``gqa_step`` takes that branch when the
cache holds ``k_scale``. Prefill builds the float cache in both.
The cache is written out of place, as JAX does: the serving engine
keeps the old state of rows that did not decode.

Tensor parallel (GQA under installed logical rules, ``models.common``):
a rank holds its block of ``wq``'s heads and ``wo``'s rows, and of
``wk``/``wv``'s KV heads where the rule shards them (KV divides the
tensor axis); where it leaves them whole, every rank projects all KV
heads and attends with those its query heads read (global head h reads
KV head h // G). The replicated biases are cut to the rank's heads.
``wo``'s rows are the heads, so the output is a partial sum: one
``tp_reduce`` a call. The cache holds every KV head of the rank's batch
rows (the reference's ``cache_shardings`` leaves the KV-head dim
whole): sharded k and v are gathered over the tensor axis, in one
``kv_gather`` a call, before they are cached. Under training rules the
same code differentiates: the block's input enters the rank's heads
through ``tp_enter``, and a replicated leaf the rank reads only in part
(the QKV biases; ``wk``/``wv`` where the KV heads are whole) through
``tp_enter`` too, so its gradient is summed over the tensor axis.

MLA under rules (the reference's rules: ``wq_b``, ``wk_b``, ``wv_b``
split over ``model`` on their head dim, ``wo`` row-parallel): the
latent projections ``wq_a``, ``wkv_a`` and their norms are replicated,
so every rank computes the same ``cq``, ``c_kv`` and ``k_rope`` and
caches the same latent (the cache has no head dim: the reference's
``cache_shardings`` leaves it whole over ``model``); the rank's heads
are expanded from it, and ``wo``'s partial sums are reduced in one
``tp_reduce``. Under training rules the split point is the latent:
``cq``, ``c_kv`` and ``k_rope`` enter the rank's heads in one
``tp_enter`` after the replicated projections, and ``x`` does not
(entering both would count the latent path twice).

The decode on a time block: where the rows do not split over the data
axes (one row, or one data rank), the reference's ``cache_shardings``
cuts the time dim of the GQA K/V and their int8 scales, of MLA's latent
and rope key and of Whisper's cached ``enc_kv`` over ``model``. A rank's
cache then holds its block of the ring's slots (``time_block``): the
rank that owns a row's slot writes the new entry (``_block_write``),
every query head attends the block (the rank's heads gathered,
``seq_q``; MLA gathers its absorbed queries), and the blocks' softmax
parts are combined by the log-sum-exp rule (``_lse_combine``: the max
over ``model``, ``seq_max``, then each rank's rescaled sums and outputs
summed in one collective, ``seq_sum``). The rank keeps its heads'
output for the row-parallel ``wo``. Prefill's cache stays whole over
the sequence; ``launch.steps.place_prefill_cache`` narrows it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention)
from repro_torch.models.common import (apply_rope, dense_init,
                                       get_logical_rules, ones_init,
                                       rmsnorm, shard_logical, tp_enter,
                                       tp_gather, tp_index, tp_reduce,
                                       zeros_init)
from repro_torch.sharding import dist

NEG_INF = -1e30


class Heads(NamedTuple):
    """A rank's heads of a config's ``H``: query heads [h0, h0 + h), the
    KV heads it projects [p0, p0 + p), the KV heads its queries read
    [a0, a0 + a); ``kv_sharded``: its KV projection is its block of the
    tensor axis's. Without rules, every head."""
    h0: int
    h: int
    p0: int
    p: int
    a0: int
    a: int
    kv_sharded: bool
    H: int

    @property
    def partial(self) -> bool:
        """The rank holds a block of the heads, so its output
        projection is a partial sum."""
        return self.h < self.H


def heads_of(params: dict, cfg) -> Heads:
    """This rank's heads, read from its local ``wq``/``wk`` shapes."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    h, p = params["wq"].shape[-2], params["wk"].shape[-2]
    if get_logical_rules() is None or (h == H and p == KV):
        return Heads(0, H, 0, KV, 0, KV, False, H)
    t = tp_index()
    h0, G = t * h, H // KV
    if p < KV:
        return Heads(h0, h, t * p, p, t * p, p, True, H)
    # KV whole: the tensor axis does not divide KV, so it splits the
    # groups, and the rank's h heads must lie within one group
    if G % h:
        raise ValueError(f"{h} local query heads of {H} (G = {G}) straddle "
                         "two KV heads: no tensor axis of this size serves "
                         f"{cfg.name}")
    return Heads(h0, h, 0, KV, h0 // G, 1, False, H)


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


def _qkv(params: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
         heads: Optional[Heads] = None):
    """q (B,S,h,hd) and k, v (B,S,p,hd) of ``heads`` (all of them by
    default). Under training rules a replicated leaf that the rank reads
    only in part (the QKV biases narrowed to its heads; ``wk``/``wv``
    where the KV heads are whole and its queries are a block of H) has
    a partial gradient on each rank: it enters through ``tp_enter``,
    whose backward sums it over the tensor axis, so every replica takes
    the same update."""
    partial = heads is not None and heads.partial
    wk, wv = params["wk"], params["wv"]
    if partial and not heads.kv_sharded:
        wk, wv = tp_enter(wk), tp_enter(wv)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, wk)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
    if cfg.qkv_bias:
        bq, bk, bv = params["bq"], params["bk"], params["bv"]
        if partial:
            bq = tp_enter(bq).narrow(0, heads.h0, heads.h)
            bk = tp_enter(bk).narrow(0, heads.p0, heads.p)
            bv = tp_enter(bv).narrow(0, heads.p0, heads.p)
        q, k, v = q + bq, k + bk, v + bv
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# queries are processed in _NQ_TARGET chunks when S is a multiple of it
# and at least 2048 (the reference's rule), so the (S, T) scores are
# never whole
_NQ_TARGET = 8

# the reference's beyond-paper switch (``launch/perf.py``'s
# ``softmax_bf16``): the softmax's probabilities are stored in bf16
# between the two attention products, halving that term's bytes; the
# exponent of the max-subtracted scores keeps them in [0, 1]. Off by
# default
SOFTMAX_BF16 = False


def _sdpa_block(qc: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                rows: torch.Tensor, *, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """qc: (B,L,H,hd), k/v: (B,T,H,hd), rows: (L,) absolute positions.
    The window applies to causal attention; without a causal mask every
    key counts (the reference's all-true mask changes no score)."""
    scale = 1.0 / math.sqrt(qc.shape[-1])
    T = k.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", qc.float(), k.float()) * scale
    if causal:
        cols = torch.arange(T, device=qc.device)[None, :]
        mask = cols <= rows[:, None]
        if window is not None:
            mask = mask & ((rows[:, None] - cols) < window)
        scores = torch.where(mask[None, None], scores, NEG_INF)
    if SOFTMAX_BF16:
        # bf16 probabilities into a bf16 product; their f32 sum divides
        # the result
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores - m).to(torch.bfloat16)
        denom = p.sum(dim=-1, keepdim=True, dtype=torch.float32)
        out = torch.einsum("bhst,bthd->bshd", p,
                           v.to(torch.bfloat16)).float()
        return (out / denom.transpose(1, 2)).to(v.dtype)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", w, v.float())
    return out.to(v.dtype)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool = True,
          window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,KV,G,hd), k/v: (B,T,KV,hd) -> (B,S,KV,G,hd); causal
    attention (query row i at position i), or with ``causal=False``
    every query against all T keys (the Whisper encoder, cross-attention).
    K and V are repeated to the H = KV·G heads; the queries run in
    chunks of S/_NQ_TARGET rows at S ≥ 2048 (a Python loop where the
    reference scans). The reference's query offset has no caller here.
    ``SOFTMAX_BF16`` (off by default) stores the probabilities in bf16
    between the two products, as the reference's switch does."""
    B, S, KV, G, hd = q.shape
    H = KV * G
    qq = q.reshape(B, S, H, hd)
    kk = k.repeat_interleave(G, dim=2) if G > 1 else k
    vv = v.repeat_interleave(G, dim=2) if G > 1 else v
    nq = _NQ_TARGET if (S % _NQ_TARGET == 0 and S >= 2048) else 1
    L = S // nq
    outs = [_sdpa_block(qq[:, c * L:(c + 1) * L], kk, vv,
                        c * L + torch.arange(L, device=q.device),
                        causal=causal, window=window) for c in range(nq)]
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


def _attended(k: torch.Tensor, heads: Heads) -> torch.Tensor:
    """The KV heads the rank's queries read, of its projected ``k``."""
    if heads.a0 == heads.p0 and heads.a == heads.p:
        return k
    return k.narrow(2, heads.a0 - heads.p0, heads.a)


def _whole_kv(k: torch.Tensor, v: torch.Tensor, heads: Heads):
    """Every KV head of the rank's rows: a sharded projection is
    gathered over the tensor axis (one ``kv_gather``)."""
    if not heads.kv_sharded:
        return k, v
    kv = tp_gather(torch.stack([k, v]), 3, "kv_gather")
    return kv[0], kv[1]


def _out_proj(out: torch.Tensor, params: dict,
              heads: Heads) -> torch.Tensor:
    """(B,S,h,hd) -> (B,S,D) through ``wo``'s rows of the rank's heads,
    summed over the tensor axis where they are a block of the heads."""
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return tp_reduce(y) if heads.partial else y


def gqa_full(params: dict, x: torch.Tensor, cfg, *,
             positions: torch.Tensor, window: Optional[int] = None,
             build_cache: bool = False, use_pallas: bool = True):
    """x: (B,S,D). Returns (out (B,S,D), {"k", "v"} (B,S,KV,hd) | None).
    ``use_pallas``: the flash-attention kernel (True) or ``_sdpa``.
    Under rules, the rank's heads (``heads_of``) on its rows; under
    training rules ``x`` enters the rank's heads through ``tp_enter``."""
    heads = heads_of(params, cfg)
    if heads.partial:
        x = tp_enter(x)
    q, k, v = _qkv(params, x, cfg, positions, heads)
    B, S, H, dh = q.shape
    shard_logical(q, ("batch", "seq", "heads", None),
                  (None, S, cfg.num_heads, dh))
    ka, va = _attended(k, heads), _attended(v, heads)
    if use_pallas:
        out = flash_attention(q.contiguous(), ka.contiguous(),
                              va.contiguous(), causal=True, window=window)
    else:
        out = _sdpa(q.reshape(B, S, heads.a, H // heads.a, dh), ka, va,
                    window=window).reshape(B, S, H, dh)
    y = _out_proj(out, params, heads)
    if not build_cache:
        return y, None
    k, v = _whole_kv(k, v, heads)
    return y, {"k": k, "v": v}


def _cache_write(buf: torch.Tensor, val: torch.Tensor,
                 slot: torch.Tensor) -> torch.Tensor:
    """Row b of the (B, W, ...) ring buffer stores ``val[b, 0]`` at its
    own index ``slot[b]``; returns a new buffer."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    return buf.index_put((rows, slot.long()), val[:, 0])


def _block_write(buf: torch.Tensor, val: torch.Tensor, slot: torch.Tensor,
                 t0: int) -> torch.Tensor:
    """``_cache_write`` into a rank's time block ``buf``, slots
    [t0, t0 + Wl) of the whole ring: a row whose slot lies outside the
    block keeps its entries (the rank that owns the slot writes it)."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    loc = slot.long() - t0
    mine = (loc >= 0) & (loc < buf.shape[1])
    loc = torch.where(mine, loc, 0)
    keep = buf[rows, loc]
    new = torch.where(mine.view((-1,) + (1,) * (keep.dim() - 1)),
                      val[:, 0].to(buf.dtype), keep)
    return buf.index_put((rows, loc), new)


def time_block(cache_len: int, W: int) -> Optional[int]:
    """The first slot of this rank's block of a ring of ``W`` slots of
    which its cache holds ``cache_len``, or None where it holds them
    all. A block is the reference's ``cache_shardings`` at rows that do
    not split over the data axes: the time dim cut over ``model``."""
    if cache_len == W:
        return None
    return tp_index() * cache_len


def _partials(scores: torch.Tensor):
    """(max, exp(scores − max), their sum) over the last dim of masked
    f32 ``scores``: the rank's part of a softmax over a time block."""
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    return m, p, p.sum(dim=-1, keepdim=True)


def _lse_combine(o: torch.Tensor, m: torch.Tensor,
                 l: torch.Tensor) -> torch.Tensor:
    """The softmax-weighted output over the whole time dim from each
    rank's block: ``o`` its unnormalised output, ``m`` and ``l`` its max
    and sum of exponentials (broadcast to o with a last dim of 1). The
    max over the tensor axis (``seq_max``), then each rank's sums
    rescaled to it and summed in one collective (``seq_sum``), the
    outputs and the sums stacked."""
    rules = get_logical_rules()
    M = dist.max_over(m, rules.mesh, (rules.tp,), role="seq_max")
    a = torch.exp(m - M)
    s = tp_reduce(torch.cat([o * a, l * a], dim=-1), "seq_sum")
    return s[..., :-1] / s[..., -1:]


def _sdpa_time_block(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, mask) -> torch.Tensor:
    """``_sdpa_masked`` on the rank's time block of k/v (B,Wl,KV,hd),
    combined over the tensor axis (``_lse_combine``). q: (B,S,KV,G,hd)
    every query head; mask broadcast to (B,KV,G,S,Wl), or True."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) * scale
    if mask is not True:
        scores = torch.where(mask, scores, NEG_INF)
    m, p, l = _partials(scores)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    lay = lambda t: t.permute(0, 3, 1, 2, 4)        # (B,S,KV,G,1)
    return _lse_combine(o, lay(m), lay(l)).to(v.dtype)


def _all_heads(q: torch.Tensor, heads: Heads) -> torch.Tensor:
    """Every query head of q (B,S,h,hd): the rank's heads gathered over
    the tensor axis where they are a block (``seq_q``)."""
    return tp_gather(q, 2, "seq_q") if heads.partial else q


def gqa_step(params: dict, x: torch.Tensor, cfg, cache: dict, *,
             t: torch.Tensor, slot: torch.Tensor,
             positions_buf: torch.Tensor, window: Optional[int] = None):
    """One decode step. x: (B,1,D); cache k/v: (B,W,KV,hd) ring buffers.

    t, slot: (B,) absolute position of each row's new token and its
    write index; positions_buf: (B,W) absolute position held by each
    slot (−1 = empty), already updated for this step. Every row decodes
    at its own position and masks against its own positions. Under
    rules, the rank's query heads against the KV heads they read; the
    cache holds every KV head of the rank's rows. A cache of Wl < W
    slots is the rank's time block (``time_block``): the rank that owns
    a row's slot writes its new K/V, every query head attends the block
    (``seq_q``), and the blocks' parts are combined over the tensor
    axis (``_sdpa_time_block``); the rank keeps its heads for ``wo``."""
    B = x.shape[0]
    heads = heads_of(params, cfg)
    q, k, v = _qkv(params, x, cfg, t[:, None], heads)
    k, v = _whole_kv(k, v, heads)
    W = positions_buf.shape[-1]
    t0 = time_block(cache["k"].shape[1], W)
    put = (lambda buf, val: _cache_write(buf, val, slot)) if t0 is None \
        else (lambda buf, val: _block_write(buf, val, slot, t0))
    if "k_scale" in cache:
        kq, ks = _quantize(k)
        vq, vs = _quantize(v)
        ck, cv = put(cache["k"], kq), put(cache["v"], vq)
        cks, cvs = put(cache["k_scale"], ks), put(cache["v_scale"], vs)
        kd = (ck.float() * cks.float()[..., None]).to(k.dtype)
        vd = (cv.float() * cvs.float()[..., None]).to(v.dtype)
        new_cache = {"k": ck, "v": cv, "k_scale": cks, "v_scale": cvs}
    else:
        kd, vd = put(cache["k"], k), put(cache["v"], v)
        new_cache = {"k": kd, "v": vd}
    tt = t[:, None]
    valid = (positions_buf >= 0) & (positions_buf <= tt)
    if window is not None:
        valid &= (tt - positions_buf) < window
    H, dh = q.shape[2], q.shape[3]
    if t0 is not None:
        qa = _all_heads(q, heads)
        KV = kd.shape[2]
        mask = valid.narrow(1, t0, kd.shape[1])[:, None, None, None, :]
        out = _sdpa_time_block(qa.reshape(B, 1, KV, heads.H // KV, dh), kd, vd,
                          mask).reshape(B, 1, heads.H, dh)
        out = out.narrow(2, heads.h0, H)
        return _out_proj(out, params, heads), new_cache
    if heads.a < kd.shape[2]:
        kd = kd.narrow(2, heads.a0, heads.a)
        vd = vd.narrow(2, heads.a0, heads.a)
    qg = q.reshape(B, 1, heads.a, H // heads.a, dh)
    out = _sdpa_masked(qg, kd, vd, valid[:, None, None, None, :])
    return _out_proj(out.reshape(B, 1, H, dh), params, heads), new_cache


def init_gqa_cache(cfg, B: int, cache_len: int, dtype: torch.dtype,
                   device, *, quant: bool = False) -> dict:
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    if quant:
        # int8 KV entries and an f16 scale per entry and head: about half
        # the bytes a decode step reads from an f16 cache, a quarter of f32
        i8 = dict(dtype=torch.int8, device=device)
        f16 = dict(dtype=torch.float16, device=device)
        return {"k": torch.zeros((B, cache_len, KV, hd), **i8),
                "v": torch.zeros((B, cache_len, KV, hd), **i8),
                "k_scale": torch.zeros((B, cache_len, KV), **f16),
                "v_scale": torch.zeros((B, cache_len, KV), **f16)}
    return {"k": torch.zeros((B, cache_len, KV, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((B, cache_len, KV, hd), dtype=dtype,
                             device=device)}


def _quantize(x: torch.Tensor):
    """x: (B,1,KV,hd) -> (int8 values, f16 scales (B,1,KV)): the f32
    absmax / 127 per entry and head (at least 1e-8 as a divisor), codes
    rounded half to even."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / torch.clamp(scale, min=1e-8)[..., None]
                    ).to(torch.int8)
    return q, scale.to(torch.float16)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): compressed KV latent cache
# ---------------------------------------------------------------------------
def _mla_split(params: dict, cfg) -> bool:
    """The rank holds a block of MLA's heads (its local ``wq_b`` has
    fewer than H): its output projection is a partial sum."""
    return params["wq_b"].shape[-2] < cfg.num_heads


def _mla_proj(params: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """-> (q_nope (B,S,h,dn), q_rope (B,S,h,dr), latent c_kv (B,S,kvr),
    k_rope (B,S,1,dr)), rope applied at ``positions``; h is the rank's
    heads. The latents (the query's ``cq``, ``c_kv``, ``k_rope``) are
    replicated over the tensor axis; under training rules, where the
    heads are a block, they enter the rank's heads through one
    ``tp_enter`` (their gradients from the rank's heads are partial),
    and the returned ``c_kv``/``k_rope`` are the entered ones."""
    dn, kvr = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    cq = rmsnorm(torch.einsum("bsd,dr->bsr", x, params["wq_a"]),
                 params["q_norm"])
    kv = torch.einsum("bsd,dr->bsr", x, params["wkv_a"])     # (B,S,kvr+dr)
    c_kv = rmsnorm(kv[..., :kvr], params["kv_norm"])
    k_rope = apply_rope(kv[..., kvr:][:, :, None, :], positions,
                        cfg.rope_theta)
    rules = get_logical_rules()
    if rules is not None and not rules.serve and _mla_split(params, cfg):
        qr = cq.shape[-1]
        lat = tp_enter(torch.cat([cq, c_kv, k_rope[:, :, 0, :]], dim=-1))
        cq, c_kv = lat[..., :qr], lat[..., qr:qr + kvr]
        k_rope = lat[..., qr + kvr:][:, :, None, :]
    q = torch.einsum("bsr,rhk->bshk", cq, params["wq_b"])   # (B,S,h,dn+dr)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    return q[..., :dn], q_rope, c_kv, k_rope


def _mla_out(out: torch.Tensor, params: dict, cfg,
             eq: str) -> torch.Tensor:
    """The output projection of the rank's heads, summed over the
    tensor axis where they are a block."""
    y = torch.einsum(eq, out, params["wo"])
    return tp_reduce(y) if _mla_split(params, cfg) else y


def mla_full(params: dict, x: torch.Tensor, cfg, *,
             positions: torch.Tensor, window: Optional[int] = None,
             build_cache: bool = False, use_pallas: bool = True):
    """Expanded form (prefill, the full forward); the cache holds the
    latent only. ``use_pallas`` is taken and ignored, as the
    reference's is. Returns (out (B,S,D), {"c_kv", "k_rope"} | None).
    Under rules, the rank's heads against the whole latent."""
    B, S, _ = x.shape
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_proj(params, x, cfg, positions)
    H = q_nope.shape[2]
    shard_logical(q_nope, ("batch", "seq", "heads", None),
                  (None, S, cfg.num_heads, dn))
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["wk_b"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, params["wv_b"])
    qf = torch.cat([q_nope, q_rope], dim=-1)
    kf = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    out = _sdpa(qf.reshape(B, S, H, 1, dn + dr), kf, v,
                window=window).reshape(B, S, H, dv)
    y = _mla_out(out, params, cfg, "bshk,hkd->bsd")
    return y, ({"c_kv": c_kv, "k_rope": k_rope[:, :, 0, :]}
               if build_cache else None)


def mla_step(params: dict, x: torch.Tensor, cfg, cache: dict, *,
             t: torch.Tensor, slot: torch.Tensor,
             positions_buf: torch.Tensor, window: Optional[int] = None):
    """Absorbed decode form: the query absorbs W_uk and attends against
    the latent cache (c_kv (B,W,kvr), k_rope (B,W,dr)) without expanding
    per-head K/V over the history. t, slot, positions_buf as in
    :func:`gqa_step`. Under rules, the rank's heads against its rows'
    whole latent cache, which every tensor rank writes alike; or against
    the rank's time block of it (``time_block``), whose slot's owner
    writes the new latent: the rank's absorbed queries and rope queries
    are gathered over the tensor axis (``seq_q``), every head attends
    the block, the blocks' parts are combined (``_lse_combine``) and the
    rank keeps its heads' context for ``wv_b`` and ``wo``."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q_nope, q_rope, c_new, kr_new = _mla_proj(params, x, cfg, t[:, None])
    t0 = time_block(cache["c_kv"].shape[1], positions_buf.shape[-1])
    if t0 is None:
        c_kv = _cache_write(cache["c_kv"], c_new, slot)
        k_rope = _cache_write(cache["k_rope"], kr_new[:, :, 0, :], slot)
    else:
        c_kv = _block_write(cache["c_kv"], c_new, slot, t0)
        k_rope = _block_write(cache["k_rope"], kr_new[:, :, 0, :], slot, t0)
    q_abs = torch.einsum("bshk,rhk->bhr", q_nope, params["wk_b"])
    h = q_abs.shape[1]
    if t0 is not None and _mla_split(params, cfg):
        both = tp_gather(torch.cat([q_abs, q_rope[:, 0].to(q_abs.dtype)],
                                   dim=-1), 1, "seq_q")
        q_abs, q_rope = both[..., :-dr], both[:, None, :, -dr:]
    scores = (torch.einsum("bhr,btr->bht", q_abs.float(), c_kv.float())
              + torch.einsum("bshk,btk->bht", q_rope.float(),
                             k_rope.float()))
    scores = scores * (1.0 / math.sqrt(dn + dr))
    tt = t[:, None]
    valid = (positions_buf >= 0) & (positions_buf <= tt)
    if window is not None:
        valid &= (tt - positions_buf) < window
    if t0 is None:
        w = torch.softmax(torch.where(valid[:, None, :], scores, NEG_INF),
                          dim=-1)
        ctx = torch.einsum("bht,btr->bhr", w, c_kv.float())
    else:
        mask = valid.narrow(1, t0, c_kv.shape[1])[:, None, :]
        m, p, l = _partials(torch.where(mask, scores, NEG_INF))
        ctx = _lse_combine(torch.einsum("bht,btr->bhr", p, c_kv.float()),
                           m, l).narrow(1, tp_index() * h if
                                        _mla_split(params, cfg) else 0, h)
    out = torch.einsum("bhr,rhk->bhk", ctx.to(x.dtype), params["wv_b"])
    y = _mla_out(out, params, cfg, "bhk,hkd->bd")[:, None, :]
    return y, {"c_kv": c_kv, "k_rope": k_rope}


def init_mla_cache(cfg, B: int, cache_len: int, dtype: torch.dtype,
                   device) -> dict:
    return {"c_kv": torch.zeros((B, cache_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((B, cache_len, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Cross-attention (Whisper decoder): K/V come from the encoder output and
# are computed once at prefill; no rope
# ---------------------------------------------------------------------------
def init_cross_attention(gen: torch.Generator, cfg,
                         dtype: torch.dtype) -> dict:
    return init_attention(gen, cfg, dtype)


# the cross-attention params that ``cross_kv`` reads, once a prefill or
# a forward; ``cross_attend`` reads the others
CROSS_KV = ("wk", "wv", "bk", "bv")


def cross_kv(params: dict, enc_out: torch.Tensor, cfg) -> dict:
    """enc_out: (B,T,D) -> {"xk", "xv"}: (B,T,KV,hd) each. Under rules,
    the rank's KV heads (``heads_of``), ``enc_out`` entering them through
    ``tp_enter``; under serving rules a sharded projection is gathered
    over the tensor axis (one ``kv_gather``), as the decode cache's
    ``enc_kv`` holds every KV head (``cache_shardings``)."""
    heads = heads_of(params, cfg)
    wk, wv = params["wk"], params["wv"]
    if heads.partial:
        enc_out = tp_enter(enc_out)
        if not heads.kv_sharded:
            wk, wv = tp_enter(wk), tp_enter(wv)
    k = torch.einsum("btd,dhk->bthk", enc_out, wk)
    v = torch.einsum("btd,dhk->bthk", enc_out, wv)
    if cfg.qkv_bias:
        bk, bv = params["bk"], params["bv"]
        if heads.partial:
            bk = tp_enter(bk).narrow(0, heads.p0, heads.p)
            bv = tp_enter(bv).narrow(0, heads.p0, heads.p)
        k, v = k + bk, v + bv
    rules = get_logical_rules()
    if rules is not None and rules.serve:
        k, v = _whole_kv(k, v, heads)
    return {"xk": k, "xv": v}


def _read_kv(k: torch.Tensor, heads: Heads) -> torch.Tensor:
    """The KV heads the rank's queries read, of ``k`` holding either the
    rank's projected heads or every KV head (a cached ``enc_kv``)."""
    p0 = heads.p0 if k.shape[2] == heads.p else 0
    if heads.a == k.shape[2]:
        return k
    return k.narrow(2, heads.a0 - p0, heads.a)


def cross_attend(params: dict, x: torch.Tensor, cfg,
                 kv: dict) -> torch.Tensor:
    """x: (B,S,D) queries against the encoder's K/V -> (B,S,D). Under
    rules, the rank's query heads against the KV heads they read, ``x``
    entering them through ``tp_enter``, ``wo``'s partial sums reduced
    (one ``tp_reduce``). A cached ``enc_kv`` of fewer positions than the
    encoder's is the rank's block of them (the reference's
    ``cache_shardings`` at rows that do not split over the data axes):
    every query head (``seq_q``) attends the block and the blocks'
    parts are combined over the tensor axis (``_sdpa_time_block``)."""
    heads = heads_of(params, cfg)
    if heads.partial:
        x = tp_enter(x)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if cfg.qkv_bias:
        bq = params["bq"]
        if heads.partial:
            bq = tp_enter(bq).narrow(0, heads.h0, heads.h)
        q = q + bq
    B, S, h, hd = q.shape
    if get_logical_rules() is not None \
            and kv["xk"].shape[1] < cfg.encoder_seq:
        KV = kv["xk"].shape[2]
        out = _sdpa_time_block(_all_heads(q, heads).reshape(
            B, S, KV, heads.H // KV, hd), kv["xk"], kv["xv"], True)
        out = out.reshape(B, S, heads.H, hd).narrow(2, heads.h0, h)
        return _out_proj(out, params, heads)
    out = _sdpa(q.reshape(B, S, heads.a, h // heads.a, hd),
                _read_kv(kv["xk"], heads), _read_kv(kv["xv"], heads),
                causal=False).reshape(B, S, h, hd)
    return _out_proj(out, params, heads)
