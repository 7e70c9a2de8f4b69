"""The recurrent mixers: Mamba2 (SSD) and xLSTM's mLSTM and sLSTM. Port
of ``repro/models/ssm.py``.

  <mixer>_full(params, x, cfg, build_cache=...) -> (y, cache|None)  prefill
  <mixer>_step(params, x, cfg, cache)           -> (y, cache)       decode

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

The mLSTM (matrix memory) runs its full mode chunkwise with the
reference's stabilisers (``_mlstm_chunked``), the sLSTM (scalar memory)
is sequential by construction: its input projection is hoisted out of
a Python loop over the sequence (the reference's ``lax.scan``), which
stacks the per-step outputs rather than writing into a buffer, so
``torch.func.vmap`` and autograd trace it. Neither has a kernel on the
TPU either; both run in plain torch, and their recurrent states stay
f32 whatever the model's dtype.

Tensor-parallel Mamba2 (under installed logical rules,
``models.common``): the reference's placement splits ``w_zx`` over the
tensor axis into contiguous column blocks of ``[z | x | B | C]`` and
``conv_w``/``conv_b`` into channel blocks; neither lines up with the
heads. ``w_dt``, ``A_log``, ``dt_bias`` and ``D_skip`` are split by
heads, and ``norm`` and ``w_out``'s rows by the heads' channels. A rank
(``mixer_of``: its heads [h0, h0 + h) and B/C groups) multiplies by its
column block of ``w_zx`` and gathers the product whole over the tensor
axis (``ssm_zx``), gathers the conv's small weights at use
(``ssm_conv``), and runs the conv, the SSD scan and the skip on its
heads: its heads' z and x channels and its groups' B and C
(``rank_channels``). The gated RMSNorm normalises over the whole d_in,
so its sum of squares is summed over the tensor axis (``ssm_norm``),
and ``w_out`` is row-parallel (one ``tp_reduce``). Each collective is
one of ``sharding.dist``'s differentiable operators: under training
rules the block's input enters through ``tp_enter``, the gathers'
backward reduce-scatters, and the norm's sum is summed again in the
backward (every rank's normalised channels read it). The decode cache
is the rank's: ``ssm`` (B, h, P, N) and ``conv`` (B, K−1, h·P + 2·g·N),
its heads' x channels and its groups' B and C before the conv.

Tensor-parallel xLSTM keeps the reference's placement, which splits no
param by heads: the mLSTM's ``w_up`` into column blocks of ``[xi | z]``
(at two ranks, rank 0 holds all of xi and rank 1 all of z), its
``wq``/``wk``/``wv``/``w_if``, ``norm`` and ``w_out`` by the rows of
d_in; the sLSTM's ``w_x`` into column blocks of ``[i | f | z | o]``,
``r`` by the rows of each head's hd (where the tensor axis divides hd),
``ff_gate`` by columns and ``ff_out`` by rows (where it divides d_ff).
The mLSTM gathers its ``w_up`` product whole (``xlstm_up``), multiplies
its block of xi by its rows of the four projections and sums the
partial products in one collective (``xlstm_qkv``): q, k, v and the
gates are whole on every rank, so the chunked recurrence runs whole on
every rank, with no collective. The gated norm's mean square is taken
over the whole d_in, and the rank keeps its d_in block for its rows of
``w_out`` (one ``tp_reduce``). The sLSTM's time loop makes no
collective: ``x @ w_x``'s column block is gathered once (``xlstm_wx``)
and ``r`` once (``xlstm_r``) before it, and every rank runs the cells
whole; its feed-forward is Megatron's. A decode step multiplies the
rank's ``r`` rows by its block of each head's units of h and sums that
partial product with its block of ``x @ w_x`` in one collective
(``xlstm_rec``). Where the rows of a decode cache do not split over the
data axes, the reference's ``cache_shardings`` cuts the mLSTM state's
heads (where H divides the tensor axis) and the sLSTM state's units
over ``model``: the mLSTM step then runs on the rank's heads, its norm's
sum of squares summed over the tensor axis (``xlstm_norm``), and the
sLSTM step gathers its state once (``xlstm_state``) and keeps its
block. Under training rules the mixers' inputs enter through
``tp_enter``, the mLSTM's recurrence output too (its gradient is a
partial sum on each rank), and the sLSTM's gathers keep the rank's
block of the gradient (``dist.gather_split``: the replicated cells make
it whole on every rank).
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba2_scan.ops import ssd_scan
from repro_torch.sharding import dist
from repro_torch.models.common import (dense_init, get_logical_rules,
                                       ones_init, rmsnorm, tp_enter,
                                       tp_gather, tp_index, tp_reduce,
                                       tp_sum, zeros_init)


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


class Mixer(NamedTuple):
    """A rank's share of a Mamba2 mixer of ``H`` heads: heads
    [h0, h0 + h) and B/C groups [g0, g0 + g); ``zx_split`` and
    ``conv_split``: its ``w_zx`` columns and conv channels are its block
    of the tensor axis's. Without rules, every head."""
    h0: int
    h: int
    g0: int
    g: int
    H: int
    zx_split: bool
    conv_split: bool

    @property
    def partial(self) -> bool:
        """The rank holds a block of the heads: ``w_out``'s product is a
        partial sum and the norm's sum of squares is the rank's part."""
        return self.h < self.H


def rank_heads(H: int, G: int, tp: int, t: int):
    """(h0, h, g0, g): the heads and B/C groups, of ``H`` heads in ``G``
    groups, of tensor rank ``t`` of ``tp`` where the heads split
    (``heads_t``), else every head. A rank's heads lie within one group
    or cover whole groups."""
    if tp == 1 or H % tp:
        return 0, H, 0, G
    h = H // tp
    h0, rep = t * h, H // G
    if h % rep == 0:
        return h0, h, h0 // rep, h // rep
    if rep % h:
        raise ValueError(f"{h} Mamba2 heads a rank straddle the groups of "
                         f"{rep} heads")
    return h0, h, h0 // rep, 1


def mixer_of(params: dict, cfg) -> Mixer:
    """This rank's share of the mixer, read from its local ``A_log``,
    ``w_zx`` and ``conv_w`` shapes."""
    d_in, H, P, G, N = mamba2_dims(cfg)
    conv_ch = d_in + 2 * G * N
    h = params["A_log"].shape[-1]
    rules = get_logical_rules()
    if rules is None:
        return Mixer(0, H, 0, G, H, False, False)
    zx = params["w_zx"].shape[-1] < d_in + conv_ch
    conv = params["conv_w"].shape[-1] < conv_ch
    if h == H:
        if zx or conv or params["w_out"].shape[-2] < d_in:
            raise ValueError(f"{cfg.name}: its {H} Mamba2 heads do not "
                             "split over the tensor axis, its channels do")
        return Mixer(0, H, 0, G, H, False, False)
    h0, h, g0, g = rank_heads(H, G, H // h, tp_index())
    return Mixer(h0, h, g0, g, H, zx, conv)


def rank_channels(m: Mixer, P: int, G: int, N: int):
    """(start, length) of each run of the conv's (x | B | C) channels
    the rank reads (heads of P channels, G groups of N): its heads' x,
    its groups' B, its groups' C."""
    d_in = m.H * P
    return ((m.h0 * P, m.h * P), (d_in + m.g0 * N, m.g * N),
            (d_in + (G + m.g0) * N, m.g * N))


def pick_channels(t: torch.Tensor, runs) -> torch.Tensor:
    """The channels ``runs`` ((start, length) each) of ``t``'s last dim,
    in order."""
    return torch.cat([t.narrow(-1, a, n) for a, n in runs], dim=-1)


def _zx(params: dict, x: torch.Tensor, cfg, m: Mixer):
    """(z, xBC) of the rank's heads: the product with ``w_zx``, gathered
    whole over the tensor axis where ``w_zx``'s columns are a block
    (``ssm_zx``), then the rank's z and (x | B | C) channels."""
    d_in = mamba2_dims(cfg)[0]
    zx = torch.einsum("...d,de->...e", x, params["w_zx"])
    if m.zx_split:
        zx = tp_gather(zx, zx.dim() - 1, "ssm_zx")
    if not m.partial:
        return zx[..., :d_in], zx[..., d_in:]
    _, _, P, G, N = mamba2_dims(cfg)
    return (zx.narrow(-1, m.h0 * P, m.h * P),
            pick_channels(zx[..., d_in:], rank_channels(m, P, G, N)))


def _conv_params(params: dict, cfg, m: Mixer):
    """(conv_w, conv_b) of the rank's channels: the blocks gathered
    whole over the tensor axis where they are blocks (one ``ssm_conv``
    gather of both), then the rank's."""
    w, b = params["conv_w"], params["conv_b"]
    if m.conv_split:
        wb = tp_gather(torch.cat([w, b[None]], dim=0), 1, "ssm_conv")
        w, b = wb[:-1], wb[-1]
    if not m.partial:
        return w, b
    _, _, P, G, N = mamba2_dims(cfg)
    runs = rank_channels(m, P, G, N)
    return pick_channels(w, runs), pick_channels(b, runs)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                cfg, m: Mixer) -> torch.Tensor:
    """``rmsnorm(y·silu(z))`` over the whole d_in: where the rank holds a
    block of the channels, the mean square is its sum of squares summed
    over the tensor axis (``ssm_norm``) over d_in."""
    u = y * F.silu(z)
    if not m.partial:
        return rmsnorm(u, scale)
    dt, uf = u.dtype, u.float()
    ss = tp_sum(torch.sum(torch.square(uf), dim=-1, keepdim=True),
                "ssm_norm")
    var = ss / mamba2_dims(cfg)[0]
    return (uf * torch.rsqrt(var + 1e-6)).to(dt) * scale


def _split_conv(xc: torch.Tensor, d_in: int, G: int, N: int):
    """The conv output -> (x, B, C) with B and C by group."""
    lead = xc.shape[:-1]
    Bm = xc[..., d_in:d_in + G * N].reshape(*lead, G, N)
    Cm = xc[..., d_in + G * N:].reshape(*lead, G, N)
    return xc[..., :d_in], Bm, Cm


def _out(params: dict, y: torch.Tensor, m: Mixer) -> torch.Tensor:
    """The output projection of the rank's channels, summed over the
    tensor axis where they are a block."""
    out = torch.einsum("...e,ed->...d", y, params["w_out"])
    return tp_reduce(out) if m.partial else out


def mamba2_full(params: dict, x: torch.Tensor, cfg, *,
                build_cache: bool = False, use_pallas: bool = True):
    """x: (B,S,D). Returns (out (B,S,D), {"ssm", "conv"} | None).
    ``use_pallas``: the SSD chunk kernel (True) or ``_ssd_chunked``.
    Under rules, the rank's heads; under training rules ``x`` enters
    them through ``tp_enter``."""
    B, S, D = x.shape
    d_in, H, P, G, N = mamba2_dims(cfg)
    m = mixer_of(params, cfg)
    if m.partial:
        x = tp_enter(x)
    z, xbc = _zx(params, x, cfg, m)
    cw, cb = _conv_params(params, cfg, m)
    xc = F.silu(_causal_conv_full(xbc, cw, cb))
    xs, Bm, Cm = _split_conv(xc, m.h * P, m.g, N)
    xs = xs.reshape(B, S, m.h, P)
    dt = F.softplus(torch.einsum("bsd,dh->bsh", x, params["w_dt"]).float()
                    + params["dt_bias"].float())
    scan = ssd_scan if use_pallas else _ssd_chunked
    y, h_fin = scan(xs, dt, params["A_log"], Bm, Cm)
    y = y + xs * params["D_skip"].to(x.dtype)[None, None, :, None]
    y = _gated_norm(y.reshape(B, S, m.h * P), z, params["norm"], cfg, m)
    out = _out(params, y, m)
    cache = None
    if build_cache:
        K = cfg.ssm_conv
        tail = (xbc[:, S - (K - 1):, :] if S >= K - 1
                else F.pad(xbc, (0, 0, K - 1 - S, 0)))
        cache = {"ssm": h_fin.to(x.dtype), "conv": tail}
    return out, cache


def mamba2_step(params: dict, x: torch.Tensor, cfg, cache: dict):
    """x: (B,1,D). cache: ssm (B,H,P,N), conv (B,K−1,conv_ch); under
    rules the rank's (``init_mamba2_cache``)."""
    B = x.shape[0]
    d_in, H, P, G, N = mamba2_dims(cfg)
    m = mixer_of(params, cfg)
    z, xc_new = _zx(params, x[:, 0], cfg, m)
    cw, cb = _conv_params(params, cfg, m)
    conv_in = torch.cat([cache["conv"], xc_new[:, None, :]], dim=1)
    xc = torch.einsum("bkc,kc->bc", conv_in, cw) + cb
    xs, Bm, Cm = _split_conv(F.silu(xc), m.h * P, m.g, N)
    xs = xs.reshape(B, m.h, P)
    dt = F.softplus(torch.einsum("bd,dh->bh", x[:, 0], params["w_dt"])
                    .float() + params["dt_bias"].float())
    dA = torch.exp(dt * (-torch.exp(params["A_log"].float())))
    rep = m.h // m.g
    Bh = Bm.repeat_interleave(rep, dim=1).float()            # (B,h,N)
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    h = cache["ssm"].float()
    h = dA[:, :, None, None] * h + torch.einsum(
        "bh,bhp,bhn->bhpn", dt, xs.float(), Bh)
    y = torch.einsum("bhpn,bhn->bhp", h, Ch).to(x.dtype)
    y = y + xs * params["D_skip"].to(x.dtype)[None, :, None]
    y = _gated_norm(y.reshape(B, m.h * P), z, params["norm"], cfg, m)
    out = _out(params, y, m)[:, None, :]
    return out, {"ssm": h.to(cache["ssm"].dtype), "conv": conv_in[:, 1:]}


def init_mamba2_cache(cfg, B: int, dtype: torch.dtype, device) -> dict:
    """Under rules, the rank's heads and conv channels (``rank_heads``)
    of its ``B`` rows."""
    d_in, H, P, G, N = mamba2_dims(cfg)
    rules = get_logical_rules()
    h0, h, g0, g = (rank_heads(H, G, rules.size(rules.tp), tp_index())
                    if rules is not None else (0, H, 0, G))
    return {"ssm": torch.zeros((B, h, P, N), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((B, cfg.ssm_conv - 1, h * P + 2 * g * N),
                                dtype=dtype, device=device)}


# ===========================================================================
# xLSTM — mLSTM (matrix memory)
# ===========================================================================
def mlstm_dims(cfg):
    """-> (d_in, H, d_qk, hd_v, hd_k): up-projection factor 2, qk dim
    factor 0.5."""
    d_in = 2 * cfg.d_model
    H = cfg.num_heads
    d_qk = d_in // 2
    return d_in, H, d_qk, d_in // H, d_qk // H


def init_mlstm(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    D = cfg.d_model
    d_in, H, d_qk, hd_v, hd_k = mlstm_dims(cfg)
    dev = gen.device
    return {
        "w_up": dense_init(gen, (D, 2 * d_in), dtype, fan_in=D),
        "wq": dense_init(gen, (d_in, d_qk), dtype, fan_in=d_in),
        "wk": dense_init(gen, (d_in, d_qk), dtype, fan_in=d_in),
        "wv": dense_init(gen, (d_in, d_in), dtype, fan_in=d_in),
        "w_if": dense_init(gen, (d_in, 2 * H), dtype, fan_in=d_in),
        "b_if": torch.cat([torch.zeros((H,), device=dev),
                           torch.linspace(3.0, 6.0, H, device=dev)]
                          ).to(dtype),
        "norm": ones_init(gen, (d_in,), dtype),
        "w_out": dense_init(gen, (d_in, D), dtype, fan_in=d_in),
    }


# the mLSTM's chunk length (the reference's); the dry run reads it
MLSTM_CHUNK = 256


def _mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i_pre: torch.Tensor, f_pre: torch.Tensor,
                   chunk: int = None):
    """Chunkwise stabilised mLSTM: the recurrent semantics of
    ``mlstm_step``, L tokens at a time. q,k: (B,S,H,hk), v: (B,S,H,hv),
    i_pre/f_pre: (B,S,H) gate pre-activations.

    The intra-chunk work and the inter-chunk readout run over all
    chunks at once; a loop over the chunks carries only the elementwise
    (C, n, m) state combine. The intra-chunk decay is masked with −inf
    before its exp, and the readout divides by max(|q·n|, exp(−M)), as
    in the reference. Returns (y (B,S,H,hv) f32, the final (C, n, m))
    for decode to continue from."""
    B, S, H, hk = q.shape
    hv = v.shape[-1]
    L = _chunk_len(S, chunk or MLSTM_CHUNK)
    nc = S // L
    q = q.float()
    k = k.float() / math.sqrt(hk)
    v = v.float()
    lf = F.logsigmoid(f_pre.float())
    li = i_pre.float()

    def rs(t):  # (B,S,...) -> (nc,B,L,...)
        return t.reshape(B, nc, L, *t.shape[2:]).movedim(1, 0)

    qc, kc, vc, lfc, lic = map(rs, (q, k, v, lf, li))
    g = torch.cumsum(lfc, dim=2)                       # (nc,B,L,H) inclusive
    G = g[:, :, -1, :]                                 # (nc,B,H) chunk decay

    # chunk-local state summaries, with a local stabiliser mloc
    w = G[:, :, None, :] - g + lic                     # (nc,B,L,H)
    mloc = torch.amax(w, dim=2)                        # (nc,B,H)
    wexp = torch.exp(w - mloc[:, :, None, :])
    C_c = torch.einsum("cblh,cblhk,cblhv->cbhkv", wexp, kc, vc)
    n_c = torch.einsum("cblh,cblhk->cbhk", wexp, kc)

    # the running state over the chunks; each chunk reads the state
    # before it. The chunks' terms are taken apart with one unbind each
    # (whose backward stacks their gradients once; an index a chunk
    # would make a whole-size gradient for each)
    C = torch.zeros((B, H, hk, hv), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, hk), dtype=torch.float32, device=q.device)
    m = torch.zeros((B, H), dtype=torch.float32, device=q.device)
    pre = []
    for Gc, ml, Cc, nc_ in zip(*(t.unbind(0) for t in (G, mloc, C_c, n_c))):
        pre.append((C, n, m))
        m_new = torch.maximum(Gc + m, ml)
        a = torch.exp(Gc + m - m_new)
        b = torch.exp(ml - m_new)
        C = a[..., None, None] * C + b[..., None, None] * Cc
        n = a[..., None] * n + b[..., None] * nc_
        m = m_new
    Cp, np_, mp = (torch.stack(xs) for xs in zip(*pre))

    # intra-chunk decay matrix and the combined row stabiliser
    D = (g[:, :, :, None, :] - g[:, :, None, :, :]
         + lic[:, :, None, :, :])                      # (nc,B,q,t,H)
    tril = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    D = torch.where(tril[None, None, :, :, None], D, float("-inf"))
    m_inter = g + mp[:, :, None, :]                    # (nc,B,L,H)
    M = torch.maximum(torch.amax(D, dim=3), m_inter)   # (nc,B,L,H)
    Dexp = torch.exp(D - M[:, :, :, None, :])
    scores = torch.einsum("cbqhe,cbthe->cbqth", qc, kc)
    Sm = scores * Dexp
    iw = torch.exp(m_inter - M)                        # (nc,B,L,H)
    num = (torch.einsum("cbqth,cbthv->cbqhv", Sm, vc)
           + iw[..., None] * torch.einsum("cbqhk,cbhkv->cbqhv", qc, Cp))
    qn = torch.einsum("cbqhk,cbhk->cbqh", qc, np_)
    den = torch.maximum(torch.abs(Sm.sum(dim=3) + iw * qn), torch.exp(-M))
    y = num / den[..., None]
    return y.movedim(0, 1).reshape(B, S, H, hv), (C, n, m)


def _mlstm_split(params: dict, cfg) -> bool:
    """The rank holds a block of the mLSTM's d_in under the installed
    rules: its column block of ``w_up`` and its rows of ``wq``, ``wk``,
    ``wv``, ``w_if``, ``norm`` and ``w_out`` (they split together: each
    divides by the tensor axis where d_in does)."""
    return get_logical_rules() is not None \
        and params["wq"].shape[-2] < mlstm_dims(cfg)[0]


def _mlstm_proj(params: dict, x: torch.Tensor, cfg, split: bool = False):
    """x: (..., D) -> (z, q, k, v, i_pre, f_pre), heads split; z is
    (..., d_in). With ``split`` (``_mlstm_split``) the rank's column block
    of ``w_up`` is gathered whole over the tensor axis (``xlstm_up``),
    its rows of ``wq | wk | wv | w_if`` multiply its block of ``xi``, and
    the four partial products are summed in one collective
    (``xlstm_qkv``): q, k, v and the gates are then whole on every rank.
    Under training rules ``x`` enters the rank's block through
    ``tp_enter``."""
    d_in, H, d_qk, hd_v, hd_k = mlstm_dims(cfg)
    if split:
        x = tp_enter(x)
    up = x @ params["w_up"]
    if split:
        up = tp_gather(up, up.dim() - 1, "xlstm_up")
    xi, z = up[..., :d_in], up[..., d_in:]
    lead = x.shape[:-1]
    names = ("wq", "wk", "wv", "w_if")
    if split:
        n = params["wq"].shape[-2]
        xb = xi.narrow(-1, tp_index() * n, n)
        parts = tp_reduce(torch.cat([xb @ params[k] for k in names], -1),
                          "xlstm_qkv")
        q, k, v, gif = torch.split(parts, [d_qk, d_qk, d_in, 2 * H], -1)
    else:
        q, k, v, gif = (xi @ params[k] for k in names)
    q = q.reshape(*lead, H, hd_k)
    k = k.reshape(*lead, H, hd_k)
    v = v.reshape(*lead, H, hd_v)
    gif = gif + params["b_if"]
    return z, q, k, v, gif[..., :H], gif[..., H:]


def _mlstm_out(params: dict, y: torch.Tensor, z: torch.Tensor,
               x: torch.Tensor, cfg, split: bool = False,
               own_heads: bool = False) -> torch.Tensor:
    """The gated RMSNorm and the output projection. y: (..., H, hv) f32,
    or with ``own_heads`` the rank's heads only; z: (..., d_in) whole. With ``split``: where y holds every head (the recurrence ran
    whole on the rank), the norm's mean square is taken over the whole
    d_in and the rank keeps its block, ``y`` entering it through
    ``tp_enter`` (its gradient is a partial sum on each rank); where y
    holds the rank's heads, which are its d_in block, the sum of squares
    is summed over the tensor axis (``xlstm_norm``). Then the rank's
    ``norm`` block and its rows of ``w_out``, whose partial products are
    summed (one ``tp_reduce``)."""
    if not split:
        y = rmsnorm(y.to(x.dtype).reshape(z.shape) * F.silu(z),
                    params["norm"])
        return y @ params["w_out"]
    n = params["norm"].shape[-1]
    b0 = tp_index() * n
    if not own_heads:
        u = tp_enter(y.to(x.dtype)).reshape(z.shape) * F.silu(z)
        dt, uf = u.dtype, u.float()
        var = torch.mean(torch.square(uf), dim=-1, keepdim=True)
        u = (uf * torch.rsqrt(var + 1e-6)).to(dt).narrow(-1, b0, n)
    else:
        u = y.to(x.dtype).reshape(*z.shape[:-1], n) \
            * F.silu(z.narrow(-1, b0, n))
        dt, uf = u.dtype, u.float()
        ss = tp_sum(torch.sum(torch.square(uf), dim=-1, keepdim=True),
                    "xlstm_norm")
        var = ss / mlstm_dims(cfg)[0]
        u = (uf * torch.rsqrt(var + 1e-6)).to(dt)
    return tp_reduce((u * params["norm"]) @ params["w_out"])


def mlstm_full(params: dict, x: torch.Tensor, cfg, *,
               build_cache: bool = False):
    """x: (B,S,D). Returns (out (B,S,D), {"C", "n", "m"} | None). Under
    rules the chunked recurrence runs whole on every rank (q, k and v
    are whole after ``_mlstm_proj``'s sum), and the cache holds every
    head."""
    split = _mlstm_split(params, cfg)
    z, q, k, v, i_pre, f_pre = _mlstm_proj(params, x, cfg, split)
    y, (C, n, m) = _mlstm_chunked(q, k, v, i_pre, f_pre)
    out = _mlstm_out(params, y, z, x, cfg, split)
    return out, ({"C": C, "n": n, "m": m} if build_cache else None)


def mlstm_step(params: dict, x: torch.Tensor, cfg, cache: dict):
    """x: (B,1,D); cache C (B,H,hk,hv), n (B,H,hk), m (B,H), f32. Under
    rules a cache of h < H heads holds the rank's heads (the reference's
    ``cache_shardings`` at one data rank): the step runs on those and
    keeps them."""
    split = _mlstm_split(params, cfg)
    z, q, k, v, logi, f_pre = _mlstm_proj(params, x[:, 0], cfg, split)
    C, n, m = cache["C"], cache["n"], cache["m"]
    h = C.shape[1]
    own = h < q.shape[1]
    if own:
        q, k, v, logi, f_pre = (a.narrow(1, tp_index() * h, h)
                                for a in (q, k, v, logi, f_pre))
    q, v = q.float(), v.float()
    k = k.float() / math.sqrt(k.shape[-1])
    logi, logf = logi.float(), F.logsigmoid(f_pre.float())
    m_new = torch.maximum(logf + m, logi)                       # (B,H)
    fp = torch.exp(logf + m - m_new)
    ip = torch.exp(logi - m_new)
    C = fp[..., None, None] * C + ip[..., None, None] * (
        k[..., :, None] * v[..., None, :])                      # (B,H,hk,hv)
    n = fp[..., None] * n + ip[..., None] * k
    num = torch.einsum("bhkd,bhk->bhd", C, q)
    den = torch.maximum(torch.abs(torch.einsum("bhk,bhk->bh", n, q)),
                        torch.exp(-m_new))
    out = _mlstm_out(params, num / den[..., None], z, x[:, 0], cfg, split,
                     own)
    return out[:, None, :], {"C": C, "n": n, "m": m_new}


def init_mlstm_cache(cfg, B: int, dtype: torch.dtype, device) -> dict:
    """The state is f32 whatever ``dtype`` is."""
    d_in, H, d_qk, hd_v, hd_k = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((B, H, hd_k, hd_v), **f32),
            "n": torch.zeros((B, H, hd_k), **f32),
            "m": torch.zeros((B, H), **f32)}


# ===========================================================================
# xLSTM — sLSTM (scalar memory, sequential by construction)
# ===========================================================================
def init_slstm(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    D, H = cfg.d_model, cfg.num_heads
    hd = D // H
    d_ff = int(D * 4 / 3)
    dev = gen.device
    return {
        "w_x": dense_init(gen, (D, 4 * D), dtype, fan_in=D),
        "r": dense_init(gen, (H, hd, 4 * hd), dtype, fan_in=hd),
        "b": torch.cat([torch.zeros((D,), device=dev),
                        torch.linspace(3.0, 6.0, D, device=dev),
                        torch.zeros((2 * D,), device=dev)]).to(dtype),
        "ff_gate": dense_init(gen, (D, d_ff), dtype, fan_in=D),
        "ff_out": dense_init(gen, (d_ff, D), dtype, fan_in=d_ff),
        "ff_norm": ones_init(gen, (D,), dtype),
    }


def _slstm_rec(h: torch.Tensor, r: torch.Tensor, cfg) -> torch.Tensor:
    """The recurrent pre-activation (B, 4D) of h (B, D) through the
    per-head blocks of ``r`` (H, k, 4hd): all of each head's hd input
    rows, or with k < hd the rank's block of them (``h`` then its
    block of each head's units), a partial sum."""
    H = cfg.num_heads
    B, k = h.shape[0], r.shape[1]
    hd = cfg.d_model // H
    hh = h.reshape(B, H, hd)
    if k < hd:
        hh = hh.narrow(2, tp_index() * k, k)
    return torch.einsum("bhk,hkg->bhg", hh.to(r.dtype), r).reshape(B, -1)


def _slstm_gates(pre: torch.Tensor, state: dict) -> dict:
    """The cell's elementwise update from its whole pre-activation
    ``pre`` (B, 4D) = x_t·W_x + h_{t−1}·r + b. state: h, c, n, m, each
    (B, D) f32."""
    i_pre, f_pre, z_pre, o_pre = torch.chunk(pre.float(), 4, dim=-1)
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    fp = torch.exp(logf + state["m"] - m_new)
    ip = torch.exp(i_pre - m_new)
    c = fp * state["c"] + ip * torch.tanh(z_pre)
    n = fp * state["n"] + ip
    hy = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
    return {"h": hy, "c": c, "n": n, "m": m_new}


def _slstm_cell(params: dict, pre_x: torch.Tensor, state: dict, cfg,
                r: torch.Tensor) -> dict:
    """pre_x: (B,4D) = x_t @ W_x, computed outside the time loop (the
    input projection is the heavy part); ``r`` whole."""
    return _slstm_gates(pre_x + _slstm_rec(state["h"], r, cfg) + params["b"],
                        state)


def _slstm_ff(params: dict, y: torch.Tensor) -> torch.Tensor:
    """The block's feed-forward on the cell output, in its dtype. Under
    rules with ``ff_gate``'s columns a block of d_ff (where the tensor
    axis divides it), column-parallel then row-parallel: the normed
    input enters the rank's block through ``tp_enter`` and ``ff_out``'s
    partial products are summed (one ``tp_reduce``); otherwise whole on
    every rank."""
    y = rmsnorm(y, params["ff_norm"])
    split = get_logical_rules() is not None and params["ff_gate"].shape[-1] \
        < int(params["ff_norm"].shape[-1] * 4 / 3)
    if split:
        y = tp_enter(y)
    # jax.nn.gelu's default is the tanh approximation
    ff = F.gelu((y @ params["ff_gate"]).float(), approximate="tanh")
    out = ff.to(y.dtype) @ params["ff_out"]
    return tp_reduce(out) if split else out


def _slstm_split(params: dict, cfg) -> bool:
    """The rank holds a column block of ``w_x`` under the installed
    rules (its ``r`` rows are then a block of each head's hd where the
    tensor axis divides hd)."""
    return get_logical_rules() is not None \
        and params["w_x"].shape[-1] < 4 * cfg.d_model


# the sLSTM cells a time loop runs (``counted_cells``; None: every one)
_COUNTED_CELLS = None


@contextlib.contextmanager
def counted_cells(n: int):
    """For an op count only (``launch.dryrun``): inside, ``slstm_full``
    runs the first ``n`` cells of its time loop, and each later step's
    h is the last cell's, detached (a view: no op and no gradient), so
    the loop's work is counted at ``n`` cells and extrapolated."""
    global _COUNTED_CELLS
    prev, _COUNTED_CELLS = _COUNTED_CELLS, n
    try:
        yield
    finally:
        _COUNTED_CELLS = prev


def slstm_full(params: dict, x: torch.Tensor, cfg, *,
               build_cache: bool = False):
    """x: (B,S,D). Returns (out (B,S,D), final {"h","c","n","m"} | None).
    The time loop stacks each step's h; it takes the steps' input
    products apart with one unbind.

    Under rules the loop makes no collective: the rank's column block of
    ``x @ w_x`` is gathered whole once (``xlstm_wx``), and ``r`` once
    where its rows are a block (``xlstm_r``), both before the loop; the
    cell then runs whole on every rank. Both gathers keep the rank's
    block of the gradient, which the replicated cells make whole on
    every rank (``dist.gather_split``); ``x`` enters through
    ``tp_enter``."""
    B, S, _ = x.shape
    split = _slstm_split(params, cfg)
    state = init_slstm_cache(cfg, B, x.dtype, x.device)
    r = params["r"]
    if split:
        rules = get_logical_rules()
        x = tp_enter(x)
    pre_x = torch.einsum("bsd,dg->bsg", x, params["w_x"])   # hoisted
    if split:
        pre_x = dist.gather_split(pre_x, rules.mesh, (rules.tp,), -1,
                                  role="xlstm_wx")
        if r.shape[1] < cfg.d_model // cfg.num_heads:
            r = dist.gather_split(r, rules.mesh, (rules.tp,), 1,
                                  role="xlstm_r")
    hs = []
    # one unbind of the time dim (an index a step would make a
    # whole-size gradient for each step: quadratic in S)
    steps = pre_x.unbind(1)
    n = S if _COUNTED_CELLS is None else min(_COUNTED_CELLS, S)
    for px in steps[:n]:
        state = _slstm_cell(params, px, state, cfg, r)
        hs.append(state["h"])
    hs += [state["h"].detach()] * (S - n)
    out = _slstm_ff(params, torch.stack(hs, dim=1).to(x.dtype))
    return out, (state if build_cache else None)


def slstm_step(params: dict, x: torch.Tensor, cfg, cache: dict):
    """x: (B,1,D); cache h, c, n, m (B,D) f32.

    Under rules: the rank's column block of ``x @ w_x``, put in place in
    a (B, 4D) of zeros, and its rows of ``r`` times its block of each
    head's units of h, a partial sum, are summed in one collective
    (``xlstm_rec``: the whole pre-activation on every rank; where ``r``
    is whole, the block is gathered, ``xlstm_wx``). A cache of (B, D/tp)
    (the reference's ``cache_shardings`` at one data rank) is gathered
    whole once a step (``xlstm_state``, the four stacked) and the rank
    keeps its block of the new state."""
    D = cfg.d_model
    state = cache
    cut = cache["h"].shape[-1] < D
    if cut:
        n = cache["h"].shape[-1]
        st = tp_gather(torch.stack([cache[k] for k in "hcnm"]), 2,
                       "xlstm_state")
        state = dict(zip("hcnm", st.unbind(0)))
    pre_x = x[:, 0] @ params["w_x"]
    if _slstm_split(params, cfg):
        rules = get_logical_rules()
        if params["r"].shape[1] < D // cfg.num_heads:
            w, t = pre_x.shape[-1], tp_index()
            pre = F.pad(pre_x, (t * w, 4 * D - (t + 1) * w)) \
                + _slstm_rec(state["h"], params["r"], cfg)
            pre = tp_reduce(pre, "xlstm_rec")
        else:
            pre = dist.gather_split(pre_x, rules.mesh, (rules.tp,), -1,
                                    role="xlstm_wx") \
                + _slstm_rec(state["h"], params["r"], cfg)
        state = _slstm_gates(pre + params["b"], state)
    else:
        state = _slstm_cell(params, pre_x, state, cfg, params["r"])
    out = _slstm_ff(params, state["h"].to(x.dtype))
    if cut:
        t = tp_index()
        state = {k: v.narrow(-1, t * n, n) for k, v in state.items()}
    return out[:, None, :], state


def init_slstm_cache(cfg, B: int, dtype: torch.dtype, device) -> dict:
    """The state is f32 whatever ``dtype`` is."""
    z = torch.zeros((B, cfg.d_model), dtype=torch.float32, device=device)
    return {"h": z, "c": z, "n": z, "m": z}
