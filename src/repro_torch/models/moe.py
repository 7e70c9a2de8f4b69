"""Mixture-of-Experts layer: token-choice top-k routing with capacity-based
dispatch into an (E, C, D) expert buffer, a grouped SwiGLU FFN over the
experts, and shared experts (DeepSeek-V3). Port of
``repro/models/moe.py``.

The reference dispatches with a scatter (``.at[slot].set``) and combines
with a scatter-add (``.at[tok_ids].add``). Their torch counterparts
(``index_put_``, ``index_add_``) and the backward of an indexed read sum
with atomics on the card, in an order that varies run to run. Here the
same math runs as reads only, so a trained step keeps its bits:

  * dispatch reads each expert slot's token through the inverse map
    slot -> (token, choice), which is one-to-one on kept entries; empty
    slots read a zero row;
  * the combine is a fixed-order sum over the K choices of a (T, K, D)
    tensor (a token's K choices are its ``tok_ids`` entries, in order).

The only scatter writes the inverse map's integer indices; entries with
duplicate indices (dropped choices) land in its drop row, which is never
read. Everything here runs under ``torch.func.vmap`` over a client axis:
the one-hots are comparisons with ``arange(E)``, as ``F.one_hot`` checks
its values and refuses to run under vmap.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init

CAPACITY_FACTOR = 1.25


def init_moe(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    D, E, F_ = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    p = {
        "router": dense_init(gen, (D, E), dtype, fan_in=D),
        "w_gate": dense_init(gen, (E, D, F_), dtype, fan_in=D),
        "w_in": dense_init(gen, (E, D, F_), dtype, fan_in=D),
        "w_out": dense_init(gen, (E, F_, D), dtype, fan_in=F_),
    }
    if cfg.num_shared_experts:
        Fs = cfg.expert_d_ff * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": dense_init(gen, (D, Fs), dtype, fan_in=D),
            "w_in": dense_init(gen, (D, Fs), dtype, fan_in=D),
            "w_out": dense_init(gen, (Fs, D), dtype, fan_in=Fs),
        }
    return p


def _capacity(T: int, E: int, k: int) -> int:
    c = int(T * k * CAPACITY_FACTOR / E)
    return max(4, ((c + 3) // 4) * 4)


def apply_moe(params: dict, x: torch.Tensor, cfg):
    """x: (B,S,D) -> (out (B,S,D), aux loss f32).

    Dispatch: top-k per token; the position in each expert is a cumsum
    over the flattened (T·K,) choice stream; choices past an expert's
    capacity are dropped (the residual path still carries the token,
    standard Switch behaviour)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    C = _capacity(T, E, K)
    xt = x.reshape(T, D)
    experts = torch.arange(E, device=x.device)

    logits = (xt @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, K, dim=-1)              # (T,K)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)

    # ---- aux load-balance loss (Switch eq. 4 generalised to top-k) ----
    me = torch.mean(probs, dim=0)                              # (E,)
    onehot_any = (idx[..., None] == experts).float()           # (T,K,E)
    ce = torch.mean(torch.sum(onehot_any, dim=1), dim=0)       # frac routed
    aux = cfg.router_aux_coef * E * torch.sum(me * ce) / K

    # ---- position in each expert: cumsum over the (T·K,) stream ----
    flat_e = idx.reshape(T * K)
    onehot = (flat_e[:, None] == experts).long()               # (TK,E)
    pos = torch.sum((torch.cumsum(onehot, dim=0) - 1) * onehot, dim=-1)
    slot = torch.where(pos < C, flat_e * C + pos, E * C)       # drop slot

    # ---- dispatch: slot -> choice (drop row E*C never read) ----
    choice = torch.arange(T * K, device=x.device)
    inv = torch.full((E * C + 1,), T * K, dtype=torch.long,
                     device=x.device).scatter(0, slot, choice)
    xk = torch.cat([xt[:, None].expand(T, K, D).reshape(T * K, D),
                    xt.new_zeros((1, D))])
    buf = xk[inv[:E * C]].reshape(E, C, D)

    # ---- grouped expert FFN ----
    g = torch.einsum("ecd,edf->ecf", buf, params["w_gate"])
    u = torch.einsum("ecd,edf->ecf", buf, params["w_in"])
    h = F.silu(g) * u
    eo = torch.einsum("ecf,efd->ecd", h, params["w_out"])

    # ---- gather back and combine with the gate weights, in order ----
    eo_flat = torch.cat([eo.reshape(E * C, D), eo.new_zeros((1, D))])
    per_slot = eo_flat[slot] * gate_vals.reshape(T * K)[:, None].to(x.dtype)
    out = per_slot.reshape(T, K, D).sum(dim=1)

    if "shared" in params:
        sp = params["shared"]
        h = F.silu(xt @ sp["w_gate"]) * (xt @ sp["w_in"])
        out = out + h @ sp["w_out"]
    return out.reshape(B, S, D), aux
