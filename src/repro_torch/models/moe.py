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

Tensor parallel (under installed logical rules, ``models.common``; the
reference's rules put the expert dim over ``model``): a rank holds the
experts [e0, e0 + E/tp) and routes every token, as every ``model`` rank
does (the router is read whole). The reference runs one global
program, so its capacity and drop order are global; here they are
made so by explicit collectives over the batch axes (the axes that
split the rows: ``data`` under serving rules, the fsdp axes under
training rules):

  * C comes from the global T, the local T times the batch ranks;
  * each rank's per-expert counts are gathered over the batch axes (one
    ``moe_counts`` all-gather, no gradient), and the counts of the
    ranks before it are added to its cumsum, so a choice's position is
    its place in the global token order and ``pos < C`` is the
    reference's ``keep`` on the rank's rows;
  * the buffer is (E/tp, C, D) at the global positions: the slots of
    other batch ranks' choices stay empty (a zero row), so every rank
    does the reference's E/tp·C·D·F a GEMM, and a choice routed to
    another ``model`` rank's expert adds zero to the combine;
  * the routed and the shared expert's outputs (Megatron:
    ``w_gate``/``w_in`` column-parallel, ``w_out`` row-parallel) are
    partial sums, reduced in one ``tp_reduce`` a layer;
  * the aux loss is global: Σprobs and the routed counts are summed
    over the batch axes in one ``moe_aux`` reduce (identity backward)
    and divided by the global T. Serving drops the aux loss: under
    serving rules it is zero and issues no collective.

Under training rules the router's gradient must be whole on every
``model`` rank: the tokens enter the rank's experts through
``tp_enter``, and so do the gate values as they enter the combine (its
partial gradient is summed over ``model``); the router reads the raw
tokens. Each path is then counted once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (dense_init, get_logical_rules,
                                       shard_logical, tp_enter, tp_index,
                                       tp_reduce)
from repro_torch.sharding import dist

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
    standard Switch behaviour). Under installed rules, the rank's
    experts and the global capacity order (the module docstring)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    rules = get_logical_rules()
    El = params["w_gate"].shape[0]
    split = rules is not None and El < E
    baxes = rules.batch_axes if rules is not None else ()
    nb = rules.size(baxes) if baxes else 1
    T = B * S
    Tg = T * nb
    C = _capacity(Tg, E, K)
    xt = x.reshape(T, D)
    experts = torch.arange(E, device=x.device)

    logits = (xt @ params["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, K, dim=-1)              # (T,K)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)

    # ---- aux load-balance loss (Switch eq. 4 generalised to top-k) ----
    onehot_any = (idx[..., None] == experts).float()           # (T,K,E)
    if rules is not None and rules.serve:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        if nb > 1:
            # Σprobs (identity backward: a rank's probs feed its own
            # sum) and the routed counts, summed over the batch ranks
            tot = dist.reduce_from(torch.stack(
                [probs.sum(dim=0), onehot_any.sum(dim=1).sum(dim=0)]),
                rules.mesh, baxes, role="moe_aux")
            me, ce = tot[0] / Tg, tot[1] / Tg
        else:
            me = torch.mean(probs, dim=0)                      # (E,)
            ce = torch.mean(torch.sum(onehot_any, dim=1), dim=0)
        aux = cfg.router_aux_coef * E * torch.sum(me * ce) / K

    # ---- position in each expert: cumsum over the (T·K,) stream ----
    flat_e = idx.reshape(T * K)
    onehot = (flat_e[:, None] == experts).long()               # (TK,E)
    cum = torch.cumsum(onehot, dim=0)
    if nb > 1:
        # the choices of the batch ranks before this one come first
        counts = dist.stack_over(cum[-1], rules.mesh, baxes,
                                 role="moe_counts")            # (nb,E)
        cum = cum + counts[:rules.index(baxes)].sum(dim=0)
    pos = torch.sum((cum - 1) * onehot, dim=-1)
    keep = pos < C
    e0 = tp_index() * El if split else 0
    if split:
        keep = keep & (flat_e >= e0) & (flat_e < e0 + El)
    slot = torch.where(keep, (flat_e - e0) * C + pos, El * C)  # drop slot

    # ---- dispatch: slot -> choice (drop row El*C never read) ----
    sp = params.get("shared")
    sh_split = (rules is not None and sp is not None
                and sp["w_out"].shape[0]
                < cfg.expert_d_ff * cfg.num_shared_experts)
    # the tokens enter (once) the rank's block of the experts and of
    # the shared expert's hidden units; the router reads them raw
    xe = tp_enter(xt) if split or sh_split else xt
    choice = torch.arange(T * K, device=x.device)
    inv = torch.full((El * C + 1,), T * K, dtype=torch.long,
                     device=x.device).scatter(0, slot, choice)
    xk = (xe if split else xt)[:, None].expand(T, K, D).reshape(T * K, D)
    xk = torch.cat([xk, xk.new_zeros((1, D))])
    buf = xk[inv[:El * C]].reshape(El, C, D)
    shard_logical(buf, ("experts", None, None), (E, C, D))

    # ---- grouped expert FFN ----
    g = torch.einsum("ecd,edf->ecf", buf, params["w_gate"])
    u = torch.einsum("ecd,edf->ecf", buf, params["w_in"])
    h = F.silu(g) * u
    eo = torch.einsum("ecf,efd->ecd", h, params["w_out"])

    # ---- gather back and combine with the gate weights, in order ----
    eo_flat = torch.cat([eo.reshape(El * C, D), eo.new_zeros((1, D))])
    gates = tp_enter(gate_vals) if split else gate_vals
    per_slot = eo_flat[slot] * gates.reshape(T * K)[:, None].to(x.dtype)
    parts = [(per_slot.reshape(T, K, D).sum(dim=1), split)]

    # ---- the shared expert; the partial sums reduced once ----
    if sp is not None:
        xs = xe if sh_split else xt
        h = F.silu(xs @ sp["w_gate"]) * (xs @ sp["w_in"])
        parts.append((h @ sp["w_out"], sh_split))
    partial = [y for y, p in parts if p]
    whole = [tp_reduce(sum(partial[1:], partial[0]))] if partial else []
    whole += [y for y, p in parts if not p]
    return sum(whole[1:], whole[0]).reshape(B, S, D), aux
