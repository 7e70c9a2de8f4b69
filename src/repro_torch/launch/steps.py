"""Step-function builders shared by the dry run and the launchers. Port of
``repro/launch/steps.py``. PyTorch runs eagerly, so a step is a plain
function (the reference jits them).

Training: ``make_train_step`` (one federated round over (C, K, b, ...)
batches, on the vmap engine or the flat one, as the reference resolves
them from an ``FLConfig``), ``make_train_loop`` (R rounds fused,
``core.fed_loop.make_fl_loop``), ``make_fleet_train_loop`` (the fleet
loop) and ``abstract_fl_state`` (the ``FLState`` on fake tensors).
``launch.train.train_lm`` builds its rounds itself, as the reference's
does. Every builder's loss runs the model's plain route
(``use_pallas=False``, which the kernel wrappers need to differentiate);
``use_pallas`` reaches the client optimizer (the Δ-SGD kernel route)
and the flat engine's mode, as in the port's train CLI.

Tensor-parallel training: ``train_rules`` makes the training
``LogicalRules`` of a model on a mesh (the reference's
``LogicalRules(spec, mesh, serve=False)``, with the params' placement),
``place_train_for_rank`` cuts a whole ``FLState`` and a round's batches
to one rank's blocks (params by ``param_placements``, the state by
``state_placements``, batches with C over the client axes and b over
the fsdp axes), and the vmap engine's round, called with the rules
installed (``models.common.logical_rules``), runs on them.
``train_collectives`` is what one such round makes on a rank, by role.

Tensor-parallel serving: ``serve_rules`` makes the serve
``LogicalRules`` of a model on a mesh (the reference's
``LogicalRules(spec, mesh, serve=True)`` with the params' placement),
``place_for_rank`` cuts whole params, a batch and a cache to one rank's
blocks by the reference's rules (``place_prefill_cache`` a prefill's
cache, whole over its time dim, to the same blocks), and a builder given
``rules`` runs its step under them on those local trees.
``serve_collectives`` is what one such step issues on a rank, by role.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.models.common import logical_rules, remat_blocks
from repro_torch.sharding.hlo import SEQ_ROLES, SSM_ROLES, XLSTM_ROLES
from repro_torch.models.model import (Model, local_vocab, moves_rows,
                                      refuse_seq_cut, tp_refusal)
from repro_torch.sharding.spec import (FederationSpec, LogicalRules,
                                       batch_shardings, cache_shardings,
                                       client_axes_on, entry_axes,
                                       get_federation_spec, grad_sync_axes,
                                       local_block, mesh_shape, norm_axes,
                                       param_placements,
                                       serve_batch_shardings, unread_seq_cut)
from repro_torch.utils.tree import tree_flatten, tree_map


def _under(rules):
    return logical_rules(rules) if rules is not None \
        else contextlib.nullcontext()


def make_prefill_step(model: Model, *, window: Optional[int] = None,
                      cache_len: Optional[int] = None,
                      use_pallas: bool = True,
                      rules: Optional[LogicalRules] = None):
    """fn(params, batch) -> (last-position logits, decode cache); under
    ``rules``, on one rank's local params and batch rows."""
    def prefill_step(params, batch):
        with _under(rules):
            return model.prefill(params, batch, cache_len=cache_len,
                                 window=window, use_pallas=use_pallas)

    return prefill_step


def make_serve_step(model: Model, *, window: Optional[int] = None,
                    rules: Optional[LogicalRules] = None):
    """fn(params, cache, tokens (B,1)) -> (greedy next tokens (B,1),
    cache); under ``rules``, on one rank's local params, rows and
    cache (the logits are whole over the vocab before the argmax)."""
    def serve_step(params, cache, tokens):
        with _under(rules):
            logits, cache = model.decode_step(params, cache, tokens,
                                              window=window)
        return torch.argmax(logits, dim=-1), cache

    return serve_step


def serve_rules(model: Model, mesh, params, *,
                spec: Optional[FederationSpec] = None, coords=None,
                seq_shard: bool = False,
                batch_size: Optional[int] = None) -> LogicalRules:
    """The serve rules of ``model`` on ``mesh`` for the rank at
    ``coords`` (the mesh's own by default). ``params`` is the whole
    params tree or its fake-tensor struct (``launch.specs.params_struct``):
    only shapes are read. ``spec`` defaults to the config's federation
    (``launch.specs.federation_kind``). ``batch_size`` is the global
    batch the steps serve (``LogicalRules``: one row is not split). An
    MoE layer's capacity order depends on whether the data axes split
    the rows, so an MoE config on data axes of size > 1 needs it.
    Refuses a config that tensor-parallel serving does not run
    (``models.model.tp_refusal``)."""
    from repro_torch.launch.specs import federation_kind
    spec = spec or get_federation_spec(federation_kind(model.cfg), mesh)
    _refuse(model, spec, mesh)
    rules = LogicalRules(spec, mesh, serve=True, seq_shard=seq_shard,
                         coords=coords, batch_size=batch_size,
                         param_axes=param_placements(spec, mesh, params))
    if batch_size is None and "moe" in model.cfg.layer_types \
            and rules.batch_axes:
        raise ValueError(f"{model.cfg.name}: serving an MoE on data axes "
                         "of size > 1 needs the global batch_size (a "
                         "batch of one row is not split, and its "
                         "capacity order is then the rank's own)")
    return rules


def _refuse(model: Model, spec: FederationSpec, mesh) -> None:
    """Raise where tensor parallelism on ``mesh`` does not run the
    model (``tp_refusal``)."""
    tp = spec.tp_axes[0] if spec.tp_axes else None
    why = tp_refusal(model.cfg, mesh_shape(mesh).get(tp, 1) if tp else 1)
    if why:
        raise ValueError(why)


def _cut(tree, axes, rules, device):
    return tree_map(lambda x, a: local_block(x, a, rules.mesh, rules.coords
                                             ).contiguous().to(device),
                    tree, axes)


def place_for_rank(rules: LogicalRules, *, params=None, batch=None,
                   cache=None, batch_size: Optional[int] = None,
                   device=None, cache_seq_shard: Optional[bool] = None
                   ) -> Dict:
    """One rank's blocks of whole ``params``, ``batch`` and ``cache``
    by the reference's rules (``param_placements``,
    ``serve_batch_shardings``, ``cache_shardings`` with ``batch_size``,
    the global batch), each copied to ``device`` (its own by default).
    Returns {"params", "batch", "cache"}: those given. Refuses a batch
    or ``batch_size`` other than the rules' own ``batch_size``, and a
    cache whose placement cuts the Mamba2 conv's taps over the tensor
    axis (``unread_seq_cut``, ROADMAP A17). Where the rows do not split
    over the data axes, an attention cache's time dim and an xLSTM
    state's heads or units are cut over ``model``, as the reference's
    table cuts them, and the decode reads those blocks;
    ``cache_seq_shard`` (by default the rules' ``seq_shard``:
    ``cache_shardings``' switch) cuts a batch-split cache's time dim
    over ``model`` too.

    A Mamba2 run's cache is then narrowed to the rank's heads and conv
    channels (``_mamba2_rank_cache``), a difference by design: where
    the rows split over the data axes, the reference's table leaves
    ``ssm`` and ``conv`` whole on every ``model`` rank, and with one
    data rank it cuts ``ssm``'s heads over ``model``, the same block;
    the port's rank keeps only the state its heads read."""
    out = {}
    if params is not None:
        out["params"] = _cut(params, rules.param_axes, rules, device)
    rows = [x.shape[0] for x in tree_flatten(batch or {})[0]]
    if cache is not None and batch_size is not None:
        rows.append(batch_size)
    if rules.batch_size is not None and set(rows) - {rules.batch_size}:
        raise ValueError(f"a batch of {rows} rows under rules made for "
                         f"{rules.batch_size}")
    if batch is not None:
        out["batch"] = _cut(batch, serve_batch_shardings(rules.mesh, batch),
                            rules, device)
    if cache is not None:
        if batch_size is None:
            raise ValueError("a cache is placed by its global batch_size")
        seq = rules.seq_shard if cache_seq_shard is None \
            else cache_seq_shard
        cut = unread_seq_cut(rules.spec, rules.mesh, cache,
                             batch_size=batch_size, seq_shard=seq)
        if cut:
            raise ValueError(refuse_seq_cut(cut))
        local = _cut(cache, cache_shardings(
            rules.spec, rules.mesh, cache, batch_size=batch_size,
            seq_shard=seq), rules, device)
        for key, run in local.get("runs", {}).items():
            if set(run) == {"ssm", "conv"}:
                local["runs"][key] = _mamba2_rank_cache(
                    rules, run, cache["runs"][key])
        out["cache"] = local
    return out


def place_prefill_cache(rules: LogicalRules, cache: Dict,
                        batch_size: int) -> Dict:
    """A prefill's decode cache on this rank narrowed to the rank's
    block of it (``cache_shardings`` with the global ``batch_size``).
    Prefill keeps every time entry of the rank's rows; where the rows do
    not split over the data axes, the placement cuts the attention
    caches' time dims and the xLSTM states' heads or units over
    ``model``, and this takes the rank's blocks of them. Where the rows
    split, the prefill's cache is the rank's block already. A Mamba2
    run (the rank's heads and channels) is kept as it is; a cache whose
    Mamba2 conv taps the placement cuts is refused (``unread_seq_cut``,
    ROADMAP A17)."""
    if rules.cache_rows(batch_size) < batch_size:
        return cache
    cut = unread_seq_cut(rules.spec, rules.mesh, cache,
                         batch_size=batch_size)
    if cut:
        raise ValueError(refuse_seq_cut(cut))
    axes = cache_shardings(rules.spec, rules.mesh, cache,
                           batch_size=batch_size)
    out = dict(cache)
    out["runs"] = {k: run if set(run) == {"ssm", "conv"} else
                   _cut(run, axes["runs"][k], rules, None)
                   for k, run in cache["runs"].items()}
    if "enc_kv" in cache:
        out["enc_kv"] = _cut(cache["enc_kv"], axes["enc_kv"], rules, None)
    return out


def _mamba2_rank_cache(rules: LogicalRules, local: Dict, whole: Dict):
    """A Mamba2 run's cache ``local`` (its rows cut) narrowed to the
    rank's heads (``ssm``: (n, B, h, P, N)) and conv channels (``conv``:
    its heads' x, its groups' B and C), the dims read from the ``whole``
    cache's shapes."""
    from repro_torch.models import ssm
    _, _, H, P, N = whole["ssm"].shape
    G = (whole["conv"].shape[-1] - H * P) // (2 * N)
    h0, h, g0, g = ssm.rank_heads(H, G, rules.size(rules.tp),
                                  rules.index(rules.tp))
    s = local["ssm"]
    if s.shape[2] == H:
        s = s.narrow(2, h0, h)
    conv = ssm.pick_channels(local["conv"], ssm.rank_channels(
        ssm.Mixer(h0, h, g0, g, H, False, False), P, G, N))
    return {"ssm": s.contiguous(), "conv": conv.contiguous()}


def _live(rules: LogicalRules, entry) -> tuple:
    """The axes of ``entry`` of size > 1."""
    return tuple(a for a in entry_axes(entry) if rules.size(a) > 1)


def _layers(model: Model, ax, where=("stack",), layer_types=None) -> list:
    """(block type, the layer's placement entries) of every layer of
    the stack at ``where`` (the decoder's; the encoder's is
    ``("encoder", "stack")`` with its ``layer_types``), in order: a
    stacked run's entries without their layer axis, the shared block's
    at each of its sites."""
    from repro_torch.models.transformer import layer_axes, segment_runs
    for k in where:
        ax = ax[k]
    out = []
    for i, (btype, n) in enumerate(segment_runs(layer_types
                                                or model.cfg.layer_types)):
        out += [(btype, layer_axes(ax, i, btype, n))] * n
    return out


def _enc_layers(model: Model, ax) -> list:
    """The encoder's layers (``_layers``), none without an encoder."""
    n = model.cfg.encoder_layers
    return _layers(model, ax, ("encoder", "stack"), ("attn",) * n) \
        if n else []




def _layer_ops(rules: LogicalRules, cfg, btype: str, layer, *,
               encoder: bool = False, decode: bool = False,
               cut=frozenset()) -> Dict:
    """The collectives one block's forward makes on a rank (``fwd``: per
    role), its backward's ``tp_grad`` count (``grad``) and its other
    backward ops (``bwd``: per role) under ``rules``. An attention
    block: a ``tp_reduce`` after attention where its heads are split
    and after the MLP or MoE layer where its units or experts are (the
    routed and shared experts' partials in one), a ``kv_gather`` where
    GQA's KV heads are split (its cache's; none in an ``encoder``
    block, which builds none), an ``fsdp_gather`` for each fsdp dim of
    the layer's params, and in an MoE layer the counts' ``moe_counts``
    gather and, under training rules, the aux loss's ``moe_aux`` sum
    where the batch splits over ranks. A decoder block's
    cross-attention adds its ``tp_reduce``; its K/V from the encoder
    (``x_kv_gather``: the cache's gather of a split projection under
    serving rules, ``x_fsdp_gather``: the gathers of its K/V
    projections at use, which the block does not gather) run once a
    prefill or a forward, outside the block. A Mamba2 block
    makes ``ssm_zx``, ``ssm_conv`` and ``ssm_norm`` where its columns,
    conv channels and heads are split, and a ``tp_reduce``. The
    backward sums a partial gradient (``tp_grad``) where a replicated
    tensor entered a split layer: GQA's input (and its QKV biases and
    whole-KV ``wk``/``wv``), MLA's latents, the MLP's input, the MoE's
    tokens and its gate values, cross-attention's queries and the
    encoder output it projects (and their biases and whole-KV
    ``wk``/``wv``), the Mamba2 mixer's input.

    An mLSTM block makes ``xlstm_up``, ``xlstm_qkv`` and a ``tp_reduce``
    where its d_in is split (the ``xlstm_up`` reduce-scatter and two
    ``tp_grad`` in the backward: its input and its recurrence's output),
    and a decode step on a cache of the rank's heads (``cut`` holds
    ``"mlstm"``) an ``xlstm_norm``. An sLSTM block: at prefill and in
    training ``xlstm_wx`` and, where ``r``'s rows are a block,
    ``xlstm_r`` (no backward op: the cells are replicated; a
    ``tp_grad`` at its input); a ``decode`` step ``xlstm_rec`` (or
    ``xlstm_wx`` with ``r`` whole), and ``xlstm_state`` on a cache cut
    over its units (``"slstm"`` in ``cut``); a ``tp_reduce`` (and a
    ``tp_grad``) where its feed-forward is split. A decode step on an
    attention cache cut over its time dim (``"attn"`` in ``cut``; the
    cross-attention's cached encoder K/V: ``"enc"``) adds each
    attention's ``seq_q`` (where its heads are split), ``seq_max`` and
    ``seq_sum``."""
    from repro_torch.models.attention import CROSS_KV
    tp = rules.tp if rules.size(rules.tp) > 1 else None
    on_tp = lambda entry: tp is not None and tp in entry_axes(entry)

    def fsdp(tree):
        return sum(bool(tuple(x for x in _live(rules, e) if x != rules.tp))
                   for e in tree_flatten(tree)[0])

    # the block gathers its params but the cross K/V projections
    x_kv = {k: v for k, v in layer.get("xattn", {}).items() if k in CROSS_KV}
    fwd = {"tp_reduce": 0, "kv_gather": 0, "moe_counts": 0, "moe_aux": 0,
           "fsdp_gather": fsdp(layer) - fsdp(x_kv)}
    fwd.update({r: 0 for r in SSM_ROLES + XLSTM_ROLES + SEQ_ROLES})
    if btype == "mlstm":
        mx = layer["mixer"]
        split = on_tp(mx["wq"][0])
        fwd.update(xlstm_up=int(on_tp(mx["w_up"][1])),
                   xlstm_qkv=int(split), tp_reduce=int(split),
                   xlstm_norm=int(split and decode and "mlstm" in cut))
        return {"fwd": fwd, "grad": 2 * split,
                "bwd": {"xlstm_up": fwd["xlstm_up"]}}
    if btype == "slstm":
        mx = layer["mixer"]
        wx, r, ff = (on_tp(mx[k][i]) for k, i in
                     (("w_x", 1), ("r", 1), ("ff_gate", 1)))
        fwd.update(tp_reduce=int(ff), xlstm_state=int(decode
                                                      and "slstm" in cut))
        if decode:
            fwd.update(xlstm_rec=int(r), xlstm_wx=int(wx and not r))
        else:
            fwd.update(xlstm_wx=int(wx), xlstm_r=int(r))
        return {"fwd": fwd, "grad": int(wx) + int(ff), "bwd": {}}
    if btype == "mamba2":
        mx = layer["mixer"]
        heads = on_tp(mx["A_log"][0])
        fwd.update(ssm_zx=int(on_tp(mx["w_zx"][1])),
                   ssm_conv=int(on_tp(mx["conv_w"][1])),
                   ssm_norm=int(heads), tp_reduce=int(heads))
        return {"fwd": fwd, "grad": int(heads),
                "bwd": {r: fwd[r] for r in SSM_ROLES}}
    a = layer["attn"]
    seq = decode and "attn" in cut
    if cfg.use_mla:
        split = on_tp(a["wq_b"][1])
        fwd["tp_reduce"] += split
        grad = int(split)
    else:
        split = on_tp(a["wq"][1])
        kv_whole = split and not on_tp(a["wk"][1])
        fwd["tp_reduce"] += split
        fwd["kv_gather"] += on_tp(a["wk"][1]) and not encoder
        grad = split + (3 * split if cfg.qkv_bias else 0) + 2 * kv_whole
    fwd.update(seq_q=int(seq and split), seq_max=int(seq),
               seq_sum=int(seq))
    if "xattn" in layer:
        x = layer["xattn"]
        xsplit = on_tp(x["wq"][1])
        x_whole = xsplit and not on_tp(x["wk"][1])
        xseq = decode and "enc" in cut
        fwd["tp_reduce"] += xsplit
        fwd["seq_q"] += xseq and xsplit
        fwd["seq_max"] += xseq
        fwd["seq_sum"] += xseq
        fwd["x_kv_gather"] = int(on_tp(x["wk"][1]))
        fwd["x_fsdp_gather"] = fsdp(x_kv)
        grad += 2 * xsplit + (3 * xsplit if cfg.qkv_bias else 0) \
            + 2 * x_whole
    if btype == "moe":
        m = layer["moe"]
        ex = on_tp(m["w_gate"][0])
        sh = "shared" in m and on_tp(m["shared"]["w_out"][0])
        fwd["tp_reduce"] += ex or sh
        batch = bool(rules.batch_axes)
        fwd["moe_counts"] += batch
        fwd["moe_aux"] += batch and not rules.serve
        grad += (ex or sh) + ex
    else:
        split = on_tp(layer["mlp"]["w_out"][0])
        fwd["tp_reduce"] += split
        grad += split
    return {"fwd": fwd, "grad": grad, "bwd": {}}


def cut_blocks(model: Model, cache: Dict) -> frozenset:
    """Which of a rank's decode ``cache`` the placement cut over
    ``model`` (``cache_shardings`` at rows that do not split over the
    data axes), read from its shapes: ``"attn"`` (an attention cache's
    time dim), ``"enc"`` (the cached encoder K/V's positions),
    ``"mlstm"`` (an mLSTM state's heads), ``"slstm"`` (an sLSTM state's
    units)."""
    from repro_torch.models.transformer import ATTN_TYPES, segment_runs
    cfg, out = model.cfg, set()
    W = cache["positions"].shape[-1]
    for i, (btype, _) in enumerate(segment_runs(cfg.layer_types)):
        run = cache["runs"][f"run{i}"]
        if btype in ATTN_TYPES:
            leaf = run["c_kv"] if cfg.use_mla else run["k"]
            if leaf.shape[2] < W:
                out.add("attn")
        elif btype == "mlstm" and run["C"].shape[2] < cfg.num_heads:
            out.add("mlstm")
        elif btype == "slstm" and run["h"].shape[-1] < cfg.d_model:
            out.add("slstm")
    if "enc_kv" in cache and \
            cache["enc_kv"]["xk"].shape[2] < cfg.encoder_seq:
        out.add("enc")
    return frozenset(out)


def _sum_ops(ops) -> Dict[str, int]:
    out = {}
    for o in ops:
        for r, n in o.items():
            out[r] = out.get(r, 0) + n
    return out


def serve_collectives(model: Model, rules: LogicalRules, rows: int,
                      seq: int, *, prefill: Optional[bool] = None,
                      cache: Optional[Dict] = None) -> Dict[str, int]:
    """The collectives one tensor-parallel step issues on a rank whose
    batch has ``rows`` rows of ``seq`` tokens (``prefill``, by default
    ``seq > 1``: the prompt; a decode step: 1), by role: each layer's
    (``_layer_ops``: a ``tp_reduce`` after attention and after the MLP
    or MoE layer where they are split, a ``kv_gather`` where GQA's KV
    heads are (the cache holds them all; MLA caches its replicated
    latent), an MoE layer's ``moe_counts`` where the batch splits over
    the data axes, an ``fsdp_gather`` for every fsdp dim of the layer's
    params; a Mamba2 layer's ``ssm_zx``, ``ssm_conv``, ``ssm_norm`` and
    ``tp_reduce``; a decoder layer's cross-attention ``tp_reduce``, and
    at prefill its K/V's ``kv_gather`` and the gathers of its params);
    at prefill the encoder's layers (no ``kv_gather``); a
    ``vocab`` all-reduce of the embedding and a ``vocab`` gather of the
    logits where the vocab is split; for each vocab table whose model
    dim is fsdp-sharded, its ``fsdp_gather`` or, where moving the fsdp
    group's rows costs less (``models.model.moves_rows``), two
    ``fsdp_rows`` ops; an xLSTM layer's mixer roles
    (``hlo.XLSTM_ROLES``). A decode step reads ``cache``, the rank's
    decode cache, for the dims its placement cut over ``model``
    (``cut_blocks``): a time block's ``seq_q``, ``seq_max`` and
    ``seq_sum`` in each attention, an mLSTM's ``xlstm_norm``, an
    sLSTM's ``xlstm_state``; without it, a cache with no dim cut (the
    prefill's). Axes of size 1 make none."""
    cfg, ax = model.cfg, rules.param_axes
    tp = rules.tp if rules.size(rules.tp) > 1 else None
    on_tp = lambda entry: tp is not None and tp in entry_axes(entry)

    def fsdp_axes(entry):
        return tuple(a for a in _live(rules, entry) if a != rules.tp)

    def fsdp(entries):
        return sum(bool(fsdp_axes(e)) for e in entries)

    if prefill is None:
        prefill = seq > 1
    cut = frozenset() if prefill or cache is None else cut_blocks(model,
                                                                  cache)
    ops = [_layer_ops(rules, cfg, bt, layer, decode=not prefill,
                      cut=cut)["fwd"]
           for bt, layer in _layers(model, ax)]
    if prefill:
        ops += [_layer_ops(rules, cfg, bt, layer, encoder=True)["fwd"]
                for bt, layer in _enc_layers(model, ax)]
    n = _sum_ops(ops)
    x_kv, x_fsdp = n.pop("x_kv_gather", 0), n.pop("x_fsdp_gather", 0)
    if prefill:     # the cross K/V, once a prefill
        n["kv_gather"] += x_kv
        n["fsdp_gather"] += x_fsdp
    # an MoE's, a recurrent mixer's and a time block's, where they make
    # them
    for r in ("moe_counts", "moe_aux") + SSM_ROLES + XLSTM_ROLES \
            + SEQ_ROLES:
        if not n[r]:
            del n[r]
    n["fsdp_rows"] = 0
    v_loc = local_vocab(cfg, rules)

    def table(key, vdim, tokens, head):
        group = fsdp_axes(ax[key][1 - vdim])
        if group and moves_rows(tokens * rules.size(group), cfg.d_model,
                                v_loc, head):
            n["fsdp_rows"] += 2
        else:
            n["fsdp_gather"] += fsdp(ax[key])

    # the embedding's table, then the head's (at the last position)
    table("embed", 0, rows * seq, False)
    if cfg.tie_embeddings:
        n["fsdp_gather"] += fsdp(ax["embed"])
        n["vocab"] = 2 * on_tp(ax["embed"][0])
    else:
        table("lm_head", 1, rows, True)
        n["vocab"] = on_tp(ax["embed"][0]) + on_tp(ax["lm_head"][1])
    return n


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
def _resolve_scenario(fl: FLConfig, scenario):
    """``scenario`` (a Scenario, a preset name or None, defaulting to
    ``fl.scenario``) with the FLConfig's robust-aggregation overrides
    folded in. ``robust_agg="mean"`` and ``quorum=0`` are inert; other
    values need a Scenario to live on, so they promote a bare config to
    the ``sync_iid`` preset (the reference's rule)."""
    if scenario is None and fl.scenario:
        scenario = fl.scenario
    overrides = {}
    if fl.robust_agg != "mean":
        overrides["robust_agg"] = fl.robust_agg
    if fl.quorum:
        overrides["quorum"] = fl.quorum
    if scenario is None and not overrides:
        return None
    if scenario is not None and hasattr(scenario, "is_async") \
            and not overrides:
        return scenario
    from repro_torch.federation import get_scenario
    return get_scenario(scenario if scenario is not None else "sync_iid",
                        **overrides)


def _train_parts(model: Model, fl: FLConfig, use_pallas, remat, scenario,
                 compression):
    from repro_torch.compression import get_compression
    from repro_torch.core import get_client_opt, get_server_opt, make_loss
    copt = get_client_opt(fl.client_opt, fl, use_pallas=use_pallas)
    sopt = get_server_opt(fl.server_opt)
    scenario = _resolve_scenario(fl, scenario)
    compression = get_compression(compression if compression is not None
                                  else fl.compression_spec)

    def base_loss(params, batch):
        with remat_blocks(remat):
            return model.loss(params, batch, use_pallas=False)

    loss_fn = make_loss(base_loss, fedprox_mu=fl.fedprox_mu)
    return copt, sopt, scenario, compression, loss_fn


def _needs_delta_sgd(fl: FLConfig, what: str):
    if fl.client_opt != "delta_sgd":
        raise ValueError(f"{what} requires client_opt='delta_sgd', got "
                         f"{fl.client_opt!r}")


def make_train_step(model: Model, fl: FLConfig, *, num_rounds: int = 1000,
                    use_pallas: bool = False, remat: bool = False,
                    flat: Optional[bool] = None, mesh=None,
                    federation=None, scenario=None, compression=None):
    """One federated round over the (C, K, b, ...) batch layout:
    ``train_step(state, client_batches) -> (state, metrics)``.

    ``flat`` defaults to ``fl.flat_engine``; async, fault, robust and
    quorum scenarios and an active compression switch the flat engine
    on, as in the reference. ``mesh`` + ``federation`` (flat engine
    only) run the round on a rank's block of the sharded (C, N) buffer:
    its local steps run the model on the rank's tensor-parallel blocks
    under the training rules the caller installs (``train_rules``,
    the batches cut by ``place_train_for_rank``; ``core.sharded``), the
    whole model gathered at use where none are installed. The vmap
    engine runs tensor-parallel where the caller installs training
    rules around the call. ``remat`` turns on per-block
    rematerialisation inside the loss. Returns (train_step, sopt,
    scenario, compression): the resolved scenario and compression, so
    the caller can allocate a matching ``init_fl_state``."""
    from repro_torch.core import make_fl_round
    copt, sopt, scenario, compression, loss_fn = _train_parts(
        model, fl, use_pallas, remat, scenario, compression)
    if flat is None:
        flat = fl.flat_engine
    if scenario is not None and (scenario.is_async or scenario.faulty
                                 or scenario.robust or scenario.quorum > 0):
        flat = True
    if compression.active(scenario):
        flat = True
    flat_mode = False
    if flat:
        _needs_delta_sgd(fl, "the flat engine")
        flat_mode = "pallas" if use_pallas else "xla"
    round_fn = make_fl_round(loss_fn, copt, sopt, num_rounds=num_rounds,
                             weighted=fl.weighted_agg, flat=flat_mode,
                             mesh=mesh, federation=federation,
                             scenario=scenario, num_clients=fl.num_clients,
                             compression=compression)

    def train_step(state, client_batches):
        new_state, metrics, _ = round_fn(state, client_batches)
        return new_state, metrics

    return train_step, sopt, scenario, compression


def make_train_loop(model: Model, fl: FLConfig, *, num_rounds: int = 1000,
                    rounds_per_call: int = 8, use_pallas: bool = False,
                    remat: bool = False, mesh=None, federation=None,
                    scenario=None, compression=None):
    """R rounds fused into one call (``core.fed_loop.make_fl_loop``) on
    the flat state; the flat engine is required, so ``fl.client_opt``
    must be ``delta_sgd``. Under ``mesh`` + ``federation`` it runs the
    sharded round's body on a rank's blocks. Returns (train_loop, sopt,
    scenario, compression); the loop exposes ``.layout``."""
    from repro_torch.core import make_fl_loop
    from repro_torch.launch.specs import params_struct
    _needs_delta_sgd(fl, "the round-fused loop")
    copt, sopt, scenario, compression, loss_fn = _train_parts(
        model, fl, use_pallas, remat, scenario, compression)
    loop = make_fl_loop(loss_fn, copt, sopt,
                        params_like=params_struct(model),
                        num_rounds=num_rounds,
                        rounds_per_call=rounds_per_call,
                        weighted=fl.weighted_agg,
                        flat="pallas" if use_pallas else "xla", mesh=mesh,
                        federation=federation, scenario=scenario,
                        num_clients=fl.num_clients,
                        compression=compression)
    return loop, sopt, scenario, compression


def make_fleet_train_loop(model: Model, fl: FLConfig, *,
                          num_rounds: int = 1000, rounds_per_call: int = 8,
                          use_pallas: bool = False, remat: bool = False,
                          scenario=None, compression=None,
                          client_sizes=None, gather=None,
                          batch_index_fn=None, eta_carry: bool = False,
                          seed: Optional[int] = None):
    """The fleet variant of ``make_train_loop``
    (``core.fed_loop.make_fleet_loop``): the carry is (FlatFLState,
    ClientArena) over ``fl.registered_clients``. The port's fleet loop
    trains on the data pipeline's host draw of a block's cohorts, which
    the caller passes as ``cohort_ids`` (ROADMAP C): the reference's
    ``seed`` and ``client_sizes``, which feed its on-device redraw, are
    refused. Returns (train_loop, sopt, scenario, compression)."""
    from repro_torch.core import make_fleet_loop
    from repro_torch.launch.specs import params_struct
    if not fl.fleet:
        raise ValueError("make_fleet_train_loop needs the fleet regime: "
                         "set FLConfig.num_registered_clients")
    _needs_delta_sgd(fl, "the fleet loop")
    if seed is not None or client_sizes is not None:
        raise ValueError(
            "seed and client_sizes feed the reference's on-device cohort "
            "redraw; the port's fleet loop takes the pipeline's draw "
            "(loop(..., cohort_ids=...)), so they have no effect here")
    copt, sopt, scenario, compression, loss_fn = _train_parts(
        model, fl, use_pallas, remat, scenario, compression)
    loop = make_fleet_loop(loss_fn, copt, sopt,
                           params_like=params_struct(model),
                           num_rounds=num_rounds,
                           num_registered=fl.registered_clients,
                           rounds_per_call=rounds_per_call,
                           weighted=fl.weighted_agg,
                           flat="pallas" if use_pallas else "xla",
                           scenario=scenario, compression=compression,
                           gather=gather, batch_index_fn=batch_index_fn,
                           eta_carry=eta_carry)
    return loop, sopt, scenario, compression


def abstract_fl_state(model: Model, sopt, scenario=None, compression=None,
                      cohort=None, mode=None):
    """The ``FLState`` as fake tensors, allocating nothing: its async
    buffer where ``scenario`` is async, its EF21 tree where
    ``compression`` has error feedback (``cohort`` sizes its leading
    axis). Made in ``mode`` (a FakeTensorMode) or a fresh one."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import init_fl_state
    from repro_torch.launch.specs import params_struct
    mode = mode if mode is not None else FakeTensorMode()
    pstruct = params_struct(model, mode)
    with mode:
        return init_fl_state(pstruct, sopt, scenario, compression, cohort)


def train_rules(model: Model, mesh, params, *,
                spec: Optional[FederationSpec] = None,
                coords=None) -> LogicalRules:
    """The training rules of ``model`` on ``mesh`` for the rank at
    ``coords`` (the mesh's own by default): the reference's
    ``LogicalRules(spec, mesh, serve=False)`` (batch rows over the fsdp
    axis) with the params' placement. ``params`` is the whole tree or
    its fake-tensor struct. ``spec`` defaults to the config's
    federation. Refuses a config that tensor-parallel training does not
    run (``models.model.tp_refusal``)."""
    from repro_torch.launch.specs import federation_kind
    spec = spec or get_federation_spec(federation_kind(model.cfg), mesh)
    _refuse(model, spec, mesh)
    return LogicalRules(spec, mesh, serve=False, coords=coords,
                        param_axes=param_placements(spec, mesh, params))


def state_placements(spec: FederationSpec, mesh, state, placements):
    """The entries of every leaf of an ``FLState`` (the reference's
    ``dryrun._state_shardings``): params by ``placements``; a server
    state slot shaped like the params (FedAvgM's ``m``, FedAdam's ``m``
    and ``v``) by the same; its scalars, the round and the async
    buffer's counters replicated; the buffer's delta like the params;
    the EF21 tree's leading cohort axis over the client axes."""
    from repro_torch.core.fed_round import FLState
    pdef = tree_flatten(state.params)[1]

    def rep(tree):
        return tree_map(lambda x: (None,) * len(tuple(x.shape)), tree)

    def slot(sub):
        return placements if tree_flatten(sub)[1] == pdef else rep(sub)

    ss = state.server_state
    srv = ({k: slot(v) for k, v in ss.items()} if isinstance(ss, dict)
           else rep(ss))
    buf = None
    if state.buffer is not None:
        from repro_torch.federation.buffer import AsyncBufferState
        b = state.buffer
        buf = AsyncBufferState(placements, *(rep(x) for x in b[1:]))
    ef = None
    if state.ef is not None:
        ca = client_axes_on(spec, mesh)
        lead = ca if len(ca) > 1 else (ca[0] if ca else None)
        ef = tree_map(lambda x: (lead,) + (None,) * (len(tuple(x.shape))
                                                     - 1), state.ef)
    return FLState(placements, srv, (), buf, ef)


def place_train_for_rank(rules: LogicalRules, *, state=None, params=None,
                         batch=None, device=None) -> Dict:
    """One rank's blocks of a whole ``FLState`` (``state_placements``),
    params and a round's (C, K, b, ...) batches (``batch_shardings``: C
    over the client axes, b over the fsdp axes), each copied to
    ``device`` (its own by default). Returns {"state", "params",
    "batch"}: those given."""
    from repro_torch.core.fed_round import FLState
    out = {}
    if params is not None:
        out["params"] = _cut(params, rules.param_axes, rules, device)
    if state is not None:
        sp = state_placements(rules.spec, rules.mesh, state,
                              rules.param_axes)
        fields = []
        for name, x, ax in zip(FLState._fields, state, sp):
            if name == "round" or x is None:
                fields.append(x)
            elif name == "buffer":
                fields.append(type(x)(*(_cut(a, b, rules, device)
                                        for a, b in zip(x, ax))))
            else:
                fields.append(_cut(x, ax, rules, device))
        out["state"] = FLState(*fields)
    if batch is not None:
        out["batch"] = _cut(batch, batch_shardings(rules.spec, rules.mesh,
                                                   batch), rules, device)
    return out


def train_collectives(model: Model, rules: LogicalRules, *, local_steps: int,
                      remat: bool = False,
                      weighted: bool = False) -> Dict[str, int]:
    """The collectives one tensor-parallel vmap round of ``local_steps``
    Δ-SGD steps makes on a rank, by role (each op runs once on the
    rank's stacked clients). A local step's forward makes each layer's
    (``_layer_ops``: ``tp_reduce``, an MoE layer's ``moe_counts`` and
    ``moe_aux`` where the rows split over the fsdp axes, a Mamba2
    layer's ``ssm_zx``, ``ssm_conv`` and ``ssm_norm``, an
    ``fsdp_gather`` for each fsdp dim of its params; an xLSTM layer's
    mixer roles), the encoder's
    layers' and each decoder layer's cross K/V (the gathers of its
    projections at use); its backward a ``tp_grad`` where a replicated
    tensor entered a split layer, an ``fsdp_scatter`` for each gather
    and one op of each Mamba2 role (the gathers' reduce-scatters, the
    norm's sum), one ``xlstm_up`` (the mLSTM gather's reduce-scatter).
    Remat runs each layer's forward collectives again in
    the backward. The embedding and head: a
    ``vocab`` reduce of the vocab-parallel lookup, the cross-entropy's
    max and its one stacked ``vocab`` sum, a ``tp_grad`` at the head's
    input, an fsdp gather and scatter for each vocab table's fsdp dim,
    and a ``loss`` sum where the rows split over an fsdp axis.
    DeepSeek-V3's MTP block (never rematerialised) adds its own lookup,
    its column-parallel ``proj`` (a ``tp_grad`` at its input, one
    ``mtp_gather`` of its output), its block's collectives, its head's
    as above, and the fsdp gathers of its params and of the tables it
    reads again. Then one ``grad_sync`` where a leaf's gradient is
    partial over the fsdp axes, and one ``norms`` sum of Δ-SGD's two
    sums. A round adds one ``fedavg`` sum and one ``metrics`` gather
    over the client axes. Axes of size 1 make none."""
    cfg, ax = model.cfg, rules.param_axes
    tp = rules.tp if rules.size(rules.tp) > 1 else None
    on_tp = lambda entry: tp is not None and tp in entry_axes(entry)

    def fsdp(entries):
        return sum(bool(tuple(a for a in _live(rules, e) if a != rules.tp))
                   for e in entries)

    K = local_steps
    tables = ("embed",) if cfg.tie_embeddings else ("embed", "lm_head")
    table_gather = sum(fsdp(ax[t]) for t in tables)
    vocab_split = on_tp(ax["embed"][0]) if cfg.tie_embeddings \
        else on_tp(ax["lm_head"][1])
    rows_split = int(rules.size(rules.map["batch"]) > 1)
    step = {"tp_reduce": 0, "moe_counts": 0, "moe_aux": 0,
            "fsdp_gather": table_gather, "fsdp_scatter": table_gather,
            "tp_grad": vocab_split,
            "vocab": on_tp(ax["embed"][0]) + 2 * vocab_split,
            "loss": rows_split}

    step.update({r: 0 for r in SSM_ROLES + XLSTM_ROLES + SEQ_ROLES})

    def add(layer_ops, reps):
        # training builds no cache: GQA gathers no KV heads; the cross
        # K/V's param gathers run once a forward, outside the block
        fwd = dict(layer_ops["fwd"])
        fwd.pop("kv_gather"), fwd.pop("x_kv_gather", 0)
        x_fsdp = fwd.pop("x_fsdp_gather", 0)
        for r, n in fwd.items():
            step[r] += reps * n
        for r, n in layer_ops["bwd"].items():
            step[r] += n
        step["fsdp_gather"] += x_fsdp
        step["fsdp_scatter"] += fwd["fsdp_gather"] + x_fsdp
        step["tp_grad"] += layer_ops["grad"]

    for bt, layer in _layers(model, ax):
        add(_layer_ops(rules, cfg, bt, layer), 2 if remat else 1)
    for bt, layer in _enc_layers(model, ax):
        add(_layer_ops(rules, cfg, bt, layer, encoder=True),
            2 if remat else 1)
    if cfg.mtp_depth:
        mtp = ax["mtp"]
        add(_layer_ops(rules, cfg, cfg.layer_types[-1], mtp["block"]), 1)
        proj = on_tp(mtp["proj"][1])
        gathers = table_gather + fsdp(tree_flatten({k: v for k, v in
                                                    mtp.items()
                                                    if k != "block"})[0])
        step["fsdp_gather"] += gathers
        step["fsdp_scatter"] += gathers
        step["tp_grad"] += proj + vocab_split
        step["mtp_gather"] = int(proj)
        step["vocab"] += on_tp(ax["embed"][0]) + 2 * vocab_split
        step["loss"] += rows_split
    step["grad_sync"] = len({a for a in tree_flatten(grad_sync_axes(
        rules.spec, rules.mesh, ax))[0] if a})
    step["norms"] = int(bool(norm_axes(rules.spec, rules.mesh)))
    out = {r: K * n for r, n in step.items()}
    clients = int(bool(client_axes_on(rules.spec, rules.mesh)))
    out.update(fedavg=clients, metrics=clients)
    return {r: n for r, n in out.items() if n}


def flat_train_collectives(model: Model, rules: LogicalRules, slab, *,
                           local_steps: int, clients: int,
                           robust: Optional[str] = None,
                           deciles: bool = False,
                           skipped: bool = False) -> Dict[str, int]:
    """The collectives one sharded flat round of ``local_steps`` Δ-SGD
    steps makes on a rank under training ``rules``, by role, for a
    cohort of ``clients`` and the rank's ``slab`` (``core.sharded
    .TPSlab``). A local step evaluates ``slab.chunk(C_loc)`` clients at
    a time: for each chunk a ``flat_gather`` a group of split leaves
    and the model's own forward and backward collectives with its
    ``grad_sync`` (``train_collectives`` at one step, without the vmap
    round's own sums), then one ``norms`` sum. The tail: one
    ``flat_reshard``; the ``robust`` ladder's sums (``robust``: one over
    the client axes, and for clip one over the N-shard axes); the packed
    ``flat_sum`` and the η extrema's ``flat_min`` over the client axes
    (with ``deciles`` the losses' ``metrics`` gather); the aggregate's
    ``flat_params`` gather (none when a quorum skip keeps the params).
    Axes of size 1 make none."""
    fed, mesh = slab.federation, slab.mesh
    ca = client_axes_on(fed, mesh)
    shards = fed.flat_shards(mesh)
    C_loc = clients // max(1, rules.size(ca)) if ca else clients
    chunks = -(-C_loc // slab.chunk(C_loc))
    model_ops = train_collectives(model, rules, local_steps=1)
    for r in ("norms", "fedavg", "metrics"):
        model_ops.pop(r, None)
    out: Dict[str, int] = {}

    def add(role, n):
        if n:
            out[role] = out.get(role, 0) + n
    K = local_steps
    if shards > 1:
        add("flat_gather", K * chunks * len(slab.groups))
        for r, n in model_ops.items():
            add(r, K * chunks * n)
        add("norms", K)
        add("flat_reshard", 1)
        add("flat_params", int(not skipped))
    if robust is not None:
        add("robust", int(bool(ca)) + int(robust == "clip" and shards > 1))
    if ca:
        add("flat_sum", 1)
        add("flat_min", 1)
        add("metrics", int(deciles))
    return out
