"""Step builders for the serving path: the prefill of one batch and one
greedy decode step. Port of ``make_prefill_step`` and
``make_serve_step`` from ``repro/launch/steps.py``. PyTorch runs
eagerly, so a step is a plain function (the reference jits them).
``launch.train.train_lm`` builds its rounds itself, as the reference's
does; the reference's training builders (and ``abstract_fl_state``)
come with tensor-parallel training (ROADMAP A17).

Tensor-parallel serving: ``serve_rules`` makes the serve
``LogicalRules`` of a model on a mesh (the reference's
``LogicalRules(spec, mesh, serve=True)`` with the params' placement),
``place_for_rank`` cuts whole params, a batch and a cache to one rank's
blocks by the reference's rules, and a builder given ``rules`` runs its
step under them on those local trees. ``serve_collectives`` is what one
such step issues on a rank, by role.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from repro_torch.models.common import logical_rules
from repro_torch.models.model import (Model, local_vocab, moves_rows,
                                      tp_supported)
from repro_torch.sharding.spec import (FederationSpec, LogicalRules,
                                       cache_shardings, entry_axes,
                                       get_federation_spec, local_block,
                                       param_placements,
                                       serve_batch_shardings)
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
                seq_shard: bool = False) -> LogicalRules:
    """The serve rules of ``model`` on ``mesh`` for the rank at
    ``coords`` (the mesh's own by default). ``params`` is the whole
    params tree or its fake-tensor struct (``launch.specs.params_struct``):
    only shapes are read. ``spec`` defaults to the config's federation
    (``launch.specs.federation_kind``). Refuses a config that
    tensor-parallel serving does not run."""
    from repro_torch.launch.specs import federation_kind
    if not tp_supported(model.cfg):
        raise ValueError(f"{model.cfg.name}: tensor-parallel serving runs "
                         "the dense GQA decoders only; MoE, MLA, Mamba2, "
                         "xLSTM, Whisper and InternVL2 are ROADMAP A17")
    spec = spec or get_federation_spec(federation_kind(model.cfg), mesh)
    return LogicalRules(spec, mesh, serve=True, seq_shard=seq_shard,
                        coords=coords,
                        param_axes=param_placements(spec, mesh, params))


def _cut(tree, axes, rules, device):
    return tree_map(lambda x, a: local_block(x, a, rules.mesh, rules.coords
                                             ).contiguous().to(device),
                    tree, axes)


def place_for_rank(rules: LogicalRules, *, params=None, batch=None,
                   cache=None, batch_size: Optional[int] = None,
                   device=None) -> Dict:
    """One rank's blocks of whole ``params``, ``batch`` and ``cache``
    by the reference's rules (``param_placements``,
    ``serve_batch_shardings``, ``cache_shardings`` with ``batch_size``,
    the global batch), each copied to ``device`` (its own by default).
    Returns {"params", "batch", "cache"}: those given."""
    out = {}
    if params is not None:
        out["params"] = _cut(params, rules.param_axes, rules, device)
    if batch is not None:
        out["batch"] = _cut(batch, serve_batch_shardings(rules.mesh, batch),
                            rules, device)
    if cache is not None:
        if batch_size is None:
            raise ValueError("a cache is placed by its global batch_size")
        out["cache"] = _cut(cache, cache_shardings(
            rules.spec, rules.mesh, cache, batch_size=batch_size,
            seq_shard=rules.seq_shard), rules, device)
    return out


def _live(rules: LogicalRules, entry) -> tuple:
    """The axes of ``entry`` of size > 1."""
    return tuple(a for a in entry_axes(entry) if rules.size(a) > 1)


def serve_collectives(model: Model, rules: LogicalRules, rows: int,
                      seq: int) -> Dict[str, int]:
    """The collectives one tensor-parallel step issues on a rank whose
    batch has ``rows`` rows of ``seq`` tokens (prefill: the prompt; a
    decode step: 1), by role: per layer a ``tp_reduce`` after attention
    and after the MLP where their heads or hidden units are split, a
    ``kv_gather`` where the KV heads are (the cache holds them all), an
    ``fsdp_gather`` for every fsdp dim of the layer's params; a
    ``vocab`` all-reduce of the embedding and a ``vocab`` gather of the
    logits where the vocab is split; for each vocab table whose model
    dim is fsdp-sharded, its ``fsdp_gather`` or, where moving the fsdp
    group's rows costs less (``models.model.moves_rows``), two
    ``fsdp_rows`` ops. Axes of size 1 make none."""
    cfg, ax = model.cfg, rules.param_axes
    tp = rules.tp if rules.size(rules.tp) > 1 else None
    on_tp = lambda entry: tp is not None and tp in entry_axes(entry)
    # run0's entries lead with the layer axis where the run is stacked
    at = (lambda e: e[1:]) if cfg.num_layers > 1 else (lambda e: e)
    layer = tree_map(at, ax["stack"]["run0"])

    def fsdp_axes(entry):
        return tuple(a for a in _live(rules, entry) if a != rules.tp)

    def fsdp(entries):
        return sum(bool(fsdp_axes(e)) for e in entries)

    L = cfg.num_layers
    n = {"tp_reduce": L * (on_tp(layer["attn"]["wq"][1])
                           + on_tp(layer["mlp"]["w_out"][0])),
         "kv_gather": L * on_tp(layer["attn"]["wk"][1]),
         "fsdp_gather": L * sum(fsdp(e) for e in tree_flatten(layer)[0]),
         "fsdp_rows": 0}
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
