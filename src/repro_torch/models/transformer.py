"""Layer-stack machinery: block dispatch, segment runs, the shared block.
Port of ``repro/models/transformer.py``: block types ``attn``, ``moe``,
``shared_attn``, ``mamba2``, ``mlstm`` and ``slstm``. The attention of
``attn``, ``moe`` and ``shared_attn`` blocks is GQA, or MLA where the
config says so (``cfg.use_mla``); a ``moe`` block has the MoE layer
(``models.moe``) in place of the dense MLP. A decoder block of an
encoder-decoder config (``decoder=True`` with ``cfg.cross_attention``,
Whisper) adds cross-attention (``ln_x``, ``xattn``) after its
self-attention, reading the encoder's per-layer K/V (``enc_kv``); the
encoder's blocks attend without a causal mask (``causal=False``,
``_bidir_attn``).

Layers are grouped into runs of consecutive identical block types
(``cfg.layer_types``, or the ``layer_types`` a caller passes, as the
encoder does), and the parameter tree is the reference's: a run of
n > 1 blocks has every leaf stacked on a leading layer axis, a run of
one has no such axis, and ``shared_attn`` (Zamba2) holds one global set
of params at the top that every occurrence applies, each site with its
own cache. Caches of every run, and ``enc_kv``, carry the leading layer
axis. The reference scans a run with ``lax.scan``; here a Python loop
applies its layers in order.

``stack_full``'s ``use_pallas`` picks the attention and SSD route of
every block (``attention.gqa_full``, ``ssm.mamba2_full``).

Under installed logical rules (``models.common``) the dense MLP is
Megatron's: its input enters through ``tp_enter`` (under training
rules), ``w_gate``/``w_in`` (and ``b_in``) column-parallel, ``w_out``
row-parallel, followed by one ``tp_reduce``; ``b_out`` is added once,
after the sum. An MoE block's layer runs its own TP branch
(``moe.apply_moe``: the rank's experts, the global capacity order), a
Mamba2 block its mixer's (``ssm.mamba2_full``/``mamba2_step``: the
rank's heads), and the encoder's non-causal attention the rank's heads
(``_bidir_attn``).
Where the rules' spec shards params over an fsdp axis, each layer's
params (an MoE block's experts, router and shared expert among them)
are gathered whole over it at use (``fsdp_gather``; the shared block's
at each of its sites) and dropped after the layer; a remat'd block
reruns its gathers and collectives, MoE, MLA and Mamba2 ones included,
in the backward pass.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.common import (apply_norm, dense_init,
                                       fsdp_gather_tree, get_logical_rules,
                                       init_norm, remat_call, remat_on,
                                       shard_logical, swiglu, tp_enter,
                                       tp_reduce, zeros_init)
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

# block types with attention (and its KV cache)
ATTN_TYPES = ("attn", "shared_attn", "moe")
# recurrent block types: (init, full, step, init_cache) of their mixer
RECURRENT = {
    "mamba2": (ssm.init_mamba2, ssm.mamba2_full, ssm.mamba2_step,
               ssm.init_mamba2_cache),
    "mlstm": (ssm.init_mlstm, ssm.mlstm_full, ssm.mlstm_step,
              ssm.init_mlstm_cache),
    "slstm": (ssm.init_slstm, ssm.slstm_full, ssm.slstm_step,
              ssm.init_slstm_cache),
}


def segment_runs(layer_types: Tuple[str, ...]) -> List[Tuple[str, int]]:
    runs: List[Tuple[str, int]] = []
    for t in layer_types:
        if runs and runs[-1][0] == t:
            runs[-1] = (t, runs[-1][1] + 1)
        else:
            runs.append((t, 1))
    return runs


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    if cfg.mlp_variant == "swiglu":
        return {"w_gate": dense_init(gen, (D, F_), dtype, fan_in=D),
                "w_in": dense_init(gen, (D, F_), dtype, fan_in=D),
                "w_out": dense_init(gen, (F_, D), dtype, fan_in=F_)}
    return {"w_in": dense_init(gen, (D, F_), dtype, fan_in=D),
            "b_in": zeros_init(gen, (F_,), dtype),
            "w_out": dense_init(gen, (F_, D), dtype, fan_in=F_),
            "b_out": zeros_init(gen, (D,), dtype)}


def apply_mlp(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Under rules, the rank's block of the hidden units: ``x`` enters
    through ``tp_enter`` and the partial sums of ``w_out`` are reduced
    over the tensor axis before ``b_out``."""
    F_ = params["w_out"].shape[0]
    if F_ < cfg.d_ff:
        x = tp_enter(x)
    if "w_gate" in params:
        h = swiglu(x @ params["w_gate"], x @ params["w_in"])
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu((x @ params["w_in"] + params["b_in"]).float(),
                   approximate="tanh").to(x.dtype)
    shard_logical(h, ("batch", "seq", "ffn"), (None, None, cfg.d_ff))
    y = h @ params["w_out"]
    if F_ < cfg.d_ff:
        y = tp_reduce(y)
    return y if "b_out" not in params else y + params["b_out"]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def init_block(gen: torch.Generator, cfg, btype: str, dtype: torch.dtype,
               *, decoder: bool = False) -> dict:
    if btype in ATTN_TYPES:
        attn_init = attn.init_mla if cfg.use_mla else attn.init_attention
        p = {"ln1": init_norm(gen, cfg, dtype),
             "attn": attn_init(gen, cfg, dtype),
             "ln2": init_norm(gen, cfg, dtype)}
        if btype == "moe":
            p["moe"] = moe.init_moe(gen, cfg, dtype)
        else:
            p["mlp"] = init_mlp(gen, cfg, dtype)
        if decoder and cfg.cross_attention:
            p["ln_x"] = init_norm(gen, cfg, dtype)
            p["xattn"] = attn.init_cross_attention(gen, cfg, dtype)
        return p
    if btype not in RECURRENT:
        raise ValueError(f"unknown block type {btype!r}")
    return {"ln": init_norm(gen, cfg, dtype),
            "mixer": RECURRENT[btype][0](gen, cfg, dtype)}


def _ffn(params: dict, h: torch.Tensor, cfg, btype: str):
    """The block's MLP or MoE layer -> (out, aux)."""
    if btype == "moe":
        return moe.apply_moe(params["moe"], h, cfg)
    return apply_mlp(params["mlp"], h, cfg), None


def _cross(params: dict, x: torch.Tensor, cfg, enc_kv) -> torch.Tensor:
    """The residual stream after cross-attention to ``enc_kv``, if any."""
    if enc_kv is None:
        return x
    h = apply_norm(params["ln_x"], x, cfg)
    return x + attn.cross_attend(params["xattn"], h, cfg, enc_kv)


def block_full(params: dict, x: torch.Tensor, cfg, btype: str, *,
               positions: torch.Tensor, window=None,
               build_cache: bool = False, enc_kv=None, causal: bool = True,
               use_pallas: bool = True):
    """Returns (x, cache | None, aux): aux is the MoE layer's auxiliary
    loss, None for a block without one. MLA ignores ``use_pallas``, as
    the reference's does: its qk head dim passes the kernel's. With
    ``causal=False`` (the Whisper encoder) GQA attention is
    ``_bidir_attn`` on the plain route and builds no cache."""
    if btype in ATTN_TYPES:
        h = apply_norm(params["ln1"], x, cfg)
        if causal:
            full = attn.mla_full if cfg.use_mla else attn.gqa_full
            a, cache = full(params["attn"], h, cfg, positions=positions,
                            window=window, build_cache=build_cache,
                            use_pallas=use_pallas)
        else:
            a, cache = _bidir_attn(params["attn"], h, cfg, positions)
        x = _cross(params, x + a, cfg, enc_kv)
        m, aux = _ffn(params, apply_norm(params["ln2"], x, cfg), cfg, btype)
        return x + m, cache, aux
    h = apply_norm(params["ln"], x, cfg)
    full = RECURRENT[btype][1]
    kw = {"use_pallas": use_pallas} if btype == "mamba2" else {}
    m, cache = full(params["mixer"], h, cfg, build_cache=build_cache, **kw)
    return x + m, cache, None


def _bidir_attn(params: dict, x: torch.Tensor, cfg,
                positions: torch.Tensor):
    """Non-causal attention (the Whisper encoder), on the plain
    ``_sdpa``: the flash kernel keeps its refusal of non-causal
    attention. Under rules, the rank's heads (``attention.heads_of``),
    ``x`` entering them through ``tp_enter``, ``wo``'s partial sums
    reduced. Returns (out, None)."""
    heads = attn.heads_of(params, cfg)
    if heads.partial:
        x = tp_enter(x)
    q, k, v = attn._qkv(params, x, cfg, positions, heads)
    B, S, h, hd = q.shape
    out = attn._sdpa(q.reshape(B, S, heads.a, h // heads.a, hd),
                     attn._attended(k, heads), attn._attended(v, heads),
                     causal=False).reshape(B, S, h, hd)
    return attn._out_proj(out, params, heads), None


def block_step(params: dict, x: torch.Tensor, cfg, btype: str, cache: dict,
               *, t, slot, positions_buf, window=None, enc_kv=None):
    """One decode step of one block. Returns (x, cache)."""
    if btype in ATTN_TYPES:
        h = apply_norm(params["ln1"], x, cfg)
        step = attn.mla_step if cfg.use_mla else attn.gqa_step
        a, cache = step(params["attn"], h, cfg, cache, t=t, slot=slot,
                        positions_buf=positions_buf, window=window)
        x = _cross(params, x + a, cfg, enc_kv)
        m, _ = _ffn(params, apply_norm(params["ln2"], x, cfg), cfg, btype)
        return x + m, cache
    h = apply_norm(params["ln"], x, cfg)
    m, cache = RECURRENT[btype][2](params["mixer"], h, cfg, cache)
    return x + m, cache


# ---------------------------------------------------------------------------
# Stack: init / full / step over segment runs
# ---------------------------------------------------------------------------
def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _layer(tree, j: int):
    return tree_map(lambda a: a[j], tree)


def _run_params(params: dict, i: int, btype: str, n: int):
    """The params of each layer of run i, in order: views of the stacked
    leaves, taken with one ``unbind`` a leaf (whose backward stacks the
    layers' gradients once)."""
    if btype == "shared_attn":
        return [params["shared_attn"]] * n
    p = params[f"run{i}"]
    if n == 1:
        return [p]
    leaves, treedef = tree_flatten(p)
    layers = list(zip(*(a.unbind(0) for a in leaves)))
    return [tree_unflatten(treedef, list(ls)) for ls in layers]


def layer_axes(axes: dict, i: int, btype: str, n: int) -> dict:
    """The placement entries of one layer of run i of a stack whose
    placement tree is ``axes``: the shared block's (one set, never
    stacked), or the run's without its stacked layer axis."""
    if btype == "shared_attn":
        return axes["shared_attn"]
    axes = axes[f"run{i}"]
    return tree_map(lambda a: a[1:], axes) if n > 1 else axes


def stack_axes(where: Tuple[str, ...] = ("stack",)) -> dict:
    """The installed rules' placement tree of the stack at ``where`` in
    the params (the decoder's ``("stack",)``, the encoder's
    ``("encoder", "stack")``)."""
    axes = get_logical_rules().param_axes
    for k in where:
        axes = axes[k]
    return axes


def _at_use(p: dict, i: int, n: int, btype: str,
            where: Tuple[str, ...] = ("stack",)) -> dict:
    """Layer params ``p`` of run i of the stack at ``where`` with their
    fsdp dims gathered whole (the installed rules' ``param_axes``); ``p``
    itself without rules or without an fsdp axis. The shared block's
    params are gathered at each of its sites; a decoder block's
    cross-attention K/V projections are not (``attention.CROSS_KV``:
    ``Model._cross_kv`` reads them once, before the stack)."""
    rules = get_logical_rules()
    if rules is None or not rules.fsdp_live:
        return p
    axes = layer_axes(stack_axes(where), i, btype, n)
    if "xattn" not in p:
        return fsdp_gather_tree(p, axes)
    kv = {k: v for k, v in p["xattn"].items() if k in attn.CROSS_KV}
    q = {k: v for k, v in p["xattn"].items() if k not in attn.CROSS_KV}
    out = fsdp_gather_tree({**p, "xattn": q},
                           {**axes, "xattn": {k: axes["xattn"][k]
                                              for k in q}})
    out["xattn"].update(kv)
    return out


def _slice_enc(enc_kv, j: int):
    """Layer j's cross K/V of ``enc_kv`` (stacked (layers, ...)), or
    None."""
    return None if enc_kv is None else _layer(enc_kv, j)


def init_stack(gen: torch.Generator, cfg, dtype: torch.dtype, *,
               layer_types=None, decoder: bool = False) -> dict:
    params = {}
    for i, (btype, n) in enumerate(segment_runs(layer_types
                                                or cfg.layer_types)):
        if btype == "shared_attn":
            if "shared_attn" not in params:
                params["shared_attn"] = init_block(gen, cfg, btype, dtype,
                                                   decoder=decoder)
            continue
        blocks = [init_block(gen, cfg, btype, dtype, decoder=decoder)
                  for _ in range(n)]
        params[f"run{i}"] = blocks[0] if n == 1 else _stack(blocks)
    return params


def _remat_block(p: dict, x: torch.Tensor, i: int, n: int, cfg, btype,
                 enc_kv=None, where=("stack",), **kw):
    """``block_full`` of layer params ``p`` (with their fsdp gather at
    use) through ``common.remat_call``: the backward recomputes the
    block, its gathers and collectives included. Every tensor the block
    differentiates (params, ``enc_kv``, ``x``) is an input of the
    rematerialised call. Returns (x, aux)."""
    leaves, treedef = tree_flatten(p)
    ekv, ekv_def = tree_flatten(enc_kv) if enc_kv is not None else ([], None)
    k = len(leaves)
    # a tensor the call closes over cannot cross functorch's generated
    # vmap rule: the positions (the full forward's arange(S)) are made
    # inside the call
    S = kw.pop("positions").shape[-1]

    def fn(*ts):
        lp = _at_use(tree_unflatten(treedef, list(ts[:k])), i, n, btype,
                     where)
        e = (tree_unflatten(ekv_def, list(ts[k:-1])) if ekv_def is not None
             else None)
        pos = torch.arange(S, device=ts[-1].device)[None]
        y, _, a = block_full(lp, ts[-1], cfg, btype, enc_kv=e,
                             positions=pos, **kw)
        return y if a is None else (y, a)

    out = remat_call(fn, *leaves, *ekv, x)
    return out if isinstance(out, tuple) else (out, None)


def stack_full(params: dict, x: torch.Tensor, cfg, *, layer_types=None,
               positions: torch.Tensor, window=None,
               build_cache: bool = False, enc_kv=None, causal: bool = True,
               use_pallas: bool = True, where=("stack",)):
    """Returns (x, {run: cache stacked on the layer axis} | None, aux);
    ``aux`` is the MoE blocks' auxiliary losses summed in f32 in layer
    order, 0 without MoE blocks. ``enc_kv`` (cross K/V stacked on the
    layer axis) goes to a uniform decoder stack's layers in order, as
    the reference's scan hands it out. With ``common.remat_on()`` (and
    no cache to build) each block is rematerialised, as the reference's
    ``jax.checkpoint`` of its block: only the residual stream between
    blocks is kept for the backward pass. ``where`` is the stack's place
    in the params tree (``stack_axes``), read under rules with an fsdp
    axis."""
    caches = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat_on() and not build_cache
    for i, (btype, n) in enumerate(segment_runs(layer_types
                                                or cfg.layer_types)):
        cs = []
        for j, p in enumerate(_run_params(params, i, btype, n)):
            kw = dict(positions=positions, window=window,
                      enc_kv=_slice_enc(enc_kv, j), causal=causal,
                      use_pallas=use_pallas)
            if remat:
                x, a = _remat_block(p, x, i, n, cfg, btype, where=where,
                                    **kw)
                c = None
            else:
                x, c, a = block_full(_at_use(p, i, n, btype, where), x,
                                     cfg, btype,
                                     build_cache=build_cache, **kw)
            cs.append(c)
            if a is not None:
                aux = aux + a
        if build_cache:
            caches[f"run{i}"] = _stack(cs)
    return x, (caches if build_cache else None), aux


def stack_step(params: dict, x: torch.Tensor, cfg, caches: dict, *, t, slot,
               positions_buf, window=None, enc_kv=None):
    """One decode step through every layer. Returns (x, new caches)."""
    new_caches = {}
    for i, (btype, n) in enumerate(segment_runs(cfg.layer_types)):
        key = f"run{i}"
        cs = []
        for j, p in enumerate(_run_params(params, i, btype, n)):
            x, c = block_step(
                _at_use(p, i, n, btype), x, cfg, btype,
                _layer(caches[key], j),
                t=t, slot=slot, positions_buf=positions_buf, window=window,
                enc_kv=_slice_enc(enc_kv, j))
            cs.append(c)
        new_caches[key] = _stack(cs)
    return x, new_caches
