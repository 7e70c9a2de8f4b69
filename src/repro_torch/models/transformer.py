"""Layer-stack machinery: block dispatch, segment runs, the shared block.
Port of ``repro/models/transformer.py`` for the block types of the
ported archs: ``attn``, ``moe``, ``mamba2`` and ``shared_attn``.
The attention of ``attn``, ``moe`` and ``shared_attn`` blocks is GQA, or
MLA where the config says so (``cfg.use_mla``); a ``moe`` block has the
MoE layer (``models.moe``) in place of the dense MLP.

Layers are grouped into runs of consecutive identical block types
(``cfg.layer_types``), and the parameter tree is the reference's: a run
of n > 1 blocks has every leaf stacked on a leading layer axis, a run of
one has no such axis, and ``shared_attn`` (Zamba2) holds one global set
of params at the top that every occurrence applies, each site with its
own cache. Caches of every run carry the leading layer axis. The
reference scans a run with ``lax.scan``; here a Python loop applies its
layers in order.

``stack_full``'s ``use_pallas`` picks the attention and SSD route of
every block (``attention.gqa_full``, ``ssm.mamba2_full``).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.common import (apply_norm, dense_init, init_norm,
                                       swiglu, zeros_init)
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

# block types with attention (and its KV cache)
ATTN_TYPES = ("attn", "shared_attn", "moe")
# block types of the reference that wait for their ROADMAP item
_NOT_PORTED = {"mlstm": "A15 (LM zoo: xLSTM)", "slstm": "A15 (LM zoo: xLSTM)"}


def check_ported(btype: str) -> None:
    """Raise for a block type this package cannot build or apply."""
    if btype in _NOT_PORTED:
        raise NotImplementedError(
            f"block type {btype!r} is not ported to repro_torch yet: it "
            f"comes with ROADMAP {_NOT_PORTED[btype]}")
    if btype not in ATTN_TYPES + ("mamba2",):
        raise ValueError(f"unknown block type {btype!r}")


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
    if "w_gate" in params:
        h = swiglu(x @ params["w_gate"], x @ params["w_in"])
        return h @ params["w_out"]
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu((x @ params["w_in"] + params["b_in"]).float(),
               approximate="tanh").to(x.dtype)
    return h @ params["w_out"] + params["b_out"]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def init_block(gen: torch.Generator, cfg, btype: str,
               dtype: torch.dtype) -> dict:
    check_ported(btype)
    if btype in ATTN_TYPES:
        attn_init = attn.init_mla if cfg.use_mla else attn.init_attention
        p = {"ln1": init_norm(gen, cfg, dtype),
             "attn": attn_init(gen, cfg, dtype),
             "ln2": init_norm(gen, cfg, dtype)}
        if btype == "moe":
            p["moe"] = moe.init_moe(gen, cfg, dtype)
        else:
            p["mlp"] = init_mlp(gen, cfg, dtype)
        return p
    return {"ln": init_norm(gen, cfg, dtype),
            "mixer": ssm.init_mamba2(gen, cfg, dtype)}


def _ffn(params: dict, h: torch.Tensor, cfg, btype: str):
    """The block's MLP or MoE layer -> (out, aux)."""
    if btype == "moe":
        return moe.apply_moe(params["moe"], h, cfg)
    return apply_mlp(params["mlp"], h, cfg), None


def block_full(params: dict, x: torch.Tensor, cfg, btype: str, *,
               positions: torch.Tensor, window=None,
               build_cache: bool = False, use_pallas: bool = True):
    """Returns (x, cache | None, aux): aux is the MoE layer's auxiliary
    loss, None for a block without one. MLA ignores ``use_pallas``, as
    the reference's does: its qk head dim passes the kernel's."""
    if btype in ATTN_TYPES:
        h = apply_norm(params["ln1"], x, cfg)
        full = attn.mla_full if cfg.use_mla else attn.gqa_full
        a, cache = full(params["attn"], h, cfg, positions=positions,
                        window=window, build_cache=build_cache,
                        use_pallas=use_pallas)
        x = x + a
        m, aux = _ffn(params, apply_norm(params["ln2"], x, cfg), cfg, btype)
        return x + m, cache, aux
    h = apply_norm(params["ln"], x, cfg)
    m, cache = ssm.mamba2_full(params["mixer"], h, cfg,
                               build_cache=build_cache, use_pallas=use_pallas)
    return x + m, cache, None


def block_step(params: dict, x: torch.Tensor, cfg, btype: str, cache: dict,
               *, t, slot, positions_buf, window=None):
    """One decode step of one block. Returns (x, cache)."""
    if btype in ATTN_TYPES:
        h = apply_norm(params["ln1"], x, cfg)
        step = attn.mla_step if cfg.use_mla else attn.gqa_step
        a, cache = step(params["attn"], h, cfg, cache, t=t, slot=slot,
                        positions_buf=positions_buf, window=window)
        x = x + a
        m, _ = _ffn(params, apply_norm(params["ln2"], x, cfg), cfg, btype)
        return x + m, cache
    h = apply_norm(params["ln"], x, cfg)
    m, cache = ssm.mamba2_step(params["mixer"], h, cfg, cache)
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


def init_stack(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    params = {}
    for i, (btype, n) in enumerate(segment_runs(cfg.layer_types)):
        if btype == "shared_attn":
            if "shared_attn" not in params:
                params["shared_attn"] = init_block(gen, cfg, btype, dtype)
            continue
        blocks = [init_block(gen, cfg, btype, dtype) for _ in range(n)]
        params[f"run{i}"] = blocks[0] if n == 1 else _stack(blocks)
    return params


def stack_full(params: dict, x: torch.Tensor, cfg, *,
               positions: torch.Tensor, window=None,
               build_cache: bool = False, use_pallas: bool = True):
    """Returns (x, {run: cache stacked on the layer axis} | None, aux);
    ``aux`` is the MoE blocks' auxiliary losses summed in f32 in layer
    order, 0 without MoE blocks."""
    caches = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (btype, n) in enumerate(segment_runs(cfg.layer_types)):
        cs = []
        for p in _run_params(params, i, btype, n):
            x, c, a = block_full(p, x, cfg, btype, positions=positions,
                                 window=window, build_cache=build_cache,
                                 use_pallas=use_pallas)
            cs.append(c)
            if a is not None:
                aux = aux + a
        if build_cache:
            caches[f"run{i}"] = _stack(cs)
    return x, (caches if build_cache else None), aux


def stack_step(params: dict, x: torch.Tensor, cfg, caches: dict, *, t, slot,
               positions_buf, window=None):
    """One decode step through every layer. Returns (x, new caches)."""
    new_caches = {}
    for i, (btype, n) in enumerate(segment_runs(cfg.layer_types)):
        key = f"run{i}"
        cs = []
        for j, p in enumerate(_run_params(params, i, btype, n)):
            x, c = block_step(p, x, cfg, btype, _layer(caches[key], j), t=t,
                              slot=slot, positions_buf=positions_buf,
                              window=window)
            cs.append(c)
        new_caches[key] = _stack(cs)
    return x, new_caches
