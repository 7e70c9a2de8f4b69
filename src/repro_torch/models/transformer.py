"""Layer-stack machinery: block dispatch, segment runs, the shared block.
Port of ``repro/models/transformer.py`` for the block types of the
ported archs: ``attn``, ``mamba2`` and ``shared_attn``.

Layers are grouped into runs of consecutive identical block types
(``cfg.layer_types``), and the parameter tree is the reference's: a run
of n > 1 blocks has every leaf stacked on a leading layer axis, a run of
one has no such axis, and ``shared_attn`` (Zamba2) holds one global set
of params at the top that every occurrence applies, each site with its
own cache. Caches of every run carry the leading layer axis. The
reference scans a run with ``lax.scan``; here a Python loop applies its
layers in order.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.common import (apply_norm, dense_init, init_norm,
                                       swiglu, zeros_init)
from repro_torch.utils.tree import tree_map

ATTN_TYPES = ("attn", "shared_attn")
# block types of the reference that wait for their ROADMAP item
_NOT_PORTED = {"moe": "A15 (LM zoo: MoE)", "mlstm": "A15 (LM zoo: xLSTM)",
               "slstm": "A15 (LM zoo: xLSTM)"}


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
        return {"ln1": init_norm(gen, cfg, dtype),
                "attn": attn.init_attention(gen, cfg, dtype),
                "ln2": init_norm(gen, cfg, dtype),
                "mlp": init_mlp(gen, cfg, dtype)}
    return {"ln": init_norm(gen, cfg, dtype),
            "mixer": ssm.init_mamba2(gen, cfg, dtype)}


def block_full(params: dict, x: torch.Tensor, cfg, btype: str, *,
               positions: torch.Tensor, window=None,
               build_cache: bool = False):
    """Returns (x, cache | None)."""
    if btype in ATTN_TYPES:
        h = apply_norm(params["ln1"], x, cfg)
        a, cache = attn.gqa_full(params["attn"], h, cfg, positions=positions,
                                 window=window, build_cache=build_cache)
        x = x + a
        h = apply_norm(params["ln2"], x, cfg)
        return x + apply_mlp(params["mlp"], h, cfg), cache
    h = apply_norm(params["ln"], x, cfg)
    m, cache = ssm.mamba2_full(params["mixer"], h, cfg,
                               build_cache=build_cache)
    return x + m, cache


def block_step(params: dict, x: torch.Tensor, cfg, btype: str, cache: dict,
               *, t, slot, positions_buf, window=None):
    """One decode step of one block. Returns (x, cache)."""
    if btype in ATTN_TYPES:
        h = apply_norm(params["ln1"], x, cfg)
        a, cache = attn.gqa_step(params["attn"], h, cfg, cache, t=t,
                                 slot=slot, positions_buf=positions_buf,
                                 window=window)
        x = x + a
        h = apply_norm(params["ln2"], x, cfg)
        return x + apply_mlp(params["mlp"], h, cfg), cache
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
    """The params of each layer of run i, in order."""
    if btype == "shared_attn":
        return [params["shared_attn"]] * n
    p = params[f"run{i}"]
    return [p] if n == 1 else [_layer(p, j) for j in range(n)]


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
               build_cache: bool = False):
    """Returns (x, {run: cache stacked on the layer axis} | None, aux);
    ``aux`` is the auxiliary loss, 0 without MoE blocks."""
    caches = {}
    for i, (btype, n) in enumerate(segment_runs(cfg.layer_types)):
        cs = []
        for p in _run_params(params, i, btype, n):
            x, c = block_full(p, x, cfg, btype, positions=positions,
                              window=window, build_cache=build_cache)
            cs.append(c)
        if build_cache:
            caches[f"run{i}"] = _stack(cs)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
