"""Stand-ins for every program of the dry run: fake tensors of the
reference's shapes and dtypes, no allocation. Port of
``repro/launch/specs.py``.

Step kinds per input shape:
  train_4k    -> fl_round(state, client_batches)
  prefill_32k -> prefill_step(params, batch)
  decode_32k  -> serve_step(params, cache, tokens)     cache_len = 32768
  long_500k   -> serve_step(params, cache, tokens)     sub-quadratic path

Where the reference's ``jax.eval_shape`` traces an init without running
it, the port runs it under a ``FakeTensorMode`` (the inits draw nothing
on fake tensors, ``models.common``). A struct is made in the mode it is
given, or in a fresh one; every op that reads it must run in the same
mode.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import FLConfig, ModelConfig, ShapeConfig
from repro_torch.models.common import tree_size
from repro_torch.models.model import Model, build_model

# Architectures above this size train as 2 cross-silo clients (FSDP within
# silo); smaller ones as one client per (pod, data) coordinate.
CROSS_SILO_THRESHOLD = 10e9


def _fake(mode: Optional[FakeTensorMode]) -> FakeTensorMode:
    return mode if mode is not None else FakeTensorMode()


def params_struct(model: Model, mode: Optional[FakeTensorMode] = None):
    """The params tree of ``model`` as fake tensors (on the CPU)."""
    with _fake(mode):
        return model.init(torch.Generator())


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """The exact param count of ``cfg`` (an init on fake tensors); with
    ``active_only``, routed experts count only the chosen ones (the
    reference's ``count_params_analytic``)."""
    total = tree_size(params_struct(build_model(cfg, torch.bfloat16)))
    if active_only and cfg.num_experts:
        E, K = cfg.num_experts, cfg.num_experts_per_tok
        per_expert = 3 * cfg.d_model * cfg.expert_d_ff
        n_moe = sum(1 for t in cfg.layer_types if t == "moe")
        total -= n_moe * (E - K) * per_expert
    return int(total)


def federation_kind(cfg: ModelConfig) -> str:
    return ("cross_silo" if param_count(cfg) > CROSS_SILO_THRESHOLD
            else "cross_device")


def _frontend_extras(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict:
    out = {}
    if cfg.encoder_layers:
        out["frames"] = torch.empty(lead + (cfg.encoder_seq, cfg.d_model),
                                    dtype=torch.bfloat16)
    if cfg.num_image_tokens:
        out["image_embeds"] = torch.empty(
            lead + (cfg.num_image_tokens, cfg.d_model), dtype=torch.bfloat16)
    return out


def train_specs(model: Model, shape: ShapeConfig, fl: FLConfig,
                clients: int, mode: Optional[FakeTensorMode] = None
                ) -> Dict[str, Any]:
    """FL-round batch struct: leaves (C, K, b, ...)."""
    C, K = clients, fl.local_steps
    b = max(1, shape.global_batch // C)
    lead = (C, K, b)
    with _fake(mode):
        batch = {"tokens": torch.empty(lead + (shape.seq_len,),
                                       dtype=torch.int32),
                 "labels": torch.empty(lead + (shape.seq_len,),
                                       dtype=torch.int32)}
        batch.update(_frontend_extras(model.cfg, lead))
    return batch


def prefill_specs(model: Model, shape: ShapeConfig,
                  mode: Optional[FakeTensorMode] = None) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    with _fake(mode):
        batch = {"tokens": torch.empty((B, S), dtype=torch.int32)}
        batch.update(_frontend_extras(model.cfg, (B,)))
    return batch


def decode_specs(model: Model, shape: ShapeConfig, window: Optional[int],
                 quant_kv: bool = False,
                 mode: Optional[FakeTensorMode] = None) -> Tuple[Any, Any]:
    """(cache struct, tokens struct) of the whole batch."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    cache_len = model.cache_len_for(S, window)
    with _fake(mode):
        cache = model.init_cache(B, cache_len, device="cpu",
                                 quant_kv=quant_kv)
        if cfg.encoder_layers:
            kv = (cfg.num_layers, B, cfg.encoder_seq, cfg.num_kv_heads,
                  cfg.head_dim)
            cache["enc_kv"] = {"xk": torch.empty(kv, dtype=model.dtype),
                               "xv": torch.empty(kv, dtype=model.dtype)}
        tokens = torch.empty((B, 1), dtype=torch.int32)
    return cache, tokens


def decode_window(cfg: ModelConfig, shape: ShapeConfig) -> Optional[int]:
    """Sliding window policy: only the long-context shape uses it, and only
    when the config defines one."""
    if shape.name == "long_500k" and cfg.sliding_window:
        return cfg.sliding_window
    return None
