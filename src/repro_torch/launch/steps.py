"""Step builders for the serving path: the prefill of one batch and one
greedy decode step. Port of ``make_prefill_step`` and
``make_serve_step`` from ``repro/launch/steps.py``. The training
builders there have no caller but the dry run, and come with it (ROADMAP
A17, second half): ``launch.train.train_lm`` builds its rounds itself, as the
reference's does. PyTorch runs eagerly, so a step is a plain function
(the reference jits them)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.model import Model


def make_prefill_step(model: Model, *, window: Optional[int] = None,
                      cache_len: Optional[int] = None):
    """fn(params, batch) -> (last-position logits, decode cache)."""
    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_len=cache_len,
                             window=window)

    return prefill_step


def make_serve_step(model: Model, *, window: Optional[int] = None):
    """fn(params, cache, tokens (B,1)) -> (greedy next tokens (B,1),
    cache)."""
    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens,
                                          window=window)
        return torch.argmax(logits, dim=-1), cache

    return serve_step
