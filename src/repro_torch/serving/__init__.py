"""Federated serving plane: round-versioned continuous-batching decode.
Port of ``repro/serving``.

Pieces (see each module's docstring for the contract):

  * :class:`ModelRegistry` — watches a training checkpoint dir and
    stages new rounds for hot swap.
  * :class:`DecodeEngine` — fixed-slot KV pool, flush-interval decode
    blocks, block-boundary swap, personalized overlays.
  * :class:`PersonalizationStore` — per-client flat deltas (e.g. the
    fleet arena's EF21 slab) applied as a params overlay.
  * :class:`Workload` / :func:`run_load` — load generator + report.
"""
from repro_torch.serving.engine import (Completion, DecodeEngine, Request,
                                        greedy_decode)
from repro_torch.serving.loadgen import Workload, make_requests, run_load
from repro_torch.serving.personalize import PersonalizationStore
from repro_torch.serving.registry import ModelRegistry, StagedVersion

__all__ = ["Completion", "DecodeEngine", "Request", "greedy_decode",
           "ModelRegistry", "StagedVersion", "PersonalizationStore",
           "Workload", "make_requests", "run_load"]
