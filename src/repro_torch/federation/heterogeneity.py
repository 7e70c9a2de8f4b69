"""Compute heterogeneity: per-client local step counts K_c ≤ K_max.

Port of ``repro/federation/heterogeneity.py``. The scenario draws step
counts ``K_c ∈ [K_min, K_max]`` per client each round; the flat engine
lowers them as per-step lane masks: the (C, N) slab keeps its shape
through all K_max steps, and a client past its K_c steps rides along with
η forced to 0, at no extra kernel launch.

Speed models:
  fixed      — K_c = K_max for everyone (no masks at all).
  uniform    — K_c ~ U{K_min, …, K_max} iid per client per round.
  stragglers — a Bernoulli(straggler_frac) subset runs only K_min steps,
               the rest run K_max.

The reference draws from ``jax.random``; the port draws the same
distributions from a numpy generator the caller keys on
``(seed, round, 1)`` (``repro_torch.federation.scenarios``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

SPEED_MODELS = ("fixed", "uniform", "stragglers")


@dataclass(frozen=True)
class SpeedModel:
    kind: str = "fixed"
    k_min_frac: float = 0.25     # K_min = max(1, round(k_min_frac·K_max))
    straggler_frac: float = 0.3  # P(slow) under ``stragglers``

    def __post_init__(self):
        if self.kind not in SPEED_MODELS:
            raise KeyError(f"unknown speed model {self.kind!r}")

    @property
    def heterogeneous(self) -> bool:
        return self.kind != "fixed"

    def k_min(self, k_max: int) -> int:
        return max(1, min(k_max, int(round(self.k_min_frac * k_max))))

    def draw(self, rng: np.random.Generator, num_clients: int,
             k_max: int) -> np.ndarray:
        """(C,) int32 step counts in [K_min, K_max] (all K_max if fixed)."""
        if self.kind == "fixed":
            return np.full((num_clients,), k_max, np.int32)
        k_min = self.k_min(k_max)
        if self.kind == "uniform":
            return rng.integers(k_min, k_max + 1, size=num_clients
                                ).astype(np.int32)
        slow = rng.random(num_clients) < self.straggler_frac
        return np.where(slow, k_min, k_max).astype(np.int32)


def step_active(step_idx: int, step_counts: torch.Tensor) -> torch.Tensor:
    """(C,) bool: is each client still running at local step ``step_idx``?
    Step counts are prefix masks: client c runs steps 0..K_c−1, then stays
    frozen for the rest of the round."""
    return step_idx < step_counts


def active_mask(step_counts: torch.Tensor, k_max: int) -> torch.Tensor:
    """(C, K_max) f32 mask, 1.0 iff k < K_c: weights the per-step losses
    so metrics average only over steps that really ran."""
    k = torch.arange(k_max, dtype=torch.int32, device=step_counts.device)
    return (k[None, :] < step_counts[:, None]).to(torch.float32)
