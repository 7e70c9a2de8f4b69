"""Participation schedulers: who is in the cohort S_t.

Port of the uniform scheduler of ``repro/federation/schedulers.py``. The
reference draws a Gumbel-top-k over ``jax.random`` bits keyed on
``fold_in(key(seed), t)``; those bits cannot be reproduced here, so the
port draws the same distribution (C distinct clients, all equally
likely) from a numpy generator keyed on ``(seed, t)``. The draw is a
pure function of ``(seed, t)``: a resumed run re-draws the cohort an
uninterrupted run drew. Tests that need the reference's exact cohorts
hand ``FederatedDataset`` a scheduler that replays them.

The size-weighted, zipf and cyclic schedulers come with the scenario
item (ROADMAP A10).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def cohort_size(participation: float, num_clients: int) -> int:
    """|S_t| = round(p·m), floored at 1 — the ONE place this is computed."""
    return max(1, int(round(participation * num_clients)))


@dataclass(frozen=True)
class UniformScheduler:
    num_clients: int
    cohort: int
    name: str = "uniform"

    def __post_init__(self):
        if not (1 <= self.cohort <= self.num_clients):
            raise ValueError(f"cohort {self.cohort} must be in "
                             f"[1, {self.num_clients}]")

    def sample(self, seed: int, round_idx: int) -> np.ndarray:
        """(cohort,) distinct int32 client ids for round ``round_idx``:
        Gumbel-top-k over equal log-weights."""
        g = np.random.default_rng([int(seed), int(round_idx)]).gumbel(
            size=self.num_clients)
        return np.argsort(-g, kind="stable")[:self.cohort].astype(np.int32)


def make_scheduler(kind: str, *, num_clients: int, cohort: int):
    if kind == "uniform":
        return UniformScheduler(num_clients, cohort)
    raise NotImplementedError(
        f"scheduler {kind!r} comes with the scenario port, ROADMAP A10")
