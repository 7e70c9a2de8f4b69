"""Participation schedulers: who is in the cohort S_t.

Port of ``repro/federation/schedulers.py``. The reference draws a
Gumbel-top-k over ``jax.random`` bits keyed on ``fold_in(key(seed), t)``;
those bits cannot be reproduced here, so the port draws the same
distributions from a numpy generator keyed on ``(seed, t)``. Adding iid
Gumbel noise to log-weights and taking the top C indices draws C
distinct clients with probability proportional to their weights. Every
draw is a pure function of ``(seed, t)``: a resumed run re-draws the
cohort an uninterrupted run drew. Tests that need the reference's exact
cohorts replay them (``FederatedDataset(scheduler=...)``, or a scenario
draw source, ``repro_torch.interop.draws_from_numpy``).

Schedulers:
  uniform       — every client equally likely (the paper's protocol).
  size_weighted — P(i) ∝ n_i local samples.
  zipf          — P(i) ∝ (i+1)^(−s): heavy-tailed availability.
  cyclic        — only a rotating window of clients is available each
                  round; uniform inside the window.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def keyed_rng(*key: int) -> np.random.Generator:
    """A numpy generator that is a pure function of the integer ``key``
    (for example ``(seed, round, axis)``)."""
    return np.random.default_rng([int(k) for k in key])


def cohort_size(participation: float, num_clients: int) -> int:
    """|S_t| = round(p·m), floored at 1 — the ONE place this is computed."""
    return max(1, int(round(participation * num_clients)))


@dataclass(frozen=True)
class Scheduler:
    """Base: subclasses define ``log_weights(round_idx)``."""
    num_clients: int
    cohort: int
    name: str = "uniform"

    def __post_init__(self):
        if not (1 <= self.cohort <= self.num_clients):
            raise ValueError(f"cohort {self.cohort} must be in "
                             f"[1, {self.num_clients}]")

    def log_weights(self, round_idx: int) -> np.ndarray:
        del round_idx
        return np.zeros((self.num_clients,), np.float64)

    def sample(self, seed: int, round_idx: int) -> np.ndarray:
        """(cohort,) distinct int32 client ids for round ``round_idx``:
        Gumbel-top-k over the log-weights."""
        g = keyed_rng(seed, round_idx).gumbel(size=self.num_clients)
        keys = self.log_weights(round_idx) + g
        return np.argsort(-keys, kind="stable")[:self.cohort].astype(
            np.int32)


@dataclass(frozen=True)
class UniformScheduler(Scheduler):
    name: str = "uniform"


@dataclass(frozen=True)
class SizeWeightedScheduler(Scheduler):
    """P(i) ∝ n_i; ``sizes`` is the (m,) per-client sample counts."""
    sizes: object = field(default=(), compare=False)
    name: str = "size_weighted"

    def __post_init__(self):
        super().__post_init__()
        if len(self.sizes) != self.num_clients:
            raise ValueError(f"sizes has {len(self.sizes)} entries for "
                             f"{self.num_clients} clients")

    def log_weights(self, round_idx: int) -> np.ndarray:
        del round_idx
        s = np.asarray(self.sizes, np.float64)
        return np.log(np.maximum(s, 1e-6))


@dataclass(frozen=True)
class ZipfScheduler(Scheduler):
    """P(i) ∝ (i+1)^(−s): client 0 is the most available."""
    s: float = 1.2
    name: str = "zipf"

    def log_weights(self, round_idx: int) -> np.ndarray:
        del round_idx
        return -self.s * np.log(np.arange(1, self.num_clients + 1,
                                          dtype=np.float64))


@dataclass(frozen=True)
class CyclicScheduler(Scheduler):
    """Rotating availability window: at round t only clients with
    ``(i − t·stride) mod m < window`` are up; ``window ≥ cohort``."""
    window_frac: float = 0.25
    name: str = "cyclic"

    @property
    def window(self) -> int:
        return max(self.cohort,
                   int(round(self.window_frac * self.num_clients)))

    @property
    def stride(self) -> int:
        return max(1, self.window // 2)

    def log_weights(self, round_idx: int) -> np.ndarray:
        i = np.arange(self.num_clients)
        start = (int(round_idx) * self.stride) % self.num_clients
        avail = ((i - start) % self.num_clients) < self.window
        return np.where(avail, 0.0, -np.inf)


def make_scheduler(kind: str, *, num_clients: int, cohort: int,
                   sizes: Optional[np.ndarray] = None,
                   zipf_s: float = 1.2, window_frac: float = 0.25):
    """Scheduler factory shared by the data pipeline and the round."""
    if kind == "uniform":
        return UniformScheduler(num_clients, cohort)
    if kind == "size_weighted":
        if sizes is None:
            # no size information: equal n_i, which is the uniform draw
            return UniformScheduler(num_clients, cohort,
                                    name="size_weighted")
        return SizeWeightedScheduler(num_clients, cohort,
                                     sizes=np.asarray(sizes, np.float32))
    if kind == "zipf":
        return ZipfScheduler(num_clients, cohort, s=zipf_s)
    if kind == "cyclic":
        return CyclicScheduler(num_clients, cohort, window_frac=window_frac)
    raise KeyError(f"unknown scheduler kind {kind!r}")


SCHEDULERS = ("uniform", "size_weighted", "zipf", "cyclic")
