"""Fault injection + robust server aggregation.

Port of the unsharded parts of ``repro/federation/faults.py``:

  * ``FaultModel`` — per-round, per-client fault lanes, drawn from numpy
    generators keyed on ``(seed, round, 4, mode)``: one sub-stream per
    fault mode, so adding a mode never changes another mode's draws. The
    modes, each lowered as per-client lane state so the Δ-SGD step stays
    at two launches:
      - drop-mid-round: the client dies after ``drop_step < K`` local
        steps and never reports (its lane goes inactive, it is excluded);
      - NaN/Inf gradients: from a drawn step on the client's gradient
        lanes are NaN; the in-step guard latches its ``valid`` off;
      - byzantine deltas: the reported delta is scaled by
        ``byzantine_scale``;
      - async over-staleness: the update arrives ``overstale`` rounds
        late and the async round rejects it.
    The reference draws from ``jax.random``; the port draws the same
    distributions, not the same bits.

  * ``RobustAgg`` — the server aggregation ladder over packed (C, N)
    client deltas: ``mean`` (valid-masked mean), ``clip`` (per-client l2
    clipping, then mean), ``trimmed`` (coordinate-wise trimmed mean) and
    ``median``. Invalid clients carry zero weight under mean/clip and
    contribute a zero delta to trimmed/median. trimmed/median reach the
    ``batched_trimmed_mean`` kernel on CUDA tensors and its plain version
    on CPU tensors.

  * ``robust_aggregate_sharded`` — the ladder on a rank's (C_loc, N_loc)
    slab of a mesh-sharded buffer. clip's per-client norms finish with
    one (C_loc,) all_reduce over the N-shard axes; trimmed/median run
    shard-locally over the rank's C_loc clients and the (N_loc,) shard
    results are averaged across client shards (bucketed robust
    aggregation, as the reference does); the mean's numerator and
    denominator sum over the client axes in one packed all_reduce. Only
    (N_loc,)-sized payloads cross the client axes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.federation.schedulers import keyed_rng
from repro_torch.kernels.robust_agg import robust_agg as kernels
from repro_torch.utils import numerics

_RATE_FIELDS = ("drop_rate", "nan_rate", "byzantine_rate",
                "overstale_rate")


class FaultLanes(NamedTuple):
    """One round's per-client fault draws (all (C,))."""
    drop_step: object    # int32: local step the client dies at; K = never
    nan_step: object     # int32: first step with NaN grads; K = clean
    byzantine: object    # bool: delta scaled by byzantine_scale
    overstale: object    # bool: async update arrives over-stale


@dataclass(frozen=True)
class FaultModel:
    """Deterministic per-round fault injection rates (scenario axis)."""
    drop_rate: float = 0.0          # P(client drops mid-round)
    nan_rate: float = 0.0           # P(client's grads go non-finite)
    byzantine_rate: float = 0.0     # P(client's delta is corrupted)
    byzantine_scale: float = -10.0  # multiplier on corrupted deltas
    overstale_rate: float = 0.0     # P(async update arrives over-stale)
    overstale: int = 16             # staleness assigned to those updates

    def __post_init__(self):
        for f in _RATE_FIELDS:
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")

    @property
    def active(self) -> bool:
        return any(getattr(self, f) > 0.0 for f in _RATE_FIELDS)

    def draw(self, key: Sequence[int], num_clients: int,
             k_max: int) -> FaultLanes:
        """Per-client numpy lanes for one round. ``key`` (for example
        ``(seed, round, 4)``) is extended by the fault mode's index, so
        each mode has its own stream."""
        C = num_clients
        full = np.full((C,), k_max, np.int32)

        def bernoulli(rng, p):
            return rng.random(C) < p

        drop_step = full
        if self.drop_rate > 0.0:
            rng = keyed_rng(*key, 0)
            dropped = bernoulli(rng, self.drop_rate)
            # die strictly mid-round: after >= 1 step when K allows it
            step = rng.integers(1, max(k_max, 2), size=C)
            step = np.minimum(step, k_max - 1)
            drop_step = np.where(dropped, step, full).astype(np.int32)
        nan_step = full
        if self.nan_rate > 0.0:
            rng = keyed_rng(*key, 1)
            corrupt = bernoulli(rng, self.nan_rate)
            step = rng.integers(0, k_max, size=C)
            nan_step = np.where(corrupt, step, full).astype(np.int32)
        byz = (bernoulli(keyed_rng(*key, 2), self.byzantine_rate)
               if self.byzantine_rate > 0.0 else np.zeros((C,), bool))
        over = (bernoulli(keyed_rng(*key, 3), self.overstale_rate)
                if self.overstale_rate > 0.0 else np.zeros((C,), bool))
        return FaultLanes(drop_step, nan_step, byz, over)


ROBUST_AGG_KINDS = ("mean", "clip", "trimmed", "median")


@dataclass(frozen=True)
class RobustAgg:
    """Server aggregation rung over per-client round deltas."""
    kind: str = "mean"          # mean|clip|trimmed|median
    clip_norm: float = 10.0     # clip: max per-client l2 delta norm
    trim_frac: float = 0.2      # trimmed: fraction cut at EACH end

    def __post_init__(self):
        if self.kind not in ROBUST_AGG_KINDS:
            raise KeyError(f"unknown robust aggregation {self.kind!r}; "
                           f"kinds: {ROBUST_AGG_KINDS}")
        if not 0.0 <= self.trim_frac < 0.5:
            raise ValueError(
                f"trim_frac must be in [0, 0.5), got {self.trim_frac}")
        if self.clip_norm <= 0.0:
            raise ValueError(f"clip_norm must be > 0, got {self.clip_norm}")

    @property
    def robust(self) -> bool:
        return self.kind != "mean"

    def trim_count(self, num_clients: int) -> int:
        """Per-end trim count: floor(trim_frac·C), clamped so at least one
        row survives. ``median`` trims to the middle 1 (odd C) or 2 (even
        C) rows."""
        C = num_clients
        if self.kind == "median":
            return (C - 1) // 2
        return min(int(self.trim_frac * C), (C - 1) // 2)


def _masked_mean(delta: torch.Tensor, vw: torch.Tensor) -> torch.Tensor:
    """Σ_c vw_c·Δ_c / Σ_c vw_c with a zero-safe denominator."""
    den = torch.clamp(vw.sum(), min=1e-12)
    return torch.tensordot(vw, delta, dims=([0], [0])) / den


def _clip_factors(norms: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """min(1, clip/‖Δ_c‖) per client — zero-delta rows pass through."""
    clip = norms.new_full((), clip_norm)
    return torch.clamp(clip / torch.clamp(norms, min=1e-12), max=1.0)


def _sorted_window_mean(zeroed: torch.Tensor, t: int) -> torch.Tensor:
    """Coordinate-wise mean of the sorted rows [t, C−t): the trimmed mean
    (and, through RobustAgg.trim_count, the median). Invalid rows were
    zeroed by the caller. The kernel on CUDA, its plain version on CPU."""
    return kernels.batched_trimmed_mean(zeroed, t)


def robust_aggregate(delta: torch.Tensor, spec: RobustAgg,
                     valid: Optional[torch.Tensor] = None, *,
                     weights: Optional[torch.Tensor] = None):
    """Aggregate packed (C, N) client deltas -> ((N,) delta, info dict).

    ``valid`` is the (C,) bool survivor mask: invalid clients get zero
    weight under mean/clip and a zeroed row under trimmed/median.
    ``weights`` are optional client weights; the order-statistic rungs
    ignore them, as the reference does."""
    C = delta.shape[0]
    v = (valid.to(torch.float32) if valid is not None
         else delta.new_ones((C,)))
    zeroed = delta * v[:, None]
    info = {}
    if spec.kind in ("trimmed", "median"):
        return _sorted_window_mean(zeroed, spec.trim_count(C)), info
    vw = v if weights is None else v * weights.to(torch.float32)
    if spec.kind == "clip":
        norms = numerics.sqrt((zeroed * zeroed).sum(dim=1))
        factors = _clip_factors(norms, spec.clip_norm)
        info["agg_clip_rate"] = (((factors < 1.0) * v).sum()
                                 / torch.clamp(v.sum(), min=1.0))
        zeroed = zeroed * factors[:, None]
    return _masked_mean(zeroed, vw), info


def robust_aggregate_sharded(delta: torch.Tensor, spec: RobustAgg,
                             valid: torch.Tensor, *, mesh, pspec,
                             weights: Optional[torch.Tensor] = None):
    """The ladder on this rank's block of a mesh-sharded (C, N) delta
    buffer -> (the rank's (N_loc,) aggregate, info dict).

    ``pspec`` is ``FederationSpec.flat_spec(mesh)``; ``delta`` is the
    rank's (C_loc, N_loc) slab, ``valid`` and ``weights`` its (C_loc,)
    lanes. trimmed/median: ``batched_trimmed_mean`` over the rank's C_loc
    clients, then the mean of the shard results over the client axes
    (with one client a shard this is the mean). mean/clip: one packed
    all_reduce over the client axes of (Σ vw·Δ, Σ vw, and for clip
    Σ v and the clip count); clip first sums its squared norms over the
    N-shard axes."""
    from repro_torch.sharding import dist
    from repro_torch.sharding.spec import axes_size
    ca, na = pspec
    vf = valid.to(torch.float32)
    zeroed = delta * vf[:, None]
    info = {}
    if spec.kind in ("trimmed", "median"):
        shard_agg = _sorted_window_mean(zeroed, spec.trim_count(
            zeroed.shape[0]))
        dist.all_reduce(shard_agg, mesh, ca, role="robust")
        return shard_agg / float(axes_size(mesh, ca)), info
    vw = vf if weights is None else vf * weights.to(torch.float32)
    tail = [vw.sum()]
    if spec.kind == "clip":
        n2 = (zeroed * zeroed).sum(dim=1)
        dist.all_reduce(n2, mesh, na, role="robust")
        factors = _clip_factors(numerics.sqrt(n2), spec.clip_norm)
        tail += [vf.sum(), ((factors < 1.0) * vf).sum()]
        zeroed = zeroed * factors[:, None]
    part = torch.tensordot(vw, zeroed, dims=([0], [0]))
    packed = dist.all_reduce(torch.cat([part, torch.stack(tail)]), mesh, ca,
                             role="robust")
    n = part.shape[0]
    if spec.kind == "clip":
        info["agg_clip_rate"] = (packed[n + 2]
                                 / torch.clamp(packed[n + 1], min=1.0))
    return packed[:n] / torch.clamp(packed[n], min=1e-12), info
