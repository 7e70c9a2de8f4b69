"""Scenario registry: named (participation × compute × aggregation ×
bandwidth × faults) regimes.

Port of ``repro/federation/scenarios.py``: the same ``Scenario`` fields,
validation and eleven ``SCENARIOS`` presets. A scenario is a frozen,
hashable config that the round closes over.

Draws. The reference keys every draw on ``fold_in(key(seed), round)``
and an axis: 1 for step counts, 2 for async staleness, 3 for bandwidth
levels, 4 for faults (one sub-stream per fault mode). ``jax.random`` bits cannot be
reproduced here, so the port's draws are pure functions of
``(seed, round, axis)`` on numpy generators (``ScenarioDraws``), with
the reference's distributions. They are injectable: a scenario's
``draws`` field takes any object with ``cohort_ids(t, num_clients,
cohort, sizes)``, ``step_counts(t, C, K)``, ``staleness(t, C)``,
``compression_levels(t, C)`` and ``faults(t, C, K)`` (numpy results), and the data pipeline and the
round then use it instead. Parity tests pass one that replays the
reference's own draws (``repro_torch.interop.draws_from_numpy``).

The async presets (``zipf_async``, ``byzantine_async``) route the round
through the FedBuff buffer (``repro_torch.federation.buffer``). The
fleet presets carry ``registered_hint`` and ``participation_hint``, which
the train CLI turns into the fleet loop (``core.fed_loop
.make_fleet_loop``). ``sync_iid`` is the seed configuration: the round
with it is the round without a scenario.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional

import numpy as np

from repro_torch.compression.spec import LEVELS
from repro_torch.federation.faults import FaultLanes, FaultModel, RobustAgg
from repro_torch.federation.heterogeneity import SpeedModel
from repro_torch.federation.schedulers import keyed_rng, make_scheduler

# size of the compression-level ladder (none < int8 < topk)
_NUM_LEVELS = len(LEVELS)

# the reference's fold_in axes of the round key
_AXIS_STEPS, _AXIS_STALENESS, _AXIS_LEVELS, _AXIS_FAULTS = 1, 2, 3, 4


@dataclass(frozen=True)
class Scenario:
    name: str
    # participation
    scheduler: str = "uniform"       # uniform|size_weighted|zipf|cyclic
    zipf_s: float = 1.2
    window_frac: float = 0.25        # cyclic availability window
    # compute heterogeneity
    speed: str = "fixed"             # fixed|uniform|stragglers
    k_min_frac: float = 0.25
    straggler_frac: float = 0.3
    # aggregation
    aggregation: str = "sync"        # sync|async
    buffer_size: int = 8             # M (async)
    staleness_max: int = 4           # s_c ~ U{0..staleness_max} (async)
    staleness_exp: float = 0.5       # w(s) = (1+s)^-a (async)
    # bandwidth heterogeneity over the LEVELS ladder (0=none, 1=int8,
    # 2=topk): "fixed" = everyone at the run's CompressionSpec.kind;
    # "uniform" = level ~ U{0..2}; "tiered" = categorical(tier_probs)
    bandwidth: str = "fixed"         # fixed|uniform|tiered
    tier_probs: tuple = (0.2, 0.5, 0.3)
    # fault axis (repro_torch.federation.faults); all rates 0 = the
    # fault-free round
    drop_rate: float = 0.0
    nan_rate: float = 0.0
    byzantine_rate: float = 0.0
    byzantine_scale: float = -10.0
    overstale_rate: float = 0.0
    overstale: int = 16
    # robust server aggregation + graceful degradation
    robust_agg: str = "mean"         # mean|clip|trimmed|median
    clip_norm: float = 10.0
    trim_frac: float = 0.2
    quorum: int = 0                  # skip round when < Q valid clients
    # data hint for drivers (not read by the round)
    alpha: Optional[float] = None
    # fleet hints for drivers (not read by the round)
    registered_hint: Optional[int] = None
    participation_hint: Optional[float] = None
    seed: int = 0
    # injectable draw source (see the module docstring); None = the
    # port's own draws
    draws: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.aggregation not in ("sync", "async"):
            raise KeyError(f"unknown aggregation {self.aggregation!r}")
        if self.bandwidth not in ("fixed", "uniform", "tiered"):
            raise KeyError(f"unknown bandwidth model {self.bandwidth!r}")
        if len(self.tier_probs) != _NUM_LEVELS:
            raise ValueError(
                f"tier_probs must have one entry per compression level "
                f"(repro_torch.compression.LEVELS, {_NUM_LEVELS}), got "
                f"{len(self.tier_probs)}")
        if self.quorum < 0:
            raise ValueError(f"quorum must be >= 0, got {self.quorum}")
        SpeedModel(self.speed)  # validates the kind
        self.fault_model        # validates rates
        self.robust_model       # validates kind/clip_norm/trim_frac

    # ---- derived models -------------------------------------------------
    @property
    def speed_model(self) -> SpeedModel:
        return SpeedModel(self.speed, k_min_frac=self.k_min_frac,
                          straggler_frac=self.straggler_frac)

    @property
    def heterogeneous(self) -> bool:
        return self.speed_model.heterogeneous

    @property
    def is_async(self) -> bool:
        return self.aggregation == "async"

    @property
    def bandwidth_heterogeneous(self) -> bool:
        return self.bandwidth != "fixed"

    @property
    def fault_model(self) -> FaultModel:
        return FaultModel(drop_rate=self.drop_rate,
                          nan_rate=self.nan_rate,
                          byzantine_rate=self.byzantine_rate,
                          byzantine_scale=self.byzantine_scale,
                          overstale_rate=self.overstale_rate,
                          overstale=self.overstale)

    @property
    def faulty(self) -> bool:
        return self.fault_model.active

    @property
    def robust_model(self) -> RobustAgg:
        return RobustAgg(kind=self.robust_agg, clip_norm=self.clip_norm,
                         trim_frac=self.trim_frac)

    @property
    def robust(self) -> bool:
        return self.robust_model.robust

    def make_scheduler(self, num_clients: int, cohort: int, sizes=None):
        return make_scheduler(self.scheduler, num_clients=num_clients,
                              cohort=cohort, sizes=sizes,
                              zipf_s=self.zipf_s,
                              window_frac=self.window_frac)

    # ---- per-round draws: numpy, pure in (seed, round) -----------------
    @property
    def draw_source(self):
        return self.draws if self.draws is not None else ScenarioDraws(self)

    def draw_cohort(self, round_idx: int, num_clients: int, cohort: int,
                    sizes=None) -> np.ndarray:
        """(cohort,) int32 client ids of round ``round_idx``: the ids the
        data pipeline gathers for and the round reports."""
        return np.asarray(self.draw_source.cohort_ids(
            int(round_idx), num_clients, cohort, sizes), np.int32)

    def draw_step_counts(self, round_idx: int, num_clients: int,
                         k_max: int) -> np.ndarray:
        return np.asarray(self.draw_source.step_counts(
            int(round_idx), num_clients, k_max), np.int32)

    def draw_staleness(self, round_idx: int,
                       num_clients: int) -> np.ndarray:
        """(C,) int32 in [0, staleness_max]: the rounds each update has
        been in flight when it reaches the server buffer (async)."""
        return np.asarray(self.draw_source.staleness(
            int(round_idx), num_clients), np.int32)

    def draw_compression_levels(self, round_idx: int,
                                num_clients: int) -> np.ndarray:
        """(C,) int32 bandwidth levels over the LEVELS ladder."""
        return np.asarray(self.draw_source.compression_levels(
            int(round_idx), num_clients), np.int32)

    def draw_faults(self, round_idx: int, num_clients: int,
                    k_max: int) -> FaultLanes:
        lanes = self.draw_source.faults(int(round_idx), num_clients, k_max)
        return FaultLanes(np.asarray(lanes[0], np.int32),
                          np.asarray(lanes[1], np.int32),
                          np.asarray(lanes[2], bool),
                          np.asarray(lanes[3], bool))


class ScenarioDraws:
    """The port's own draws for a scenario: numpy generators keyed on
    ``(seed, round, axis)``, the reference's distributions."""

    def __init__(self, scenario: Scenario):
        self.scn = scenario

    def cohort_ids(self, t: int, num_clients: int, cohort: int, sizes):
        sch = self.scn.make_scheduler(num_clients, cohort, sizes=sizes)
        return sch.sample(self.scn.seed, t)

    def step_counts(self, t: int, num_clients: int, k_max: int):
        rng = keyed_rng(self.scn.seed, t, _AXIS_STEPS)
        return self.scn.speed_model.draw(rng, num_clients, k_max)

    def staleness(self, t: int, num_clients: int):
        if self.scn.staleness_max <= 0:
            return np.zeros((num_clients,), np.int32)
        rng = keyed_rng(self.scn.seed, t, _AXIS_STALENESS)
        return rng.integers(0, self.scn.staleness_max + 1,
                            size=num_clients)

    def compression_levels(self, t: int, num_clients: int):
        rng = keyed_rng(self.scn.seed, t, _AXIS_LEVELS)
        if self.scn.bandwidth == "uniform":
            return rng.integers(0, _NUM_LEVELS, size=num_clients)
        p = np.asarray(self.scn.tier_probs, np.float64)
        return rng.choice(_NUM_LEVELS, size=num_clients, p=p / p.sum())

    def faults(self, t: int, num_clients: int, k_max: int) -> FaultLanes:
        return self.scn.fault_model.draw(
            (self.scn.seed, t, _AXIS_FAULTS), num_clients, k_max)


SCENARIOS: Dict[str, Scenario] = {s.name: s for s in (
    Scenario("sync_iid", alpha=1.0),
    Scenario("sync_dirichlet", alpha=0.1),
    Scenario("size_weighted", scheduler="size_weighted"),
    Scenario("dirichlet_stragglers", speed="stragglers", alpha=0.1),
    Scenario("cyclic_hetero", scheduler="cyclic", speed="uniform"),
    Scenario("zipf_async", scheduler="zipf", speed="uniform",
             aggregation="async", buffer_size=8),
    Scenario("bandwidth_tiered", bandwidth="tiered"),
    Scenario("dirichlet_dropouts", speed="stragglers", alpha=0.1,
             drop_rate=0.3, nan_rate=0.05, quorum=2),
    Scenario("byzantine_async", scheduler="zipf", speed="uniform",
             aggregation="async", buffer_size=8, byzantine_rate=0.1,
             overstale_rate=0.1, robust_agg="clip", quorum=2),
    Scenario("fleet_uniform", speed="uniform", alpha=0.1,
             registered_hint=100_000, participation_hint=0.0005),
    Scenario("fleet_zipf", scheduler="zipf", speed="uniform", alpha=0.1,
             registered_hint=100_000, participation_hint=0.0005),
)}


def get_scenario(name_or_scenario, **overrides) -> Scenario:
    """Resolve a preset by name (or pass a Scenario through), with
    optional field overrides, e.g. ``get_scenario("dirichlet_dropouts",
    seed=3)``."""
    if isinstance(name_or_scenario, Scenario):
        scn = name_or_scenario
    else:
        try:
            scn = SCENARIOS[name_or_scenario]
        except KeyError:
            raise KeyError(f"unknown scenario {name_or_scenario!r}; "
                           f"presets: {sorted(SCENARIOS)}") from None
    return replace(scn, **overrides) if overrides else scn
