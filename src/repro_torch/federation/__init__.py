"""Federation scenario engine (synchronous rounds).

  schedulers    — who participates (uniform / size-weighted / zipf /
                  cyclic), numpy draws keyed on (seed, round).
  heterogeneity — how many local steps each client manages (K_c ≤ K_max),
                  lowered as per-step lane masks on the flat engine.
  faults        — fault lanes (drops, NaN grads, byzantine deltas,
                  over-staleness) + the RobustAgg ladder
                  (mean/clip/trimmed/median).
  scenarios     — the named presets bundling all axes.

The FedBuff async buffer (ROADMAP A10), the fleet arena (A14) and the
mesh-sharded robust ladder (A17) are not ported yet.
"""
from repro_torch.federation.faults import (ROBUST_AGG_KINDS, FaultLanes,
                                           FaultModel, RobustAgg,
                                           robust_aggregate)
from repro_torch.federation.heterogeneity import (SPEED_MODELS, SpeedModel,
                                                  active_mask, step_active)
from repro_torch.federation.scenarios import (SCENARIOS, Scenario,
                                              ScenarioDraws, get_scenario)
from repro_torch.federation.schedulers import (SCHEDULERS, CyclicScheduler,
                                               Scheduler,
                                               SizeWeightedScheduler,
                                               UniformScheduler,
                                               ZipfScheduler, cohort_size,
                                               make_scheduler)

__all__ = [
    "SPEED_MODELS", "SpeedModel", "active_mask", "step_active",
    "SCHEDULERS", "Scheduler", "UniformScheduler", "SizeWeightedScheduler",
    "ZipfScheduler", "CyclicScheduler", "cohort_size", "make_scheduler",
    "SCENARIOS", "Scenario", "ScenarioDraws", "get_scenario",
    "ROBUST_AGG_KINDS", "FaultLanes", "FaultModel", "RobustAgg",
    "robust_aggregate",
]
