"""Federation scenario engine.

  schedulers    — who participates (uniform / size-weighted / zipf /
                  cyclic), numpy draws keyed on (seed, round).
  heterogeneity — how many local steps each client manages (K_c ≤ K_max),
                  lowered as per-step lane masks on the flat engine.
  faults        — fault lanes (drops, NaN grads, byzantine deltas,
                  over-staleness) + the RobustAgg ladder
                  (mean/clip/trimmed/median).
  buffer        — the FedBuff server-side delta buffer with staleness-
                  weighted merges into any ServerOpt.
  scenarios     — the named presets bundling all axes.
  arena         — fleet-scale per-REGISTERED-client state (EF21, Δ-SGD η
                  carry, participation history) in (C_registered, ...)
                  device storage; rounds gather only the cohort's rows
                  and write them back; ``arena_shardings`` places its
                  rows over a mesh's client axes.

``robust_aggregate_sharded`` runs the ladder on a rank's block of a
mesh-sharded buffer.
"""
from repro_torch.federation.arena import (ClientArena, arena_init,
                                          arena_local, arena_shardings,
                                          arena_take, arena_update)
from repro_torch.federation.buffer import (AsyncBufferState, buffer_init,
                                           buffer_merge, buffer_step,
                                           staleness_weights)
from repro_torch.federation.faults import (ROBUST_AGG_KINDS, FaultLanes,
                                           FaultModel, RobustAgg,
                                           robust_aggregate,
                                           robust_aggregate_sharded)
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
    "AsyncBufferState", "buffer_init", "buffer_merge", "buffer_step",
    "staleness_weights", "SPEED_MODELS", "SpeedModel", "active_mask",
    "step_active",
    "SCHEDULERS", "Scheduler", "UniformScheduler", "SizeWeightedScheduler",
    "ZipfScheduler", "CyclicScheduler", "cohort_size", "make_scheduler",
    "SCENARIOS", "Scenario", "ScenarioDraws", "get_scenario",
    "ROBUST_AGG_KINDS", "FaultLanes", "FaultModel", "RobustAgg",
    "robust_aggregate", "robust_aggregate_sharded", "ClientArena",
    "arena_init", "arena_take", "arena_update", "arena_shardings",
    "arena_local",
]
