"""Federated-learning round configuration: the fields of the reference's
``repro/configs/base.py FLConfig`` that the ported slice reads (paper §4
defaults). Scenario, compression, robust aggregation, fleet and
telemetry fields arrive with their ROADMAP items.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FLConfig:
    num_clients: int = 100           # m
    participation: float = 0.1       # p  -> |S_t| = p*m
    client_opt: str = "delta_sgd"
    server_opt: str = "fedavg"
    fedprox_mu: float = 0.0
    # Δ-SGD defaults (paper footnotes 2-3: γ=2, η0=0.2, θ0=1, δ=0.1)
    gamma: float = 2.0
    eta0: float = 0.2
    theta0: float = 1.0
    delta: float = 0.1
