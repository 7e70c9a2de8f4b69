"""Client optimizers. Port of ``repro/core/client_opt.py`` for Δ-SGD.

The flat engine re-expresses Δ-SGD outside a per-leaf ``update`` and
reads only ``ClientOpt.hyper``; the per-leaf ``init/reset/update``
triple belongs to the vmap engine, and sgd, sgd_decay, sgdm,
sgdm_decay, adam, adagrad and sps to ROADMAP A6.
"""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.configs.base import FLConfig

_LATER = ("sgd", "sgd_decay", "sgdm", "sgdm_decay", "adam", "adagrad",
          "sps")


class ClientOpt(NamedTuple):
    name: str
    hyper: Any = None   # hyperparameters (dict) read by the flat engine


def get_client_opt(name: str, fl_cfg: FLConfig = None,
                   **overrides) -> ClientOpt:
    """Factory. ``fl_cfg`` supplies defaults; overrides win."""
    cfg = fl_cfg or FLConfig()
    if name == "delta_sgd":
        if overrides.get("groupwise", False):
            raise NotImplementedError(
                "groupwise Δ-SGD runs on the vmap engine, ROADMAP A7")
        return ClientOpt("delta_sgd", dict(
            gamma=overrides.get("gamma", cfg.gamma),
            delta=overrides.get("delta", cfg.delta),
            eta0=overrides.get("eta0", cfg.eta0),
            theta0=overrides.get("theta0", cfg.theta0),
            groupwise=False))
    if name in _LATER:
        raise NotImplementedError(
            f"client optimizer {name!r} comes with ROADMAP A6")
    raise KeyError(f"unknown client optimizer {name!r}")
