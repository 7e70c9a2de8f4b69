"""Server-side aggregation optimizers. Port of ``repro/core/server_opt.py``
for FedAvg (x ← mean_i x_i^K, the paper's main setting); fedavgm,
fedadam and fedyogi come with ROADMAP A6.

update(global_params, client_mean, state) -> (new_params, state)
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

_LATER = ("fedavgm", "fedadam", "fedyogi")


class ServerOpt(NamedTuple):
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


def fedavg() -> ServerOpt:
    return ServerOpt("fedavg",
                     lambda params: {},
                     lambda params, mean, state: (mean, state))


def get_server_opt(name: str, **kw) -> ServerOpt:
    if name == "fedavg":
        return fedavg(**kw)
    if name in _LATER:
        raise NotImplementedError(
            f"server optimizer {name!r} comes with ROADMAP A6")
    raise KeyError(f"unknown server optimizer {name!r}")
