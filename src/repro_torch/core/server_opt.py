"""Server-side aggregation optimizers (Reddi et al. 2021 meta-algorithm).
Port of ``repro/core/server_opt.py``.

update(global_params, client_mean, state) -> (new_params, state)

FedAvg     : x ← mean_i x_i^K                      (paper's main setting)
FedAvgM    : server momentum on Δ = mean − x
FedAdam    : Adam on pseudo-gradient −Δ
FedYogi    : Yogi on pseudo-gradient −Δ

Δ-SGD is orthogonal to all of these (paper §2, Appendix B.4).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.numerics import weak
from repro_torch.utils.tree import tree_leaves, tree_map


class ServerOpt(NamedTuple):
    name: str
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


def fedavg() -> ServerOpt:
    return ServerOpt("fedavg",
                     lambda params: {},
                     lambda params, mean, state: (mean, state))


def fedavgm(lr: float = 1.0, momentum: float = 0.9) -> ServerOpt:
    """The momentum lives in the leaf's dtype, as in the reference; a
    Python float takes a bf16 leaf's dtype there, as in JAX."""
    def init(params):
        return {"m": tree_map(torch.zeros_like, params)}

    def update(params, mean, state):
        delta = tree_map(lambda a, b: a - b, mean, params)
        m = tree_map(lambda m_, d: weak(momentum, m_) * m_ + d,
                     state["m"], delta)
        new = tree_map(
            lambda p, m_: (p.to(torch.float32)
                           + lr * m_.to(torch.float32)).to(p.dtype),
            params, m)
        return new, {"m": m}

    return ServerOpt("fedavgm", init, update)


def _adaptive(name, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, yogi=False):
    def init(params):
        # moments live in f32 whatever the leaf's dtype: update() computes
        # them from the f32-cast delta
        return {"m": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params),
                "v": tree_map(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params),
                "t": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device)}

    def update(params, mean, state):
        delta = tree_map(lambda a, b: (a - b).to(torch.float32),
                         mean, params)
        t = state["t"] + 1
        m = tree_map(lambda m_, d: b1 * m_ + (1 - b1) * d,
                     state["m"], delta)
        if yogi:
            v = tree_map(
                lambda v_, d: v_ - (1 - b2) * torch.square(d)
                * torch.sign(v_ - torch.square(d)), state["v"], delta)
        else:
            v = tree_map(lambda v_, d: b2 * v_ + (1 - b2) * torch.square(d),
                         state["v"], delta)
        tf = t.to(torch.float32)
        bc1, bc2 = 1 - b1 ** tf, 1 - b2 ** tf
        new = tree_map(
            lambda p, m_, v_: (p.to(torch.float32)
                               + lr * (m_ / bc1)
                               / (torch.sqrt(torch.abs(v_) / bc2) + eps)
                               ).to(p.dtype),
            params, m, v)
        return new, {"m": m, "v": v, "t": t}

    return ServerOpt(name, init, update)


def fedadam(lr: float = 1e-3) -> ServerOpt:
    return _adaptive("fedadam", lr=lr)


def fedyogi(lr: float = 1e-3) -> ServerOpt:
    return _adaptive("fedyogi", lr=lr, yogi=True)


def get_server_opt(name: str, **kw) -> ServerOpt:
    return {"fedavg": fedavg, "fedavgm": fedavgm, "fedadam": fedadam,
            "fedyogi": fedyogi}[name](**kw)


SERVER_OPTS = ("fedavg", "fedavgm", "fedadam", "fedyogi")
