"""Client optimizers: everything the paper compares,

    SGD, SGD(↓), SGDM, SGDM(↓), Adam, Adagrad, SPS, Δ-SGD.

Port of ``repro/core/client_opt.py``. A ``ClientOpt`` is a triple of
functions on one client's param tree, written with tensor ops only (no
host read, no in-place update), so the vmap engine runs them under
``torch.func.vmap`` over the client axis:

    state = opt.init(params)
    state = opt.reset(state, round_frac)        # start of each round
    params, state = opt.update(params, grads, state, loss)

``round_frac`` = t/T drives the paper's step-wise decay (÷10 after 50 %
and 75 % of the rounds) of the (↓) variants; the vmap engine takes it as
the reference's jitted round does (``utils.numerics.round_frac``).
``hyper`` holds Δ-SGD's hyperparameters, which the flat engine reads.

Updates compute in f32 and cast back to the leaf's dtype. Where the
reference does arithmetic on a leaf in its own dtype (a bf16 moment, a
bf16 gradient times a Python float), JAX gives the Python float the
leaf's dtype first; ``utils.numerics.weak`` does the same, so bf16
leaves get the reference's op-by-op bits.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.delta_sgd import (_f32, _global_norm, _sgd_apply,
                                        delta_sgd_init, delta_sgd_reset,
                                        delta_sgd_update)
from repro_torch.utils.numerics import weak
from repro_torch.utils.tree import tree_leaves, tree_map


class ClientOpt(NamedTuple):
    name: str
    init: Callable[[Any], Any]
    reset: Callable[[Any, Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple]
    hyper: Any = None   # Δ-SGD's hyperparameters (dict), which the flat
    #                     engine reads; use_pallas selects the vmap
    #                     engine's kernel route


def _decay_scale(round_frac: torch.Tensor) -> torch.Tensor:
    """Paper's (↓) schedule: ÷10 at 50 %, ÷100 at 75 % of total rounds."""
    return torch.where(round_frac >= 0.75, 0.01,
                       torch.where(round_frac >= 0.5, 0.1, 1.0)
                       ).to(torch.float32)


def _sgd_like(name, lr, momentum=0.0, decay=False):
    def init(params):
        return {"m": tree_map(torch.zeros_like, params) if momentum
                else None,
                "scale": _f32(1.0, tree_leaves(params)[0])}

    def reset(state, round_frac):
        # round_frac is a host scalar: the scale is read on the host and
        # filled on the device, with no host-to-device copy
        scale = (float(_decay_scale(torch.as_tensor(round_frac)))
                 if decay else 1.0)
        return {**state, "scale": torch.full_like(state["scale"], scale)}

    def update(params, grads, state, loss):
        eta = lr * state["scale"]
        if momentum:
            m = tree_map(lambda m_, g: weak(momentum, m_) * m_ + g,
                         state["m"], grads)
            return _sgd_apply(params, m, eta), {"m": m,
                                                "scale": state["scale"]}
        return _sgd_apply(params, grads, eta), state

    return ClientOpt(name, init, reset, update)


def _adam_like(name, lr, b1=0.9, b2=0.999, eps=1e-8, adagrad=False):
    def init(params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "t": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device)}

    def reset(state, round_frac):
        return state

    def update(params, grads, state, loss):
        t = state["t"] + 1
        if adagrad:
            v = tree_map(lambda v_, g: v_ + torch.square(g), state["v"],
                         grads)
            params = tree_map(
                lambda p, g, v_: (p.to(torch.float32) - weak(lr, g) * g
                                  / (torch.sqrt(v_.to(torch.float32)) + eps)
                                  ).to(p.dtype), params, grads, v)
            return params, {"m": state["m"], "v": v, "t": t}
        m = tree_map(lambda m_, g: weak(b1, m_) * m_ + weak(1 - b1, g) * g,
                     state["m"], grads)
        v = tree_map(lambda v_, g: (weak(b2, v_) * v_
                                    + weak(1 - b2, g) * torch.square(g)),
                     state["v"], grads)
        tf = t.to(torch.float32)
        bc1 = 1 - b1 ** tf
        bc2 = 1 - b2 ** tf
        params = tree_map(
            lambda p, m_, v_: (p.to(torch.float32)
                               - lr * (m_.to(torch.float32) / bc1)
                               / (torch.sqrt(v_.to(torch.float32) / bc2)
                                  + eps)).to(p.dtype), params, m, v)
        return params, {"m": m, "v": v, "t": t}

    return ClientOpt(name, init, reset, update)


def _sps(name, c=0.5, f_star=0.0, eps=1e-8):
    """Stochastic Polyak step size (Loizou et al. 2021), paper footnote 4:
    η = (f_i(x) − f*) / (c·‖∇f_i(x)‖²) with f* = 0, c = 0.5; ‖g‖² is the
    square of the global norm, as the reference takes it."""
    def init(params):
        return {}

    def reset(state, round_frac):
        return state

    def update(params, grads, state, loss):
        gn2 = torch.square(_global_norm(grads))
        eta = (loss.to(torch.float32) - f_star) / (c * gn2 + eps)
        return _sgd_apply(params, grads, eta), state

    return ClientOpt(name, init, reset, update)


def _delta_sgd(name, *, gamma, delta, eta0, theta0, groupwise=False,
               use_pallas=False):
    def init(params):
        return delta_sgd_init(params, eta0=eta0, theta0=theta0,
                              groupwise=groupwise)

    def reset(state, round_frac):
        return delta_sgd_reset(state, eta0=eta0, theta0=theta0)

    def update(params, grads, state, loss):
        return delta_sgd_update(params, grads, state, gamma=gamma,
                                delta=delta, eta0=eta0,
                                use_pallas=use_pallas)

    hyper = dict(gamma=gamma, delta=delta, eta0=eta0, theta0=theta0,
                 groupwise=groupwise, use_pallas=use_pallas)
    return ClientOpt(name, init, reset, update, hyper)


def get_client_opt(name: str, fl_cfg: FLConfig = None,
                   **overrides) -> ClientOpt:
    """Factory. ``fl_cfg`` supplies defaults (FLConfig); overrides win."""
    cfg = fl_cfg or FLConfig()
    lr = overrides.get("lr", cfg.lr)
    mom = overrides.get("momentum", cfg.momentum)
    if name == "sgd":
        return _sgd_like("sgd", lr)
    if name == "sgd_decay":
        return _sgd_like("sgd_decay", lr, decay=True)
    if name == "sgdm":
        return _sgd_like("sgdm", lr, momentum=mom)
    if name == "sgdm_decay":
        return _sgd_like("sgdm_decay", lr, momentum=mom, decay=True)
    if name == "adam":
        return _adam_like("adam", lr)
    if name == "adagrad":
        return _adam_like("adagrad", lr, adagrad=True)
    if name == "sps":
        return _sps("sps", c=overrides.get("c", 0.5))
    if name == "delta_sgd":
        return _delta_sgd(
            "delta_sgd",
            gamma=overrides.get("gamma", cfg.gamma),
            delta=overrides.get("delta", cfg.delta),
            eta0=overrides.get("eta0", cfg.eta0),
            theta0=overrides.get("theta0", cfg.theta0),
            groupwise=overrides.get("groupwise", False),
            use_pallas=overrides.get("use_pallas", False))
    raise KeyError(f"unknown client optimizer {name!r}")


CLIENT_OPTS = ("sgd", "sgd_decay", "sgdm", "sgdm_decay", "adam", "adagrad",
               "sps", "delta_sgd")
