"""Client loss functions: CE, FedProx (Li et al. 2020), MOON (Li et al.
2021).

Port of ``repro/core/losses.py make_loss``. The round threads
``(params, batch, global_params, prev_params)`` through one signature;
plain CE ignores the extra arguments. Δ-SGD composes with any of these
(paper Tables 2b, 5, 6).
"""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_leaves


def _sq_dist(a, b):
    return sum(((x.float() - y.float()) ** 2).sum()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _cos(a, b):
    a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-8)
    b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-8)
    return (a * b).sum(dim=-1)


def make_loss(base_loss_fn, *, fedprox_mu: float = 0.0,
              moon_mu: float = 0.0, moon_tau: float = 0.5, repr_fn=None):
    """base_loss_fn(params, batch) -> (loss, metrics).

    Returns loss_fn(params, batch, global_params=None, prev_params=None)
    -> (loss, metrics). With ``moon_mu``, ``repr_fn(params, batch)``
    gives the representations MOON contrasts: the local one against the
    global model's (positive) and the previous local model's (negative),
    both detached."""
    if moon_mu and repr_fn is None:
        raise ValueError("MOON needs a representation fn (repr_fn=)")

    def loss_fn(params, batch, global_params=None, prev_params=None):
        if fedprox_mu or moon_mu:
            from repro_torch.core.delta_sgd import training_rules
            if training_rules() is not None:
                raise ValueError("FedProx and MOON under tensor-parallel "
                                 "rules: their distances over sharded "
                                 "params are not ported")
        loss, metrics = base_loss_fn(params, batch)
        if fedprox_mu and global_params is not None:
            prox = 0.5 * fedprox_mu * _sq_dist(params, global_params)
            loss = loss + prox
            metrics = {**metrics, "prox": prox}
        if moon_mu and global_params is not None and prev_params is not None:
            z = repr_fn(params, batch)
            z_glob = repr_fn(global_params, batch).detach()
            z_prev = repr_fn(prev_params, batch).detach()
            pos = _cos(z, z_glob) / moon_tau
            neg = _cos(z, z_prev) / moon_tau
            con = -(pos - torch.logaddexp(pos, neg)).mean()
            loss = loss + moon_mu * con
            metrics = {**metrics, "moon": con}
        return loss, metrics

    return loss_fn
