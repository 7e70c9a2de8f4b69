"""Client loss functions: CE and FedProx (Li et al. 2020).

Port of ``repro/core/losses.py make_loss``. The round threads
``(params, batch, global_params, prev_params)`` through one signature;
plain CE ignores the extra arguments. MOON comes with ROADMAP A5.
"""
from __future__ import annotations

from repro_torch.utils.tree import tree_leaves


def _sq_dist(a, b):
    return sum(((x.float() - y.float()) ** 2).sum()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def make_loss(base_loss_fn, *, fedprox_mu: float = 0.0,
              moon_mu: float = 0.0):
    """base_loss_fn(params, batch) -> (loss, metrics).

    Returns loss_fn(params, batch, global_params=None, prev_params=None)
    -> (loss, metrics)."""
    if moon_mu:
        raise NotImplementedError("the MOON loss comes with ROADMAP A5")

    def loss_fn(params, batch, global_params=None, prev_params=None):
        loss, metrics = base_loss_fn(params, batch)
        if fedprox_mu and global_params is not None:
            prox = 0.5 * fedprox_mu * _sq_dist(params, global_params)
            loss = loss + prox
            metrics = {**metrics, "prox": prox}
        return loss, metrics

    return loss_fn
