"""Carry weights and state across from the reference package.

The reference's params are a nested dict of arrays; after
``jax.device_get`` (or ``np.asarray`` per leaf) they are numpy arrays,
with bf16 leaves in the ``ml_dtypes`` bfloat16 dtype. These helpers map
such a tree to the port's dict of tensors and back, with the same names,
shapes and dtypes, so both packages can start from the same params. This
module imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fed_round import FLState
from repro_torch.utils.tree import tree_map


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # bf16 numpy arrays need it, as jax's do
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree, device="cpu"):
    """Reference params (nested dict of numpy arrays) -> dict of tensors."""
    return tree_map(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(params):
    """Port params -> nested dict of numpy arrays (same dtypes)."""
    return tree_map(_to_numpy, params)


def fl_state_from_numpy(state, device="cpu") -> FLState:
    """A reference ``FLState`` whose leaves are numpy arrays -> the port's
    FLState. Only the fields of the ported sync round are carried: an
    async buffer or EF21 state is rejected."""
    if getattr(state, "buffer", None) is not None or \
            getattr(state, "ef", None) is not None:
        raise NotImplementedError("async buffers (ROADMAP A10) and EF21 "
                                  "state (ROADMAP A12) are not ported")
    return FLState(params_from_numpy(state.params, device),
                   params_from_numpy(state.server_state, device),
                   int(np.asarray(state.round)))
