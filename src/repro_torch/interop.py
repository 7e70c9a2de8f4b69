"""Carry weights and state across from the reference package.

The reference's params are a nested dict of arrays; after
``jax.device_get`` (or ``np.asarray`` per leaf) they are numpy arrays,
with bf16 leaves in the ``ml_dtypes`` bfloat16 dtype. These helpers map
such a tree to the port's dict of tensors and back, with the same names,
shapes and dtypes, so both packages can start from the same params. The
LM zoo's trees cross as they are: runs of n > 1 blocks with every leaf
stacked on a leading layer axis, the shared block once at the top,
Whisper's encoder subtree and cross-attention leaves, xLSTM's mixers,
and decode caches (their 0-d ``t`` and Whisper's per-layer cross K/V
``enc_kv`` included). An ``FLState`` crosses in both
directions with its server state (fedavgm's ``m``, fedadam's and
fedyogi's f32 ``m``, ``v`` and ``t``), its async FedBuff buffer and its
EF21 tree, and so do a per-leaf Δ-SGD ``DeltaSGDState`` and the fleet's
``ClientArena``; the port keeps its round counter a Python int.
``draws_from_numpy`` turns the reference's per-round scenario draws into
a draw source that the port's scenarios replay. Under a mesh,
``fl_state_local_from_numpy`` and ``clients_local_from_numpy`` give one
rank its block of the reference's global state, batches and per-client
vectors (``repro_torch.core.flat.local_slab``), so the reference and
every rank start from the same bits; ``params_local_from_numpy`` gives a
rank its blocks of the reference's params by the tensor-parallel
placement. ``train_local_from_numpy`` gives a rank its blocks of the
reference's ``FLState`` and a round's (C, K, b, ...) batches under the
training rules (``launch.steps.place_train_for_rank``). This module
imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.delta_sgd import DeltaSGDState
from repro_torch.core.fed_round import FLState
from repro_torch.federation.arena import ClientArena
from repro_torch.federation.buffer import AsyncBufferState
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


def _fields_from_numpy(cls, tup, device):
    """A NamedTuple of numpy trees -> the port's ``cls`` of tensor trees
    (None fields stay None)."""
    return cls(*(None if f is None else params_from_numpy(f, device)
                 for f in tup))


def _fields_to_numpy(cls, tup):
    return cls(*(None if f is None else params_to_numpy(f) for f in tup))


def fl_state_from_numpy(state, device="cpu") -> FLState:
    """A reference ``FLState`` whose leaves are numpy arrays -> the port's
    FLState, with its async buffer (an ``AsyncBufferState``) and EF21
    state (``ef``)."""
    buf = getattr(state, "buffer", None)
    ef = getattr(state, "ef", None)
    return FLState(params_from_numpy(state.params, device),
                   params_from_numpy(state.server_state, device),
                   int(np.asarray(state.round)),
                   None if buf is None else _fields_from_numpy(
                       AsyncBufferState, buf, device),
                   None if ef is None else params_from_numpy(ef, device))


def fl_state_to_numpy(state: FLState) -> FLState:
    """The port's FLState -> the same fields as numpy arrays (the round
    an int32 0-d array, as the reference carries it), ready for the
    reference's ``FLState(*...)``; the buffer's fields are ready for its
    ``AsyncBufferState(*...)``."""
    return FLState(params_to_numpy(state.params),
                   params_to_numpy(state.server_state),
                   np.asarray(state.round, np.int32),
                   None if state.buffer is None else _fields_to_numpy(
                       AsyncBufferState, state.buffer),
                   None if state.ef is None else params_to_numpy(state.ef))


def fl_state_local_from_numpy(state, mesh, federation, device="cpu",
                              coord=None) -> FLState:
    """A reference ``FLState`` of numpy leaves -> this rank's FLState
    under ``mesh``/``federation``: params, server state and buffer
    whole, the EF21 tree (C, ...) packed with the sharded layout and cut
    to the rank's (C_loc, N_loc) slab. ``coord`` ({axis: index})
    defaults to the rank's coordinate on ``mesh``."""
    from repro_torch.core import flat as flatlib
    whole = fl_state_from_numpy(state._replace(ef=None), device)
    ef = state.ef
    if ef is None:
        return whole
    layout = flatlib.layout_of(whole.params,
                               shards=federation.flat_shards(mesh))
    packed = flatlib.pack_batched(params_from_numpy(ef, device), layout)
    return whole._replace(ef=flatlib.local_slab(packed, mesh, federation,
                                                coord))


def clients_local_from_numpy(tree, mesh, federation, device="cpu",
                             coord=None, axis: int = 0):
    """This rank's clients of every leaf of a numpy tree whose ``axis``
    is the cohort (batches (C, K, ...), cohort ids and weights (C,),
    blocks (R, C, ...) with ``axis=1``): the rows of the rank's client
    block, as tensors."""
    from repro_torch.core.flat import local_clients

    def one(a):
        t = _to_tensor(a, device)
        return local_clients(t.movedim(axis, 0), mesh, federation,
                             coord).movedim(0, axis).contiguous()
    return tree_map(one, tree)


def params_local_from_numpy(tree, placements, mesh, device="cpu",
                            coord=None):
    """Reference params (nested dict of numpy arrays) -> this rank's
    blocks of them under ``placements`` (``sharding.spec.
    param_placements``, or the serve rules' ``param_axes``) on ``mesh``,
    as tensors on ``device``. ``coord`` ({axis: index}) defaults to the
    rank's coordinate on ``mesh``."""
    from repro_torch.sharding.dist import coords
    from repro_torch.sharding.spec import local_block
    coord = coords(mesh) if coord is None else coord
    return tree_map(lambda a, ax: local_block(
        _to_tensor(a, "cpu"), ax, mesh, coord).contiguous().to(device),
        tree, placements)


def arena_from_numpy(arena, device="cpu") -> ClientArena:
    """A reference ``ClientArena`` of numpy arrays -> the port's."""
    return _fields_from_numpy(ClientArena, arena, device)


def arena_to_numpy(arena: ClientArena) -> ClientArena:
    """The port's ``ClientArena`` -> numpy fields, ready for the
    reference's ``ClientArena(*...)``."""
    return _fields_to_numpy(ClientArena, arena)


def delta_sgd_state_from_numpy(state, device="cpu") -> DeltaSGDState:
    """A reference per-leaf ``DeltaSGDState`` (numpy leaves; η, θ and
    ‖g_prev‖ scalars, or dicts of them under the groupwise rule) -> the
    port's."""
    return DeltaSGDState(*(params_from_numpy(f, device) for f in state))


def delta_sgd_state_to_numpy(state: DeltaSGDState) -> DeltaSGDState:
    """The port's per-leaf ``DeltaSGDState`` -> numpy leaves, for the
    reference's ``DeltaSGDState(*...)``."""
    return DeltaSGDState(*(params_to_numpy(f) for f in state))


class ReplayDraws:
    """A scenario draw source (``Scenario(draws=...)``) that replays
    recorded per-round draws instead of drawing."""

    def __init__(self, rounds: Dict[int, Dict[str, Any]]):
        self.rounds = rounds

    def _get(self, t: int, what: str, shape):
        try:
            value = self.rounds[t][what]
        except KeyError:
            raise KeyError(f"no recorded {what} for round {t}") from None
        if what != "faults" and np.shape(value) != tuple(shape):
            raise ValueError(f"recorded {what} of round {t} has shape "
                             f"{np.shape(value)}, the round needs {shape}")
        return value

    def cohort_ids(self, t, num_clients, cohort, sizes):
        return self._get(t, "cohort_ids", (cohort,))

    def step_counts(self, t, num_clients, k_max):
        return self._get(t, "step_counts", (num_clients,))

    def staleness(self, t, num_clients):
        return self._get(t, "staleness", (num_clients,))

    def compression_levels(self, t, num_clients):
        return self._get(t, "levels", (num_clients,))

    def faults(self, t, num_clients, k_max):
        return self._get(t, "faults", None)


def draws_from_numpy(rounds: Dict[int, Dict[str, Any]]) -> ReplayDraws:
    """The reference's per-round scenario draws -> the port's replay
    source. ``rounds[t]`` maps any of ``"cohort_ids"``, ``"step_counts"``,
    ``"staleness"``, ``"levels"`` (numpy arrays) and ``"faults"`` (the four lanes of a
    reference ``FaultLanes``, as numpy arrays) to round t's draw, for
    example ``np.asarray(scn.draw_step_counts(t, C, K))`` taken from the
    reference scenario."""
    def convert(key, value):
        if key == "faults":
            return tuple(np.asarray(v) for v in value)
        return np.asarray(value)
    return ReplayDraws({int(t): {k: convert(k, v) for k, v in d.items()}
                        for t, d in rounds.items()})


def train_local_from_numpy(rules, *, state=None, batch=None, device="cpu"):
    """One rank's blocks, under training ``rules``, of a reference
    ``FLState`` and a round's batches given as numpy trees: the state's
    params and param-shaped server slots by the params' placement, the
    batches with C over the client axes and b over the fsdp axes.
    Returns {"state", "batch"}: those given."""
    from repro_torch.launch.steps import place_train_for_rank
    return place_train_for_rank(
        rules, device=device,
        state=None if state is None else fl_state_from_numpy(state),
        batch=None if batch is None else params_from_numpy(batch))
