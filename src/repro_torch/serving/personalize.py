"""Personalized decode: serve a registered client's locally adapted
delta as a low-cost overlay on the global params. Port of
``repro/serving/personalize.py``.

A client that took part in training carries local state the server
already holds: its row of the fleet's client-state arena
(``repro_torch.federation.arena.ClientArena``), whose EF21 slab is a
per-client flat ``(N,)`` correction in the training layout. The overlay
is one axpy on the packed buffer plus an unpack:

    params_c = unpack(pack(params) + scale * delta_c, layout)

``unpack`` returns views of the buffer for f32 leaves, so an overlay
costs one flat vector, and every overlay decodes through the same
decode step (params are plain arguments).

``PersonalizationStore`` keys flat deltas by client id. They come from
``ClientArena.ef`` rows (:meth:`from_arena`) or are set directly
(:meth:`set_delta` takes a params-shaped tree or an already-flat
vector), and live on the template's device. The engine gathers the
overlay per request at admission and groups active slots by overlay
each flush.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch

from repro_torch.core.flat import layout_of, pack, unpack
from repro_torch.utils.tree import tree_leaves


class PersonalizationStore:
    """Flat per-client param deltas over a serving template layout."""

    def __init__(self, template_params: Any, *, scale: float = 1.0):
        self.layout = layout_of(template_params)
        self.device = tree_leaves(template_params)[0].device
        self.scale = float(scale)
        self._deltas: Dict[int, torch.Tensor] = {}

    def _flat(self, x) -> torch.Tensor:
        """An f32 copy of ``x`` on the template's device."""
        return torch.as_tensor(x).to(device=self.device,
                                     dtype=torch.float32, copy=True)

    # ------------------------------------------------------------- build
    @classmethod
    def from_arena(cls, arena, template_params: Any, *,
                   client_ids: Optional[Iterable[int]] = None,
                   scale: float = 1.0) -> "PersonalizationStore":
        """Deltas from the fleet arena's EF21 slab: row i is registered
        client i's flat correction in the training layout (which must be
        the serving layout: the same template tree). Clients without an
        ``ef`` row (an arena built without error feedback) cannot be
        personalized this way."""
        store = cls(template_params, scale=scale)
        if arena.ef is None:
            raise ValueError("arena has no EF21 slab (ef=None): train "
                             "with --error-feedback to accumulate "
                             "per-client deltas, or set_delta directly")
        ef = arena.ef
        if ef.shape[1] != store.layout.padded_size:
            raise ValueError(
                f"arena EF width {ef.shape[1]} != serving layout "
                f"padded_size {store.layout.padded_size}: the arena was "
                f"trained on a different model than this template")
        ids = range(ef.shape[0]) if client_ids is None else client_ids
        for cid in ids:
            store._deltas[int(cid)] = store._flat(ef[int(cid)])
        return store

    def set_delta(self, client_id: int, delta: Any) -> None:
        """delta: a params-shaped tree or a flat (padded_size,) vector."""
        if hasattr(delta, "ndim") and delta.ndim == 1:
            flat = self._flat(delta)
            if flat.shape[0] != self.layout.padded_size:
                raise ValueError(f"flat delta width {flat.shape[0]} != "
                                 f"layout {self.layout.padded_size}")
        else:
            flat = pack(delta, self.layout).to(self.device)
        self._deltas[int(client_id)] = flat

    # ------------------------------------------------------------- query
    def has(self, client_id) -> bool:
        return client_id is not None and int(client_id) in self._deltas

    def client_ids(self):
        return sorted(self._deltas)

    def overlay(self, params_flat: torch.Tensor, client_id: int) -> Any:
        """Global flat params + this client's scaled delta -> params tree
        (f32 leaves are views of one new flat vector)."""
        delta = self._deltas[int(client_id)]
        return unpack(params_flat + self.scale * delta, self.layout)
