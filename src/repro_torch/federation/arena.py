"""Fleet-scale client-state arena: persistent state per REGISTERED
client, keyed by client id. Port of ``repro/federation/arena.py``.

The round engine materializes only the sampled cohort, a (C, ...) slab.
At fleet scale (C_registered >> C) the per-client state that must
survive the rounds a client sits out (its EF21 reconstruction, its last
Δ-SGD step size, its participation history) cannot live in cohort slots:
slot c belongs to another client every round. The arena keys it by
registered id:

  * storage is (C_registered, ...) tensors on the device;
  * each round the fleet loop draws the cohort ids (the draw the data
    pipeline makes), gathers only those C rows (``arena_take``), runs the
    round on the cohort slab, and writes the updated rows back
    (``arena_update``). A never-sampled client's rows are never read or
    written, so they keep their bits;
  * with error feedback off the arena holds O(C_registered) scalars;
    EF21 adds the one (C_registered, N) f32 slab the algorithm itself
    needs (g_c persists per client).

Fields:
  eta         (C_reg,) f32   last round-end Δ-SGD η (init η₀); with
                             ``eta_carry`` the fleet loop warm-starts a
                             returning client's η₀ from it.
  rounds_seen (C_reg,) int32 participation count (0 = never sampled).
  last_round  (C_reg,) int32 round of the last participation (−1
                             before the first).
  ef          (C_reg, N) f32 EF21 reconstruction per registered client
                             (only under error-feedback compression).

``arena_shardings`` gives each field's placement on a mesh: rows over the
client axes, N kept whole for the EF slab (the reference's NamedShardings
as plain axis tuples); ``arena_local`` cuts a rank's rows. The fleet loop
itself runs un-meshed, as the reference's does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ClientArena(NamedTuple):
    eta: torch.Tensor                       # (C_reg,) f32
    rounds_seen: torch.Tensor               # (C_reg,) int32
    last_round: torch.Tensor                # (C_reg,) int32, -1 = never
    ef: Optional[torch.Tensor] = None       # (C_reg, N) f32 or None


def arena_init(num_registered: int, *, eta0: float,
               ef_width: Optional[int] = None,
               device=None) -> ClientArena:
    """A fresh arena for ``num_registered`` clients on ``device``.
    ``ef_width`` (the flat layout's padded size) allocates the
    (C_reg, N) EF21 slab: pass it only under error-feedback compression,
    it is the one field whose memory scales with C_registered × N."""
    ef = (torch.zeros((num_registered, ef_width), dtype=torch.float32,
                      device=device) if ef_width is not None else None)
    return ClientArena(
        torch.full((num_registered,), eta0, dtype=torch.float32,
                   device=device),
        torch.zeros((num_registered,), dtype=torch.int32, device=device),
        torch.full((num_registered,), -1, dtype=torch.int32, device=device),
        ef)


def arena_take(arena: ClientArena, ids: torch.Tensor) -> ClientArena:
    """The cohort's rows: (C,) ids -> a cohort-sized ClientArena (a
    gather; the (C_reg, ...) storage is indexed, never copied whole)."""
    return ClientArena(*(None if a is None else a[ids] for a in arena))


def arena_update(arena: ClientArena, ids: torch.Tensor,
                 rows: ClientArena) -> ClientArena:
    """Write the cohort's updated rows back, IN PLACE (an index copy into
    the arena's own storage, as the reference's donated buffers are
    updated): only the ``ids`` rows change, every other row keeps its
    bits. Returns ``arena``. The schedulers draw without replacement, so
    ``ids`` holds no duplicate."""
    for a, r in zip(arena, rows):
        if a is not None:
            a.index_copy_(0, ids.long(), r.to(a.dtype))
    return arena


def arena_shardings(arena: ClientArena, mesh, federation) -> ClientArena:
    """Each field's placement on ``mesh``, as one entry per dim (None or
    a tuple of mesh axes): vectors over the client axes, the EF slab's
    rows over the client axes with N kept whole. None fields stay
    None."""
    ca, _ = federation.flat_axes(mesh)
    entry = ca if ca else None
    return ClientArena(*(None if a is None else
                         ((entry,) if a.dim() == 1 else (entry, None))
                         for a in arena))


def arena_local(arena: ClientArena, mesh, federation,
                coord=None) -> ClientArena:
    """This rank's rows of every field (``arena_shardings``' placement):
    C_registered split over the client axes, blocked row-major in their
    order. ``coord`` ({axis: index}) defaults to the rank's coordinate."""
    from repro_torch.core.flat import local_clients
    return ClientArena(*(None if a is None else
                         local_clients(a, mesh, federation, coord)
                         for a in arena))
