"""FlatParams: pack a param tree into ONE lane-aligned flat buffer.

Port of ``repro/core/flat.py``. The Δ-SGD local step is two global
reductions plus an axpy (Eq. (4), Alg. 1), identical for every leaf and
every client. ``FlatLayout`` collapses both axes: the tree becomes one
``(N,)`` f32 buffer and the client axis the leading dim of a dense
``(C, N)`` buffer that one kernel launch sweeps.

The padding rule is the reference's (``_padded``), so a port buffer and
a reference buffer have the same ``N`` and can be compared whole; the
tail is zero-filled so norm reductions over the padded buffer are exact.
Leaves follow JAX's sorted-key order (``repro_torch.utils.tree``).

Mixed precision: the buffer is always f32. Elements of bf16 leaves are
marked by ``round_mask``; the masked apply kernel rounds them to bf16
after every update, as the per-leaf path's ``.astype(bf16)`` does.

Sharded layouts: on a mesh the N dim of the (C, N) buffer is split over
the N-shard axes (``repro_torch.sharding.spec.FederationSpec.flat_spec``).
A layout built with ``shards=S`` pads N so that N/S is itself lane- and
row-block-aligned, so each rank's contiguous slab is kernel-ready; all
padding lives in the global tail (zero-filled), so norms stay exact. The
layout cache key includes ``shards``. ``local_slab`` cuts a rank's
(C_loc, N_loc) block from a global tensor, ``local_clients`` its rows of
a (C, ...) tensor, and ``gather_slab`` (tests and checkpoints only)
puts the blocks of every rank back together.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.utils import tree as treelib

LANES = 128          # the reference's lane width; N is a multiple of it
BLOCK_ROWS = 1024    # the reference's kernel row block (padding rule)

_SUPPORTED = (torch.float32, torch.bfloat16)


class LeafSpec(NamedTuple):
    offset: int                # element offset into the flat buffer
    size: int                  # number of valid elements
    shape: Tuple[int, ...]     # original leaf shape (per client)
    dtype: torch.dtype         # original leaf dtype


class FlatLayout(NamedTuple):
    treedef: Any
    leaves: Tuple[LeafSpec, ...]
    size: int                  # total valid elements
    padded_size: int           # N
    shards: int = 1


_LAYOUT_CACHE: dict = {}


def _padded(total: int, shards: int = 1) -> int:
    """Round ``total`` up so that each of ``shards`` equal contiguous
    slabs splits evenly into (rows, LANES) row blocks."""
    per = max(1, -(-total // shards))
    m0 = max(1, -(-per // LANES))
    rows = min(BLOCK_ROWS, m0)
    m = -(-m0 // rows) * rows
    return m * LANES * shards


def layout_of(tree, *, batched: bool = False, shards: int = 1
              ) -> FlatLayout:
    """Flat layout for ``tree`` (cached). With ``batched=True`` the leaves
    carry a leading client axis, which is excluded from the layout.
    Leaves may be tensors or anything with ``shape`` and ``dtype``.
    ``shards`` is the N-dim shard count of the target mesh
    (``FederationSpec.flat_shards``); it is part of the cache key."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    leaves, treedef = treelib.tree_flatten(tree)
    shapes = tuple(tuple(l.shape[1:] if batched else l.shape)
                   for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    key = (treedef, shapes, dtypes, int(shards))
    hit = _LAYOUT_CACHE.get(key)
    if hit is not None:
        return hit
    specs, off = [], 0
    for shape, dtype in zip(shapes, dtypes):
        if dtype not in _SUPPORTED:
            raise TypeError(f"FlatLayout supports f32/bf16 leaves, got "
                            f"{dtype}")
        size = 1
        for d in shape:
            size *= int(d)
        specs.append(LeafSpec(off, size, shape, dtype))
        off += size
    layout = FlatLayout(treedef, tuple(specs), off, _padded(off, shards),
                        int(shards))
    _LAYOUT_CACHE[key] = layout
    return layout


def round_mask(layout: FlatLayout, device=None) -> Optional[torch.Tensor]:
    """(N,) f32 mask, 1.0 where the element belongs to a bf16 leaf and
    must be rounded after every update; None if all leaves are f32."""
    if all(s.dtype == torch.float32 for s in layout.leaves):
        return None
    m = torch.zeros((layout.padded_size,), dtype=torch.float32)
    for s in layout.leaves:
        if s.dtype != torch.float32:
            m[s.offset:s.offset + s.size] = 1.0
    return m.to(device) if device is not None else m


def pack(tree, layout: Optional[FlatLayout] = None) -> torch.Tensor:
    """Tree -> (N,) f32 buffer (zero tail padding). One concatenate."""
    layout = layout or layout_of(tree)
    leaves = treelib.tree_leaves(tree)
    parts = [l.reshape(-1).to(torch.float32) for l in leaves]
    pad = layout.padded_size - layout.size
    if pad:
        parts.append(parts[0].new_zeros((pad,)))
    return torch.cat(parts)


def unpack(buf: torch.Tensor, layout: FlatLayout, *, cast: bool = True):
    """(N,) buffer -> tree with the original shapes and dtypes. f32
    leaves (every leaf, with ``cast=False``: the async buffer's delta
    sum keeps its sub-bf16 bits) are views of ``buf``."""
    leaves = [buf[s.offset:s.offset + s.size].view(s.shape)
              for s in layout.leaves]
    if cast:
        leaves = [l.to(s.dtype) for l, s in zip(leaves, layout.leaves)]
    return treelib.tree_unflatten(layout.treedef, leaves)


def pack_batched(tree, layout: Optional[FlatLayout] = None
                 ) -> torch.Tensor:
    """Tree with a leading client axis C on every leaf -> (C, N) f32."""
    layout = layout or layout_of(tree, batched=True)
    leaves = treelib.tree_leaves(tree)
    C = leaves[0].shape[0]
    parts = [l.reshape(C, -1).to(torch.float32) for l in leaves]
    pad = layout.padded_size - layout.size
    if pad:
        parts.append(parts[0].new_zeros((C, pad)))
    return torch.cat(parts, dim=1)


def unpack_batched(buf: torch.Tensor, layout: FlatLayout, *,
                   cast: bool = True):
    """(C, N) buffer -> tree with (C, *shape) leaves. f32 leaves (every
    leaf, with ``cast=False``) are views of ``buf``."""
    C = buf.shape[0]
    leaves = [buf[:, s.offset:s.offset + s.size].view((C,) + s.shape)
              for s in layout.leaves]
    if cast:
        leaves = [l.to(s.dtype) for l, s in zip(leaves, layout.leaves)]
    return treelib.tree_unflatten(layout.treedef, leaves)


# --------------------------------------------------------------------------
# rank-local blocks of mesh-sharded buffers
# --------------------------------------------------------------------------

def _blocks(mesh, spec, coord):
    """(client block, client blocks, N block, N blocks) of ``coord``."""
    from repro_torch.sharding.spec import axes_size, block_index
    if coord is None:
        from repro_torch.sharding.dist import coords
        coord = coords(mesh)
    ca, na = spec.flat_axes(mesh)
    return (block_index(mesh, ca, coord), axes_size(mesh, ca),
            block_index(mesh, na, coord), axes_size(mesh, na))


def local_clients(x: torch.Tensor, mesh, spec, coord=None) -> torch.Tensor:
    """The rank's rows of a (C, ...) tensor: C split over the client
    axes into contiguous blocks, blocked row-major in the axes' order
    (the reference's ``bidx``). ``coord`` ({axis: index}) defaults to
    this rank's coordinate on ``mesh``."""
    bc, nc, _, _ = _blocks(mesh, spec, coord)
    C = x.shape[0]
    if C % nc:
        raise ValueError(f"C={C} clients do not split over {nc} client "
                         "shards")
    c = C // nc
    return x[bc * c:(bc + 1) * c]


def local_slab(buf: torch.Tensor, mesh, spec, coord=None) -> torch.Tensor:
    """The rank's contiguous block of a global (C, N) buffer: its
    (C_loc, N_loc) slab, rows over the client axes, columns over the
    N-shard axes; of an (N,) buffer, its (N_loc,) columns."""
    bc, nc, bn, nn = _blocks(mesh, spec, coord)
    N = buf.shape[-1]
    if N % nn:
        raise ValueError(f"N={N} does not split over {nn} N shards: "
                         "build the layout with shards=flat_shards(mesh)")
    n = N // nn
    cols = buf[..., bn * n:(bn + 1) * n]
    if buf.dim() == 1:
        return cols.contiguous()
    return local_clients(cols, mesh, spec, coord).contiguous()


def gather_slab(blocks, mesh, spec) -> torch.Tensor:
    """The inverse of ``local_slab``: ``blocks`` maps each rank's
    coordinate ({axis: index}, or its tuple in the mesh's dimension
    order) to its block. Ranks that hold the same block (replicas over
    axes the spec leaves unused) must agree; the first is taken."""
    from repro_torch.sharding.spec import mesh_shape
    names = tuple(mesh_shape(mesh))
    placed = {}
    for coord, blk in (blocks.items() if isinstance(blocks, dict)
                       else blocks):
        if not isinstance(coord, dict):
            coord = dict(zip(names, coord))
        bc, nc, bn, nn = _blocks(mesh, spec, coord)
        placed.setdefault((bc, bn), blk)
    first = next(iter(placed.values()))
    nc, nn = _blocks(mesh, spec, dict.fromkeys(names, 0))[1::2]
    if len(placed) != nc * nn:
        raise ValueError(f"{len(placed)} distinct blocks for a "
                         f"{nc} x {nn} block grid")
    if first.dim() == 1:
        return torch.cat([placed[(0, j)] for j in range(nn)])
    return torch.cat([torch.cat([placed[(i, j)] for j in range(nn)], dim=1)
                      for i in range(nc)], dim=0)
