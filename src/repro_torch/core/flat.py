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

Only ``shards=1`` layouts exist here; the mesh-sharded layout is part
of the multi-device item (ROADMAP A17).
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
    Leaves may be tensors or anything with ``shape`` and ``dtype``."""
    if shards != 1:
        raise NotImplementedError(
            "sharded flat layouts (shards > 1) are part of the "
            "multi-device port, ROADMAP A17")
    leaves, treedef = treelib.tree_flatten(tree)
    shapes = tuple(tuple(l.shape[1:] if batched else l.shape)
                   for l in leaves)
    dtypes = tuple(l.dtype for l in leaves)
    key = (treedef, shapes, dtypes)
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
    layout = FlatLayout(treedef, tuple(specs), off, _padded(off), 1)
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
