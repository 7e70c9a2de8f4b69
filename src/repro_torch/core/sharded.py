"""The sharded flat round's local steps on a rank's tensor-parallel blocks,
and the collectives that round makes.

The sharded round is ``repro_torch.core.fed_round``'s flat body run on
each rank of a ``torch.distributed`` mesh (its module docstring). The
round's (C, N) slabs keep the reference's layout: C over the client
axes, N contiguous over the N-shard axes (``FederationSpec.flat_spec``).
Its local steps run on another slab of the same clients, the rank's
"TP slab" (``TPSlab``), in which every element of N lives on exactly one
rank of the N-shard group:

  * a leaf that the params' placement (``sharding.spec.param_placements``,
    read from the installed training rules) cuts keeps the rank's
    placement block, the block the tensor-parallel model reads;
  * the leaves whose blocks the placement leaves whole over the same
    N-shard axes (``rest``) form one group: their blocks, flattened and
    concatenated in layout order, are cut into |rest| contiguous pieces
    of the layout's aligned width (``flat._padded``), the rank's piece
    by its block index over ``rest``. The forward reads the blocks
    whole, so a group's pieces are gathered at use (one ``flat_gather``
    a group, a chunk of clients at a time), and the gradient keeps the
    rank's piece after ``_grad_sync``.

A model with no placement (no rules installed: the paper's CNN and MLP)
is the case where every leaf is in the one group over every N-shard
axis: its pieces are then the layout's own contiguous columns, so the
local steps run on the same slab, with the same sums, as the round's
earlier route, which gathered the whole model at use a chunk of clients
at a time, as this does. Δ-SGD's two norms count each element once with
the one (2, C_loc) ``norms`` sum a step. The round's params
are whole on every rank at its start, so ``TPSlab.cut`` takes the
rank's slab from them with no collective; at its tail one
``all_to_all`` over the N-shard axes (``flat_reshard``) moves the
round-end local params back to the contiguous (C_loc, N_loc) columns
before compression, the robust ladder or the FedBuff buffer.

``round_collectives`` counts what that body calls on a rank, for the
collective recorder's checks (``repro_torch.sharding.hlo``) and the
``static`` event: per local step, a chunk of ``grad_chunk`` clients at a
time, one ``flat_gather`` for each group of split leaves and the model's
own collectives, then the ``norms`` sum; per round the tail's
``flat_reshard``, its packed client-axis sum and (2,) min, the robust
ladder's own sums, telemetry's loss gather and the aggregate's gather
over the N-shard axes. Collectives over axes of size 1 are not made.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import flat as flatlib
from repro_torch.sharding.spec import (axes_size, block_index, entry_axes,
                                       local_shape, mesh_shape)
from repro_torch.utils.tree import tree_unflatten


def grad_chunk(C_loc: int, local: int, gathered: int) -> int:
    """Clients a rank evaluates at once, so that a chunk's elements
    gathered at use are at most the rank's (C_loc, local) slab: all
    C_loc when nothing is gathered, else ceil(C_loc · local /
    gathered). ``local`` and ``gathered`` are a client's elements on the
    rank and gathered at use (a whole model over S shards: 1 and S)."""
    if gathered <= 0:
        return max(1, C_loc)
    return max(1, min(C_loc, -(-C_loc * local // gathered)))


def local_step_collectives(C_loc: int, shards: int, *,
                           chunks: Optional[int] = None, gathers: int = 1,
                           model: int = 0) -> int:
    """Collectives a rank makes per local step when N is sharded: for
    each of ``chunks`` client chunks (``grad_chunk``'s, by default a
    whole model's) ``gathers`` ``flat_gather`` ops and the model's own
    ``model`` collectives, then the ``norms`` sum."""
    if shards <= 1:
        return 0
    if chunks is None:
        chunks = -(-C_loc // grad_chunk(C_loc, 1, shards))
    return chunks * (gathers + model) + 1


def round_collectives(C_loc: int, K: int, shards: int, *,
                      client_axes: bool, robust: str = None,
                      skipped: bool = False, deciles: bool = False,
                      step: Optional[int] = None) -> int:
    """The collectives one sharded round makes on a rank: per local
    step ``step`` (``local_step_collectives``' count of a model with no
    placement by default); the tail's ``flat_reshard``; the robust
    ladder's (clip: the norms over the N-shard axes and the packed
    client sum; mean, trimmed, median: one client sum); the packed
    metric sum and the η extrema over the client axes, and with
    telemetry's ``loss_deciles`` the loss gather over them; the
    aggregate's all-gather over the N-shard axes (none when a quorum
    skip keeps the params)."""
    if step is None:
        step = local_step_collectives(C_loc, shards)
    n = K * step + int(shards > 1)
    if robust is not None:
        n += int(client_axes)
        if robust == "clip" and shards > 1:
            n += 1
    n += (3 if deciles else 2) * int(client_axes)
    if shards > 1 and not skipped:
        n += 1
    return n


class Share(NamedTuple):
    """One leaf of the layout on a rank."""
    offset: int                # the leaf's offset in the flat layout
    shape: Tuple[int, ...]     # the whole leaf's shape
    entries: tuple             # its placement entries (one a dim)
    block: Tuple[int, ...]     # the rank's placement block's shape
    size: int                  # the block's elements
    rest: Tuple[str, ...]      # live N-shard axes the placement leaves whole
    dtype: torch.dtype


class Slot(NamedTuple):
    """A run of the TP slab: one leaf's block (no ``rest``), or the
    rank's piece of a group's blocks concatenated in layout order."""
    leaves: Tuple[int, ...]    # the leaves (layout order)
    rest: Tuple[str, ...]
    total: int                 # their blocks' elements together
    piece: int                 # the slot's width
    start: int                 # the rank's first element of the total
    length: int                # its elements
    at: int                    # the slot's offset in the TP slab


def _live_na(mesh, federation) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in federation.flat_axes(mesh)[1] if shape[a] > 1)


class TPSlab:
    """A rank's TP slab of a flat ``layout`` (module docstring) on
    ``mesh`` under ``federation``: ``placements`` are the layout's
    leaves' placement entries (``param_placements``' leaves, in layout
    order; None: no placement, every leaf in one group), ``coords`` the
    rank's ``{axis: index}``. Every rank of the N-shard group has the
    same slots (``slots``: a leaf's block, or a group's piece, ``piece``
    wide, its ``length`` first elements the rank's, the rest zero);
    ``width`` is the slab's padded width (a multiple of the kernels'
    lane width)."""

    def __init__(self, layout: flatlib.FlatLayout, mesh, federation,
                 placements: Optional[List[tuple]], coords: Dict[str, int]):
        self.layout, self.mesh, self.federation = layout, mesh, federation
        self.coords = dict(coords)
        self.na = na = federation.flat_axes(mesh)[1]
        live = _live_na(mesh, federation)
        shape = mesh_shape(mesh)
        shares = []
        for i, spec in enumerate(layout.leaves):
            entries = (tuple(placements[i]) if placements is not None
                       else (None,) * len(spec.shape))
            used = {a for e in entries for a in entry_axes(e)
                    if shape.get(a, 1) > 1}
            if used - set(live):
                raise ValueError(
                    f"the placement cuts a leaf of shape {spec.shape} over "
                    f"{sorted(used - set(live))}, which are not N-shard axes "
                    f"of the flat round ({na}): its blocks would belong to "
                    "other clients")
            block = local_shape(spec.shape, entries, mesh)
            shares.append(Share(spec.offset, spec.shape, entries, block,
                                _numel(block),
                                tuple(a for a in live if a not in used),
                                spec.dtype))
        self.shares = tuple(shares)
        # a slot a leaf without rest, a slot a group, at its first leaf
        groups: Dict[tuple, list] = {}
        for i, sh in enumerate(shares):
            if sh.rest:
                groups.setdefault(sh.rest, []).append(i)
        slots, at = [], 0
        for i, sh in enumerate(shares):
            if not sh.rest:
                slots.append(Slot((i,), (), sh.size, sh.size, 0, sh.size,
                                  at))
            elif groups[sh.rest][0] == i:
                ix = tuple(groups[sh.rest])
                total = sum(shares[j].size for j in ix)
                n = axes_size(mesh, sh.rest)
                piece = flatlib._padded(total, n) // n
                start, length = self._piece(sh.rest, total, piece,
                                            self.coords)
                slots.append(Slot(ix, sh.rest, total, piece, start, length,
                                  at))
            else:
                continue
            at += slots[-1].piece
        self.slots = tuple(slots)
        self.valid = sum(s.length for s in slots)
        self.span = at              # the same on every rank of the group
        self.width = flatlib._padded(max(at, 1))
        self.groups = tuple(s for s in slots if s.rest)
        # what a chunk's gathers hold a client: every piece of a group
        self.gathered = sum(axes_size(mesh, s.rest) * s.piece
                            for s in self.groups)
        self._maps = {}

    def _piece(self, rest, total, piece, coords):
        """(start, length) of the piece of ``coords`` in a group."""
        start = block_index(self.mesh, rest, coords) * piece
        return start, max(0, min(piece, total - start))

    # -- the slab's own ---------------------------------------------------
    def chunk(self, C_loc: int) -> int:
        """``grad_chunk`` of this slab: clients a rank evaluates at
        once, the same on every rank of the N-shard group (their
        collectives pair up)."""
        return grad_chunk(C_loc, max(self.span, 1), self.gathered)

    def mask(self, device) -> Optional[torch.Tensor]:
        """(width,) f32 round mask: 1.0 on the rank's elements of bf16
        leaves (``flat.round_mask`` on this slab), None if all are f32."""
        if all(s.dtype == torch.float32 for s in self.shares):
            return None
        m = torch.zeros((self.width,), dtype=torch.float32, device=device)
        for slot in self.slots:
            o = 0
            for i in slot.leaves:
                sh = self.shares[i]
                a = max(o, slot.start)
                b = min(o + sh.size, slot.start + slot.length)
                if sh.dtype != torch.float32 and a < b:
                    m[slot.at + a - slot.start:slot.at + b - slot.start] = 1.0
                o += sh.size
        return m

    def _block_of(self, leaf: torch.Tensor, sh: Share,
                  coords=None) -> torch.Tensor:
        """The placement block of a whole ``leaf`` at ``coords`` (the
        rank's by default; a view)."""
        from repro_torch.sharding.spec import local_block
        return local_block(leaf, sh.entries, self.mesh,
                           self.coords if coords is None else coords)

    def cut(self, P: torch.Tensor) -> torch.Tensor:
        """The rank's (width,) slab of the whole (N,) flat params."""
        out = P.new_zeros((self.width,))
        for slot in self.slots:
            if not slot.length:
                continue
            flat = [self._block_of(P[sh.offset:sh.offset + _numel(sh.shape)]
                                   .view(sh.shape), sh).reshape(-1)
                    for sh in (self.shares[i] for i in slot.leaves)]
            flat = flat[0] if len(flat) == 1 else torch.cat(flat)
            out[slot.at:slot.at + slot.length] = \
                flat[slot.start:slot.start + slot.length]
        return out

    def blocks(self, P: torch.Tensor, *, role: str = "flat_gather"):
        """The params tree of placement blocks, (ch, *block) each, of the
        (ch, width) slab rows ``P``: a leaf slot's a view, a group's
        pieces gathered over its ``rest`` axes (one ``all_gather`` a
        group) and split into its leaves' blocks. Leaves take their
        dtype."""
        from repro_torch.sharding import dist
        ch = P.shape[0]
        out = [None] * len(self.shares)
        for slot in self.slots:
            x = P[:, slot.at:slot.at + slot.piece]
            if slot.rest:
                x = dist.all_gather(x.contiguous(), self.mesh, slot.rest,
                                    dim=1, role=role)
            o = 0
            for i in slot.leaves:
                sh = self.shares[i]
                out[i] = x[:, o:o + sh.size].view((ch,) + sh.block)
                o += sh.size
        out = [x if sh.dtype == torch.float32 else x.to(sh.dtype)
               for x, sh in zip(out, self.shares)]
        return tree_unflatten(self.layout.treedef, out)

    def pack(self, grads: List[torch.Tensor], out: torch.Tensor) -> None:
        """Write the rank's elements of the (ch, *block) gradient leaves
        (in layout order) into the (ch, width) slab rows ``out``; its
        padding stays as it is (zero)."""
        ch = out.shape[0]
        for slot in self.slots:
            if not slot.length:
                continue
            g = [grads[i].reshape(ch, -1) for i in slot.leaves]
            g = g[0] if len(g) == 1 else torch.cat(g, dim=1)
            out[:, slot.at:slot.at + slot.length] = \
                g[:, slot.start:slot.start + slot.length]

    # -- the tail's reshard -------------------------------------------------
    def _slot_index(self, slot: Slot, coords, device) -> torch.Tensor:
        """The layout indices of the elements the rank at ``coords``
        holds in ``slot``, in slab order (increasing: each block is
        row-major and the leaves are in layout order)."""
        start, length = ((0, slot.total) if not slot.rest else
                         self._piece(slot.rest, slot.total, slot.piece,
                                     coords))
        parts, o = [], 0
        for i in slot.leaves:
            sh = self.shares[i]
            a, b = max(o, start), min(o + sh.size, start + length)
            if a < b:
                if sh.size == _numel(sh.shape):     # the leaf whole
                    parts.append(torch.arange(sh.offset + a - o,
                                              sh.offset + b - o,
                                              device=device))
                else:
                    idx = torch.arange(sh.offset,
                                       sh.offset + _numel(sh.shape),
                                       device=device)
                    parts.append(self._block_of(idx.view(sh.shape), sh,
                                                coords).reshape(-1)[
                        a - o:b - o])
            o += sh.size
        if not parts:
            return torch.zeros((0,), dtype=torch.long, device=device)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _reshard_maps(self, device):
        """(send segments, send counts, receive order, receive counts) of
        the tail's all-to-all, made once for a device. Within a slot the
        rank's elements lie in increasing layout order, so those for
        each destination's contiguous columns are a run of it: ``send``
        lists each destination's (slab start, end) runs in slot order.
        ``order`` (int32) gives, source after source, the columns of what
        each sends, in the order it sends them."""
        import itertools
        key = str(device)
        hit = self._maps.get(key)
        if hit is not None:
            return hit
        S = self.federation.flat_shards(self.mesh)
        n_loc = self.layout.padded_size // S
        segs = [[] for _ in range(S)]
        bounds = torch.arange(1, S, device=device) * n_loc
        for slot in self.slots:
            if not slot.length:
                continue
            g = self._slot_index(slot, self.coords, device)
            cut = ([0] + torch.searchsorted(g, bounds).tolist()
                   + [slot.length])
            for q in range(S):
                if cut[q + 1] > cut[q]:
                    segs[q].append((slot.at + cut[q], slot.at + cut[q + 1]))
            del g
        send = [sum(e - b for b, e in seg) for seg in segs]
        # the receive side: every source of the N-shard group in block
        # order, its slots in slab order, its elements in our columns
        shape = mesh_shape(self.mesh)
        live = _live_na(self.mesh, self.federation)
        me = block_index(self.mesh, self.na, self.coords)
        lo, hi = me * n_loc, (me + 1) * n_loc
        order, recv = [], []
        for c in itertools.product(*(range(shape[a]) for a in live)):
            coords = dict(self.coords, **dict(zip(live, c)))
            n = 0
            for slot in self.slots:
                g = self._slot_index(slot, coords, device)
                g = g[(g >= lo) & (g < hi)]
                order.append((g - lo).to(torch.int32))
                n += int(g.numel())
            recv.append(n)
        hit = (segs, send, torch.cat(order), recv)
        self._maps[key] = hit
        return hit

    def to_columns(self, P: torch.Tensor, *,
                   role: str = "flat_reshard") -> torch.Tensor:
        """The (C_loc, width) TP slab rows ``P`` -> the rank's contiguous
        (C_loc, N_loc) block of the flat layout: one ``all_to_all`` over
        the N-shard axes (the layout's padding columns are zero)."""
        from repro_torch.sharding import dist
        S = self.federation.flat_shards(self.mesh)
        C_loc = P.shape[0]
        n_loc = self.layout.padded_size // S
        if isinstance(self.mesh, dist.AbstractMesh):
            send = P.new_empty((C_loc * self.valid,))
            dist.all_to_all(send, [0] * S, [C_loc * self.valid] + [0] * (S - 1),
                            self.mesh, self.na, role=role)
            return P.new_zeros((C_loc, n_loc))
        segs, send_n, order, recv_n = self._reshard_maps(P.device)
        buf = P.new_empty((C_loc * sum(send_n),))
        o = 0
        for seg, n in zip(segs, send_n):
            block = buf[o:o + C_loc * n].view(C_loc, n)
            c = 0
            for b, e in seg:
                block[:, c:c + e - b] = P[:, b:e]
                c += e - b
            o += C_loc * n
        got = dist.all_to_all(buf, [C_loc * n for n in send_n],
                              [C_loc * n for n in recv_n], self.mesh,
                              self.na, role=role)
        del buf
        out = P.new_zeros((C_loc, n_loc))
        o = c = 0
        for n in recv_n:
            out[:, order[c:c + n]] = got[o:o + C_loc * n].view(C_loc, n)
            o, c = o + C_loc * n, c + n
        return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def tp_slab(layout, mesh, federation, rules=None, coords=None) -> TPSlab:
    """The rank's ``TPSlab`` of ``layout``: the placements of the
    installed training ``rules`` (their ``param_axes``, whose spec must
    give the round's flat axes), or none; ``coords`` default to the
    rules' or the mesh's own."""
    from repro_torch.sharding import dist
    placements = None
    if rules is not None:
        if rules.spec.flat_axes(mesh) != federation.flat_axes(mesh):
            raise ValueError(
                f"the installed training rules' spec puts the flat axes at "
                f"{rules.spec.flat_axes(mesh)}, the round's federation at "
                f"{federation.flat_axes(mesh)}")
        placements = list(placement_key(rules.param_axes))
        coords = rules.coords if coords is None else coords
    if coords is None:
        coords = dist.coords(mesh)
    return TPSlab(layout, mesh, federation, placements, coords)


def placement_key(axes) -> tuple:
    """The placement entries of every leaf in layout order, a hashable
    key."""
    from repro_torch.utils.tree import tree_flatten
    return tuple(tuple(e) for e in tree_flatten(axes)[0])
