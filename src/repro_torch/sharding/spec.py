"""FederationSpec and the sharding rules: how FL roles map onto mesh axes.

Port of ``repro/sharding/spec.py``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions
(``"data"``, ``"model"``, optionally ``"pod"``), or any object whose
``shape`` is a ``{axis: size}`` dict (the rules read sizes only).
``mesh_shape`` maps either form to that dict.

FL mapping:
  client_axes — mesh axes that enumerate simultaneously-trained clients
                (the FedAvg aggregation all-reduces over these);
  fsdp_axes   — within-client param sharding;
  tp_axes     — tensor parallel (heads / experts / ffn).

Two stock specs: ``cross_device`` (clients over (pod, data)) and
``cross_silo`` (clients over (pod,), each silo FSDP over ``data`` and TP
over ``model``; on a single pod the pod is the one silo).

Axes are plain tuples of mesh-dimension names. The packed (C, N) flat
buffer's spec is the pair ``(client_axes, shard_axes)``: C over the
first, N over the second, either possibly empty. There is no
PartitionSpec object.

The parameter rules (``param_pspec``, ``_resolve_conditional``,
``_dedupe``) are pure functions that return one entry per tensor dim:
None, an axis name, or a tuple of names. ``param_placements``,
``batch_shardings``, ``serve_batch_shardings`` and ``cache_shardings``
apply them to whole trees (the reference's ``make_param_shardings`` and
its batch and cache rules, as trees of such tuples), ``local_block``
cuts one rank's block out of a whole tensor and ``shard_bytes`` counts
a rank's bytes of a tree. ``LogicalRules`` maps the models' logical
activation names to mesh axes; the models read it through
``repro_torch.models.common.logical_rules``, and it knows this rank's
coordinates, so a model function can slice and reduce by it.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.utils.tree import tree_flatten, tree_unflatten

Axes = Tuple[str, ...]


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a DeviceMesh (``mesh_dim_names`` and
    ``shape``) or of a duck-typed mesh whose ``shape`` is that dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return dict(mesh.shape)


def axes_size(mesh, axes: Axes) -> int:
    """Product of the sizes of ``axes`` (1 for no axes)."""
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in axes)


def block_index(mesh, axes: Axes, coord: Dict[str, int]) -> int:
    """The linear block index of ``coord`` ({axis: index}) over
    ``axes``: blocked row-major in the order of ``axes``, as the
    reference's ``bidx`` reckons it (``repro/core/fed_loop.py``)."""
    shape = mesh_shape(mesh)
    b = 0
    for a in axes:
        b = b * shape[a] + int(coord[a])
    return b


@dataclass(frozen=True)
class FederationSpec:
    client_axes: Axes
    fsdp_axes: Axes
    tp_axes: Axes = ("model",)
    # shard the expert dim over tp x fsdp jointly (one expert a device)
    expert_2d: bool = False

    def clients_on(self, mesh) -> int:
        shape = mesh_shape(mesh)
        return math.prod(shape[a] for a in self.client_axes) or 1

    # -- flat (C, N) buffer layout (core/flat.py) --------------------------
    def flat_axes(self, mesh) -> Tuple[Axes, Axes]:
        """(client_axes, param_shard_axes) for the packed (C, N) buffer:
        C over the client axes, N over every remaining fsdp/tp axis
        present in the mesh. Disjoint by construction."""
        shape = mesh_shape(mesh)
        ca = tuple(a for a in self.client_axes if a in shape)
        na = tuple(a for a in self.fsdp_axes + self.tp_axes
                   if a in shape and a not in ca)
        return ca, na

    def flat_spec(self, mesh) -> Tuple[Axes, Axes]:
        """The packed (C, N) buffer's spec: (client axes, N-shard axes).
        The layout must be built with ``shards=self.flat_shards(mesh)``
        so every rank's slab stays lane/row-block aligned."""
        return self.flat_axes(mesh)

    def flat_client_spec(self, mesh) -> Axes:
        """The axes of per-client (C,) vectors (η, θ, ‖g‖)."""
        return self.flat_axes(mesh)[0]

    def flat_shards(self, mesh) -> int:
        """Number of shards of the flat param dim N."""
        return axes_size(mesh, self.flat_axes(mesh)[1])

    def local_shape(self, mesh, C: int, N: int) -> Tuple[int, int]:
        """A rank's (C_loc, N_loc) block of the global (C, N) buffer.
        Raises when C or N does not split evenly."""
        ca, na = self.flat_axes(mesh)
        nc, nn = axes_size(mesh, ca), axes_size(mesh, na)
        if C % nc:
            raise ValueError(f"cohort C={C} must divide the {nc} client "
                             "shards")
        if N % nn:
            raise ValueError(f"N={N} does not split over {nn} N shards: "
                             "build the layout with shards=flat_shards"
                             "(mesh)")
        return C // nc, N // nn


def cross_device(mesh) -> FederationSpec:
    axes = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    return FederationSpec(client_axes=axes, fsdp_axes=())


def cross_silo(mesh) -> FederationSpec:
    if "pod" in mesh_shape(mesh):
        return FederationSpec(client_axes=("pod",), fsdp_axes=("data",))
    # single pod: the pod IS the silo -> one client, FSDP+TP inside it
    return FederationSpec(client_axes=(), fsdp_axes=("data",))


def get_federation_spec(kind: str, mesh) -> FederationSpec:
    return {"cross_device": cross_device, "cross_silo": cross_silo}[kind](mesh)


# ---------------------------------------------------------------------------
# Param sharding rules: regex on the param path -> one entry per rightmost
# dim. Leading stacked-layer dims are padded with None.
# ---------------------------------------------------------------------------
def _param_rules(spec: FederationSpec):
    f = spec.fsdp_axes[0] if spec.fsdp_axes else None
    t = spec.tp_axes[0] if spec.tp_axes else None
    e_rows = "e2d" if spec.expert_2d else t
    e_cols = None if spec.expert_2d else f
    return [
        # embeddings / head
        (r"embed$",                    (t, f)),
        (r"lm_head$",                  (f, t)),
        # attention
        (r"attn/wq$",                  (f, t, None)),
        (r"attn/w[kv]$",               (f, "kv", None)),
        (r"attn/wo$",                  (t, None, f)),
        (r"attn/b[qkv]$",              (None, None)),
        # MLA
        (r"attn/wq_a$",                (f, None)),
        (r"attn/wq_b$",                (None, t, None)),
        (r"attn/wkv_a$",               (f, None)),
        (r"attn/w[kv]_b$",             (None, t, None)),
        # cross attention
        (r"xattn/wq$",                 (f, t, None)),
        (r"xattn/w[kv]$",              (f, "kv", None)),
        (r"xattn/wo$",                 (t, None, f)),
        # dense mlp
        (r"mlp/w_(gate|in)$",          (f, t)),
        (r"mlp/w_out$",                (t, f)),
        (r"mlp/b_in$",                 (t,)),
        (r"mlp/b_out$",                (None,)),
        # moe
        (r"moe/router$",               (f, None)),
        (r"moe/w_(gate|in)$",          (e_rows, e_cols, None)),
        (r"moe/w_out$",                (e_rows, None, e_cols)),
        (r"moe/shared/w_(gate|in)$",   (f, t)),
        (r"moe/shared/w_out$",         (t, f)),
        # mamba2
        (r"mixer/w_zx$",               (f, t)),
        (r"mixer/w_dt$",               (f, "heads_t")),
        (r"mixer/conv_w$",             (None, t)),
        (r"mixer/conv_b$",             (t,)),
        (r"mixer/(A_log|dt_bias|D_skip)$", ("heads_t",)),
        (r"mixer/norm$",               (t,)),
        (r"mixer/w_out$",              (t, f)),
        # mlstm / slstm
        (r"mixer/w_up$",               (f, t)),
        (r"mixer/w[qkv]$",             (t, None)),
        (r"mixer/w_if$",               (t, None)),
        (r"mixer/w_x$",                (f, t)),
        (r"mixer/r$",                  (None, "hd_t", None)),
        (r"mixer/ff_gate$",            (f, t)),
        (r"mixer/ff_out$",             (t, f)),
        # mtp
        (r"mtp/proj$",                 (f, t)),
    ]


def param_pspec(spec: FederationSpec, path: str, leaf) -> tuple:
    """The entries for one param leaf (anything with ``ndim`` or
    ``shape``, or an int rank). 'kv'/'heads_t'/'hd_t' mean: tp if the
    dim divides by the tp size, else None (``_resolve_conditional``)."""
    nd = leaf if isinstance(leaf, int) else len(tuple(leaf.shape))
    for pat, dims in _param_rules(spec):
        if re.search(pat, path):
            dims = tuple(dims)
            if len(dims) > nd:     # un-stacked rule longer than leaf rank
                dims = dims[-nd:]
            return (None,) * (nd - len(dims)) + dims
    return (None,) * nd


def _resolve_conditional(pspec: tuple, shape, mesh,
                         tp_axis: Optional[str]) -> tuple:
    """Resolve 'kv'/'heads_t'/'hd_t' to tp-or-None by divisibility, 'e2d'
    to (tp, data); drop any assignment whose axes do not divide the
    dim."""
    sizes = mesh_shape(mesh)
    out = []
    for dim, name in zip(shape, pspec):
        if name in ("kv", "heads_t", "hd_t"):
            name = tp_axis
        if name == "e2d":
            cand = tuple(a for a in (tp_axis, "data") if a in sizes)
            name = cand if len(cand) > 1 else (cand[0] if cand else None)
        if name is None:
            out.append(None)
            continue
        axes = name if isinstance(name, tuple) else (name,)
        size = math.prod(sizes.get(a, 1) for a in axes)
        out.append(name if size and dim % size == 0 else None)
    return tuple(out)


def _dedupe(pspec: tuple) -> tuple:
    """A mesh axis may appear at most once in a spec."""
    seen = set()
    out = []
    for name in pspec:
        axes = name if isinstance(name, tuple) else (name,)
        if name is not None and any(a in seen for a in axes):
            out.append(None)
        else:
            out.append(name)
            seen.update(a for a in axes if a)
    return tuple(out)


def param_axes(spec: FederationSpec, mesh, path: str, shape) -> tuple:
    """The resolved, deduplicated entries of one param of ``shape``: the
    reference's ``make_param_shardings`` for one leaf, without the
    NamedSharding."""
    tp_axis = spec.tp_axes[0] if spec.tp_axes else None
    ps = param_pspec(spec, path, len(tuple(shape)))
    return _dedupe(_resolve_conditional(ps, shape, mesh, tp_axis))


def _entry(axes: Axes):
    """One spec entry for ``axes``: None, the name, or the tuple (the
    reference's normalisation of one-axis tuples)."""
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def entry_axes(entry) -> Axes:
    """The axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(d) for d in leaf.shape)


def _map_with_path(fn, tree):
    """``fn("a/b/c", leaf)`` over a nested dict, the reference's path
    strings; the result has the tree's structure."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn("/".join(p), leaf)
                                    for p, leaf in zip(treedef, leaves)])


def param_placements(spec: FederationSpec, mesh, params) -> dict:
    """The axes of every leaf of ``params`` (tensors, fake tensors or
    anything with ``shape``): the reference's ``make_param_shardings``
    as a tree of entry tuples."""
    return _map_with_path(
        lambda p, leaf: param_axes(spec, mesh, p, _shape(leaf)), params)


def batch_shardings(spec: FederationSpec, mesh, batch) -> dict:
    """FL round batches, leaves (C, K, b, ...): C over the client axes,
    b over the fsdp axes."""
    ca = _entry(spec.client_axes)
    fa = spec.fsdp_axes[0] if spec.fsdp_axes else None

    def one(leaf):
        nd = len(_shape(leaf))
        return tuple(([ca, None, fa] + [None] * nd)[:nd])

    return _map_with_path(lambda p, leaf: one(leaf), batch)


def serve_batch_shardings(mesh, batch, *, data_axes=("data",)) -> dict:
    """Serving: the batch dim over every data-like axis of the mesh,
    whatever the spec; a batch of one row stays whole."""
    shape = mesh_shape(mesh)
    axes = _entry(tuple(a for a in ("pod",) + tuple(data_axes)
                        if a in shape))

    def one(leaf):
        s = _shape(leaf)
        if not s:
            return ()
        return ((None if s[0] == 1 else axes),) + (None,) * (len(s) - 1)

    return _map_with_path(lambda p, leaf: one(leaf), batch)


def cache_shardings(spec: FederationSpec, mesh, cache, *, batch_size: int,
                    seq_shard: bool = False) -> dict:
    """Decode caches: the batch dim over the data axes when the batch
    divides them; otherwise (B too small) the next (sequence or state)
    dim over ``model``. ``seq_shard`` also shards the sequence dim of a
    batch-sharded cache over ``model`` (from 1,024 entries). The
    KV-head dim is never sharded."""
    shape = mesh_shape(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in shape)
    dsize = math.prod(shape[a] for a in data_axes) or 1
    tp = spec.tp_axes[0] if spec.tp_axes else None
    tsize = shape.get(tp, 1) if tp else 1

    def one(p, leaf):
        s = _shape(leaf)
        dims = [None] * len(s)
        if not s or p.endswith(("t", "positions")):
            return tuple(dims)
        # stacked layer axis first, batch second for run caches
        bdim = 1 if p.startswith("runs/") or "enc_kv" in p else 0
        if len(s) > bdim and s[bdim] == batch_size \
                and batch_size % dsize == 0 and dsize > 1:
            dims[bdim] = _entry(data_axes)
            if seq_shard and len(s) > bdim + 1 and tp \
                    and s[bdim + 1] % tsize == 0 and s[bdim + 1] >= 1024:
                dims[bdim + 1] = tp
        elif len(s) > bdim + 1 and tp and s[bdim + 1] % tsize == 0:
            dims[bdim + 1] = tp
        return tuple(dims)

    return _map_with_path(one, cache)


# cache leaves whose dim after the batch is a time dim: the attention
# caches' sequence (GQA's K/V and their int8 scales, MLA's latent and
# rope key, the encoder's cross K/V) and the Mamba2 conv's taps. The
# Mamba2 ``ssm`` state's is its heads
SEQ_LEAVES = ("k", "v", "k_scale", "v_scale", "c_kv", "k_rope", "xk", "xv",
              "conv")
# of those, the ones the decode does not read cut: the Mamba2 conv's
# taps (its step reads all K − 1 of them)
UNREAD_SEQ_LEAVES = ("conv",)


def seq_cut_leaves(spec: FederationSpec, mesh, cache, *, batch_size: int,
                   seq_shard: bool = False) -> list:
    """The paths of the leaves of ``cache`` whose time dim
    ``cache_shardings`` cuts over the tensor axis (rows that do not split
    over the data axes, or ``seq_shard``): each rank holds a block of
    the time dim. The attention caches' blocks the decode reads as they
    are (``models.attention``: attention on the rank's time block,
    combined over the tensor axis); the Mamba2 conv's taps it does not
    (``unread_seq_cut``)."""
    tp = spec.tp_axes[0] if spec.tp_axes else None
    if tp is None or mesh_shape(mesh).get(tp, 1) == 1:
        return []
    leaves, treedef = tree_flatten(cache_shardings(
        spec, mesh, cache, batch_size=batch_size, seq_shard=seq_shard))
    out = []
    for path, entries in zip(treedef, leaves):
        bdim = 1 if path[0] in ("runs", "enc_kv") else 0
        if path[-1] in SEQ_LEAVES and len(entries) > bdim + 1 \
                and tp in entry_axes(entries[bdim + 1]):
            out.append("/".join(path))
    return out


def unread_seq_cut(spec: FederationSpec, mesh, cache, *, batch_size: int,
                   seq_shard: bool = False) -> list:
    """The leaves of ``seq_cut_leaves`` the decode cannot read cut: the
    Mamba2 conv's taps, which ``cache_shardings`` cuts where the tensor
    axis divides ``ssm_conv`` − 1 (ROADMAP A17)."""
    return [p for p in seq_cut_leaves(spec, mesh, cache,
                                      batch_size=batch_size,
                                      seq_shard=seq_shard)
            if p.rsplit("/", 1)[-1] in UNREAD_SEQ_LEAVES]


def local_shape(shape, axes: tuple, mesh) -> Tuple[int, ...]:
    """A rank's block shape of a whole ``shape`` under ``axes`` (one
    entry a dim); raises where a dim does not split evenly, as
    ``NamedSharding.shard_shape`` does."""
    sizes = mesh_shape(mesh)
    out = []
    for d, entry in zip(shape, axes):
        n = math.prod(sizes[a] for a in entry_axes(entry))
        if d % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {entry} ({n} ranks)")
        out.append(d // n)
    return tuple(out)


def local_block(x, axes: tuple, mesh, coords: Dict[str, int]):
    """This rank's block of the whole tensor ``x`` under ``axes`` (one
    entry a dim), for the rank at ``coords`` ({axis: index}): each dim
    cut into the product of its axes' sizes, blocked row-major in the
    entry's order. A view where the slices allow."""
    loc = local_shape(tuple(x.shape), axes, mesh)
    for dim, (entry, n) in enumerate(zip(axes, loc)):
        ax = entry_axes(entry)
        if ax:
            b = block_index(mesh, ax, coords)
            x = x.narrow(dim, b * n, n)
    return x


def shard_bytes(tree, placements, mesh) -> int:
    """A rank's bytes of ``tree`` under ``placements`` (the reference's
    ``dryrun._shard_bytes``)."""
    leaves, _ = tree_flatten(tree)
    axes, _ = tree_flatten(placements)
    total = 0
    for leaf, ax in zip(leaves, axes):
        n = math.prod(local_shape(_shape(leaf), ax, mesh))
        total += n * leaf.dtype.itemsize
    return total


def client_axes_on(spec: FederationSpec, mesh) -> Axes:
    """The spec's client axes present in the mesh with size > 1."""
    shape = mesh_shape(mesh)
    return tuple(a for a in spec.client_axes if shape.get(a, 1) > 1)


def norm_axes(spec: FederationSpec, mesh) -> Axes:
    """The live axes that split a client's params (fsdp, then tp): the
    axes a per-client global sum over a sharded tree is reduced over."""
    shape = mesh_shape(mesh)
    return tuple(a for a in spec.fsdp_axes + spec.tp_axes
                 if shape.get(a, 1) > 1 and a not in spec.client_axes)


def grad_sync_axes(spec: FederationSpec, mesh, placements) -> dict:
    """For each leaf of ``placements`` (``param_placements``' tree), the
    axes over which its gradient is a partial sum after a rank's
    backward pass: the live fsdp axes that do not shard it. The rows of
    a client's batch are split over them (``batch_shardings``), so a
    leaf they do not split sees each rank's rows only. A leaf an fsdp
    axis shards is gathered at use, and its gather's backward already
    sums over that axis (a reduce-scatter). Empty without fsdp."""
    shape = mesh_shape(mesh)
    fsdp = tuple(a for a in spec.fsdp_axes if shape.get(a, 1) > 1)

    def one(entries):
        used = {a for e in entries for a in entry_axes(e)}
        return tuple(a for a in fsdp if a not in used)

    return tree_unflatten(*_swap(tree_flatten(placements), one))


def counted_leaves(spec: FederationSpec, mesh, placements,
                   coords: Dict[str, int]) -> dict:
    """For each leaf, whether this rank (at ``coords``) counts its block
    in a per-client sum over the whole tree: a leaf replicated over a
    norm axis (``norm_axes``) is counted only on that axis's index 0,
    so after one sum over the norm axes every element counts once."""
    live = norm_axes(spec, mesh)

    def one(entries):
        used = {a for e in entries for a in entry_axes(e)}
        return all(int(coords[a]) == 0 for a in live if a not in used)

    return tree_unflatten(*_swap(tree_flatten(placements), one))


def _swap(flat, fn):
    leaves, treedef = flat
    return treedef, [fn(x) for x in leaves]


# ---------------------------------------------------------------------------
# Logical activation rules (installed by repro_torch.models.common.
# logical_rules)
# ---------------------------------------------------------------------------
class LogicalRules:
    """Maps logical activation axis names to mesh axes, for the rank at
    ``coords`` of ``mesh``. serve=True puts the batch over every
    data-like axis (a global serving batch); serve=False over the fsdp
    axes. ``seq_shard`` keeps the residual stream sharded over the
    tensor axis along the sequence (the reference's Megatron-SP
    analog); the port's models refuse it (ROADMAP A17).

    ``param_axes`` is the params tree's placement
    (``param_placements``): the models read it to gather a layer's fsdp
    dims at use. ``batch_axes`` are the live axes that split the rows
    (an MoE layer gathers its capacity counts and sums its aux loss
    over them); ``experts`` maps the expert dim (``model``, as the
    reference's default ``expert_2d=False`` has it). ``coords``
    defaults to the mesh's (``dist.coords``).

    ``batch_size``, under serving rules, is the global batch the steps
    serve: a batch of one row stays whole on every data rank
    (``serve_batch_shardings``), so then nothing splits the rows."""

    def __init__(self, spec: FederationSpec, mesh, *, serve: bool = False,
                 seq_shard: bool = False, coords=None, param_axes=None,
                 batch_size: Optional[int] = None):
        shape = mesh_shape(mesh)
        fsdp = spec.fsdp_axes[0] if spec.fsdp_axes else None
        tp = spec.tp_axes[0] if spec.tp_axes else None
        if serve and batch_size == 1:
            batch = None
        elif serve:
            batch = _entry(tuple(a for a in ("pod", "data") if a in shape))
        else:
            batch = fsdp
        ex = tp
        if spec.expert_2d:
            cand = tuple(a for a in (tp, "data") if a in shape)
            ex = cand if len(cand) > 1 else ex
        self.map = {"batch": batch, "seq": tp if seq_shard else None,
                    "embed": None, "heads": tp, "kv_heads": None,
                    "ffn": tp, "experts": ex, "vocab": tp}
        if seq_shard:
            self.map.update(heads=None, ffn=None, experts=tp, vocab=None)
        self.spec, self.mesh, self.serve = spec, mesh, serve
        self.batch_size = batch_size
        self.seq_shard = seq_shard
        self.tp = tp
        self.param_axes = param_axes
        if coords is None:
            from repro_torch.sharding import dist
            coords = dist.coords(mesh)
        self.coords = dict(coords)

    @property
    def fsdp_live(self) -> bool:
        """The spec shards params over an axis of size > 1."""
        return self.size(self.spec.fsdp_axes) > 1

    def size(self, axes) -> int:
        shape = mesh_shape(self.mesh)
        return math.prod(shape.get(a, 1) for a in entry_axes(axes))

    def index(self, axes) -> int:
        """This rank's block index over ``axes``."""
        ax = entry_axes(axes)
        return block_index(self.mesh, ax, self.coords) if ax else 0

    @property
    def batch_axes(self) -> Axes:
        """The axes of size > 1 that split the batch rows: the data axes
        under serving rules, the fsdp axes under training rules."""
        return tuple(a for a in entry_axes(self.map["batch"])
                     if self.size(a) > 1)

    def local_extent(self, name: Optional[str], n: int) -> int:
        """The local extent of a dim of global extent ``n`` named
        ``name`` (None: not sharded)."""
        k = self.size(self.map.get(name)) if name else 1
        return n // k if n % k == 0 else n

    def cache_rows(self, B: int) -> int:
        """The rank's rows of a decode cache of ``B`` rows
        (``cache_shardings``: over the data axes where B divides
        them)."""
        shape = mesh_shape(self.mesh)
        d = math.prod(shape[a] for a in ("pod", "data") if a in shape)
        return B // d if d > 1 and B % d == 0 else B

    def expected(self, names, dims) -> Tuple[Optional[int], ...]:
        return tuple(None if d is None else self.local_extent(n, d)
                     for n, d in zip(names, dims))
