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
None, an axis name, or a tuple of names. Applying them to tensors
(``DTensor`` or FSDP/TP on the card), the batch and cache placements and
the logical activation rules come with the second half of ROADMAP A17.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

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
