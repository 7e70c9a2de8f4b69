"""The port's process-group runtime: one process per rank.

The counterpart of the reference's ``shard_map`` on a device mesh is
PyTorch's SPMD idiom: every rank runs the same Python on its own local
tensors, and each ``jax.lax.psum``/``pmin`` of the reference becomes an
``all_reduce`` over the process group of the mesh dimensions it names.

  * ``init(rank, world, rendezvous, device)`` joins the process group.
    Backend: NCCL when every rank has its own card; when the ranks
    outnumber the cards, gloo with every rank on ``cuda:0`` (NCCL
    refuses two ranks on one GPU); gloo on the CPU. The choice is made
    from ``torch.cuda.device_count()`` and printed, never by catching a
    failure.
  * ``make_mesh(shape, axes)`` builds the ``DeviceMesh`` through
    ``init_device_mesh`` (the reference's ``launch/mesh.py``
    ``make_debug_mesh``), plus one process group for every set of its
    dimensions, so a collective over the tuple ("data", "model") is one
    call.
  * ``all_reduce(x, mesh, axes, op)`` (sum or min),
    ``all_gather(x, mesh, axes, dim)`` and ``all_to_all(send,
    send_counts, recv_counts, mesh, axes)`` (segments of a 1-D buffer,
    in block order) are the collectives. Each records a
    ``CollectiveOp`` in ``repro_torch.sharding.hlo``. Over no axes, or
    axes of size 1, they are the identity and record nothing. gloo has
    no all-gather or all-to-all of CUDA tensors: under gloo those ops
    are staged through pinned host buffers (for the gather the blocks,
    then a single copy to the card, ordered there) and recorded as
    staged. NCCL never stages.
  * ``spawn(fn, world, args, device)`` runs ``fn(rank, world, *args)``
    in ``world`` fresh processes on a ``file://`` rendezvous, so
    parallel test workers never share a port.
  * ``AbstractMesh(shape, coords)`` is a mesh with no process group:
    the ``{axis: size}`` shape and this rank's coordinates. Its
    collectives record the op and return a tensor of the result's shape
    (``x`` for a reduce, an empty tensor for a gather), so a program
    written for ranks runs on fake tensors for one rank of a mesh no
    machine here has (the dry run).

Every collective takes a ``role``, kept in its record: the serving
path's are ``tp_reduce`` (a row-parallel product's partial sums),
``kv_gather`` (KV heads for the cache), ``vocab`` (the vocab-parallel
embedding and the logits), ``fsdp_gather`` (a layer's fsdp dims at
use), ``moe_counts`` (an MoE layer's per-expert counts over the
batch axes), the Mamba2 mixer's ``hlo.SSM_ROLES``, the xLSTM mixers'
``hlo.XLSTM_ROLES`` and the time-block decode's ``hlo.SEQ_ROLES``;
training's are listed in ``hlo.TRAIN_ROLES``.

Training differentiates through collectives: ``copy_to`` (identity
forward, sum backward: Megatron's f), ``reduce_from`` (sum forward,
identity backward: g), ``gather_from`` (all-gather forward,
reduce-scatter backward; gloo has no reduce-scatter, so
``reduce_scatter`` is an all-reduce of a copy and a slice, recorded as
one op), ``gather_split`` (all-gather forward, this rank's block of the
gradient backward: Megatron's split, for a gather whose result feeds
replicated work), ``max_over`` and ``stack_over`` (every rank's tensor
stacked; both without gradient). Each is a
``torch.autograd.Function`` with an explicit ``vmap`` rule, so under
``torch.func.vmap(grad)`` one collective serves the rank's stacked
clients; none writes its input.
"""
from __future__ import annotations

import itertools
import math
import os
import shutil
import tempfile
from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding import hlo
from repro_torch.sharding.spec import axes_size, block_index, mesh_shape


class Runtime(NamedTuple):
    rank: int
    world: int
    backend: str
    device: torch.device


_RUNTIME: Dict[str, Runtime] = {}
# id(mesh) -> (mesh, {axes: (group, group ranks)})
_GROUPS: Dict[int, tuple] = {}


def choose_backend(world: int, device) -> Tuple[str, torch.device, str]:
    """(backend, this rank's device, why) for ``world`` ranks asking for
    ``device`` ("cuda" or "cpu"). A rank's device index is filled in by
    ``init``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo", torch.device("cpu"), "CPU ranks"
    cards = torch.cuda.device_count()
    if cards >= world:
        return "nccl", device, f"{cards} cards for {world} ranks"
    return ("gloo", torch.device("cuda", 0),
            f"{world} ranks on {cards} card(s): every rank on cuda:0")


def init(rank: int, world: int, rendezvous: str, device="cuda", *,
         verbose: bool = True) -> Runtime:
    """Join the process group as ``rank`` of ``world``; ``rendezvous``
    is an ``init_method`` URL (``file://...`` or ``tcp://host:port``)."""
    backend, dev, why = choose_backend(world, device)
    if backend == "nccl":
        dev = torch.device("cuda", rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=rendezvous, rank=rank,
                            world_size=world)
    rt = Runtime(rank, world, backend, dev)
    _RUNTIME["current"] = rt
    if verbose:
        print(f"rank {rank}/{world}: backend {backend} ({why}), device "
              f"{dev}", flush=True)
    return rt


def runtime() -> Runtime:
    try:
        return _RUNTIME["current"]
    except KeyError:
        raise RuntimeError("no process group: call "
                           "repro_torch.sharding.dist.init first") from None


def shutdown() -> None:
    _GROUPS.clear()
    _RUNTIME.pop("current", None)
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_coords(sizes: Sequence[int], rank: int) -> Tuple[int, ...]:
    """The mesh coordinate of ``rank`` (ranks laid out row-major)."""
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = None):
    """A ``DeviceMesh`` of ``shape`` with dimensions named ``axes`` over
    the current process group, ranks row-major. ``device_type`` defaults
    to the backend's ("cuda" under NCCL, "cpu" under gloo, whose groups
    carry staged ops on the host)."""
    from torch.distributed.device_mesh import init_device_mesh
    rt = runtime()
    if device_type is None:
        device_type = "cuda" if rt.backend == "nccl" else "cpu"
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=axes)
    mine = _rank_coords(shape, rt.rank)
    groups = {}
    # one group per set of dimensions, every rank creating every group
    # in the same order (new_group is collective)
    for n in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), n):
            members = {}
            for r in range(rt.world):
                c = _rank_coords(shape, r)
                key = tuple(c[i] for i in range(len(axes)) if i not in sub)
                members.setdefault(key, []).append(r)
            own = tuple(mine[i] for i in range(len(axes)) if i not in sub)
            for key, ranks in members.items():
                if len(ranks) == rt.world:
                    g = dist.group.WORLD
                elif len(ranks) > 1:
                    g = dist.new_group(ranks)
                else:
                    g = None
                if key == own:
                    groups[tuple(axes[i] for i in sub)] = (g, ranks)
    _GROUPS[id(mesh)] = (mesh, groups)
    return mesh


class AbstractMesh:
    """A mesh of ``shape`` ({axis: size}, in dimension order) seen from
    the rank at ``coords`` ({axis: index}, every axis at 0 by default),
    with no process group behind it."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int] = None):
        self.shape = {a: int(n) for a, n in shape.items()}
        self.coords = {a: 0 for a in self.shape}
        self.coords.update(coords or {})
        for a, i in self.coords.items():
            if not 0 <= i < self.shape[a]:
                raise ValueError(f"coordinate {a}={i} is off the mesh "
                                 f"{self.shape}")

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return f"AbstractMesh({self.shape}, coords={self.coords})"


def coords(mesh) -> Dict[str, int]:
    """This rank's ``{axis: index}`` on ``mesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.coords)
    c = mesh.get_coordinate()
    return dict(zip(mesh.mesh_dim_names, c))


def _group(mesh, axes: Sequence[str]):
    """(group, ranks) of ``axes`` (in the mesh's dimension order)."""
    try:
        _, groups = _GROUPS[id(mesh)]
    except KeyError:
        raise ValueError("this mesh was not built by "
                         "repro_torch.sharding.dist.make_mesh") from None
    names = mesh.mesh_dim_names
    key = tuple(a for a in names if a in axes)
    return groups[key]


def _live(mesh, axes) -> Tuple[str, ...]:
    """The axes of size > 1 (a collective over the others is a no-op)."""
    shape = mesh_shape(mesh)
    return tuple(a for a in axes if shape[a] > 1)


def _dtype(x: torch.Tensor) -> str:
    return str(x.dtype).replace("torch.", "")


def all_reduce(x: torch.Tensor, mesh, axes: Sequence[str],
               op: str = "sum", *, role: str = "") -> torch.Tensor:
    """Sum, min or max of ``x`` over the ranks spanned by ``axes``, in
    place; returns ``x``."""
    axes = _live(mesh, axes)
    if not axes:
        return x
    if isinstance(mesh, AbstractMesh):
        n = axes_size(mesh, axes)
    else:
        group, ranks = _group(mesh, axes)
        n = len(ranks)
        rop = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(x, op=rop, group=group)
    hlo.record(hlo.CollectiveOp(
        "all-reduce", x.numel() * x.element_size(), n, axes, _dtype(x),
        tuple(x.shape), op, False, role))
    return x


def reduce_scatter(x: torch.Tensor, mesh, axes: Sequence[str],
                   dim: int = 0, *, role: str = "") -> torch.Tensor:
    """The sum of ``x`` over the ranks spanned by ``axes``, of which this
    rank keeps its block along ``dim`` (blocked row-major in the order
    of ``axes``, as ``all_gather`` concatenates them). gloo has no
    reduce-scatter: it is an all-reduce of a copy and a slice, recorded
    as one ``reduce-scatter`` of ``x``'s bytes."""
    axes = _live(mesh, axes)
    if not axes:
        return x
    n = axes_size(mesh, axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {axes} ({n} ranks)")
    full = x.clone()
    if not isinstance(mesh, AbstractMesh):
        group, _ = _group(mesh, axes)
        dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
    hlo.record(hlo.CollectiveOp(
        "reduce-scatter", x.numel() * x.element_size(), n, axes, _dtype(x),
        tuple(x.shape), "sum", False, role))
    m = x.shape[dim] // n
    b = block_index(mesh, axes, coords(mesh))
    return full.narrow(dim, b * m, m).contiguous()


def all_gather(x: torch.Tensor, mesh, axes: Sequence[str],
               dim: int = 0, *, role: str = "") -> torch.Tensor:
    """The blocks ``x`` of every rank spanned by ``axes``, concatenated
    along ``dim`` in the blocked row-major order of ``axes`` (the order
    ``repro_torch.core.flat.local_slab`` cuts them in)."""
    axes = _live(mesh, axes)
    if not axes:
        return x
    if isinstance(mesh, AbstractMesh):
        n = axes_size(mesh, axes)
        shape = list(x.shape)
        shape[dim] *= n
        out = x.new_empty(shape)
        hlo.record(hlo.CollectiveOp(
            "all-gather", out.numel() * out.element_size(), n, axes,
            _dtype(x), tuple(out.shape), "", False, role))
        return out
    group, ranks = _group(mesh, axes)
    rt = runtime()
    staged = rt.backend == "gloo" and x.device.type == "cuda"
    src = x.contiguous()
    if staged:
        # one pinned (ranks, *block) buffer: gloo writes each block into
        # it, one host-to-device copy takes it to the card, and the
        # blocks are put in order there
        src = torch.empty(src.shape, dtype=src.dtype,
                          pin_memory=True).copy_(src)
        buf = torch.empty((len(ranks),) + tuple(src.shape), dtype=src.dtype,
                          pin_memory=True)
        dist.all_gather(list(buf.unbind(0)), src, group=group)
        parts = buf.to(x.device, non_blocking=True).unbind(0)
    else:
        parts = [torch.empty_like(src) for _ in ranks]
        dist.all_gather(parts, src, group=group)
    # group ranks -> blocks in the order of ``axes``
    block = _block_of(mesh, axes)
    order = sorted(range(len(ranks)), key=lambda i: block(ranks[i]))
    out = torch.cat([parts[i] for i in order], dim=dim)
    hlo.record(hlo.CollectiveOp(
        "all-gather", out.numel() * out.element_size(), len(ranks), axes,
        _dtype(x), tuple(out.shape), "", staged, role))
    return out


def _block_of(mesh, axes) -> callable:
    """rank -> its block index over ``axes`` (blocked row-major in the
    order of ``axes``)."""
    shape = mesh_shape(mesh)
    names = list(mesh.mesh_dim_names)
    sizes = [shape[a] for a in names]

    def block(r):
        c = _rank_coords(sizes, r)
        b = 0
        for a in axes:
            b = b * shape[a] + c[names.index(a)]
        return b
    return block


def all_to_all(send: torch.Tensor, send_counts: Sequence[int],
               recv_counts: Sequence[int], mesh, axes: Sequence[str], *,
               role: str = "") -> torch.Tensor:
    """Every rank spanned by ``axes`` sends each of the others a segment
    of the 1-D ``send``: its segments lie in block order (blocked
    row-major in the order of ``axes``, as ``all_gather`` orders
    blocks), ``send_counts[b]`` elements for the rank of block b.
    Returns the 1-D concatenation, in block order, of the segments this
    rank received (``recv_counts[b]`` from block b). gloo has no
    all-to-all of CUDA tensors: under gloo the exchange is staged
    through pinned host buffers (one copy each way) and recorded as
    staged. On an ``AbstractMesh`` it records the op and returns an
    empty tensor of the received length."""
    axes = _live(mesh, axes)
    n_out = int(sum(recv_counts))
    if not axes:
        return send
    if isinstance(mesh, AbstractMesh):
        out = send.new_empty((n_out,))
        hlo.record(hlo.CollectiveOp(
            "all-to-all", out.numel() * out.element_size(),
            axes_size(mesh, axes), axes, _dtype(send), tuple(out.shape),
            "", False, role))
        return out
    group, ranks = _group(mesh, axes)
    block = _block_of(mesh, axes)
    blocks = [block(r) for r in ranks]          # group order -> block
    ins = [int(send_counts[b]) for b in blocks]
    outs = [int(recv_counts[b]) for b in blocks]
    src = send.contiguous()
    if blocks != sorted(blocks):
        # segments in the group's rank order
        starts = [0]
        for c in send_counts:
            starts.append(starts[-1] + int(c))
        src = torch.cat([src[starts[b]:starts[b + 1]] for b in blocks])
    rt = runtime()
    staged = rt.backend == "gloo" and send.device.type == "cuda"
    if staged:
        host = torch.empty(src.shape, dtype=src.dtype,
                           pin_memory=True).copy_(src)
        buf = torch.empty((n_out,), dtype=src.dtype, pin_memory=True)
        dist.all_to_all_single(buf, host, outs, ins, group=group)
        out = buf.to(send.device, non_blocking=True)
    else:
        out = src.new_empty((n_out,))
        dist.all_to_all_single(out, src, outs, ins, group=group)
    if blocks != sorted(blocks):
        starts = [0]
        for c in outs:
            starts.append(starts[-1] + c)
        seg = {b: out[starts[i]:starts[i + 1]] for i, b in enumerate(blocks)}
        out = torch.cat([seg[b] for b in sorted(blocks)])
    hlo.record(hlo.CollectiveOp(
        "all-to-all", out.numel() * out.element_size(), len(ranks), axes,
        _dtype(send), tuple(out.shape), "", staged, role))
    return out


# ---------------------------------------------------------------------------
# Collectives that differentiate and batch (Megatron's f and g)
# ---------------------------------------------------------------------------
# Each is a ``torch.autograd.Function`` with an explicit ``vmap`` rule:
# under ``torch.func.vmap`` the rule runs ONE collective on the whole
# stacked (C_loc, ...) tensor, which equals C_loc per-client
# collectives (a process-group call cannot be traced by functorch).
# A backward calls the dual operator's ``apply``, so gradients batch
# too, and its ops are recorded as backward (``hlo.backward_pass``).
# The forward never writes its input: a reduce works on a copy.


def _front(x, d):
    """``x`` with its vmap batch dim ``d`` moved to the front."""
    return x if d is None or d == 0 else x.movedim(d, 0)


def _shift(dim: int) -> int:
    """A per-sample dim as a dim of the stacked tensor."""
    return dim + 1 if dim >= 0 else dim


class _Sum(torch.autograd.Function):
    """Sum over ``axes`` forward, identity backward (Megatron's g)."""

    @staticmethod
    def forward(x, mesh, axes, role, bwd_role):
        return all_reduce(x.clone(), mesh, axes, role=role)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.spec = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axes, role, bwd_role):
        return _Sum.apply(_front(x, in_dims[0]), mesh, axes, role,
                          bwd_role), 0


class _Copy(torch.autograd.Function):
    """Identity forward, sum over ``axes`` backward (Megatron's f)."""

    @staticmethod
    def forward(x, mesh, axes, role):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.spec = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        mesh, axes, role = ctx.spec
        with hlo.backward_pass():
            return _Sum.apply(g, mesh, axes, role, role), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axes, role):
        return _Copy.apply(_front(x, in_dims[0]), mesh, axes, role), 0


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward the reduce-scatter
    (the sum over ``axes`` of the incoming gradient, this rank's
    block kept)."""

    @staticmethod
    def forward(x, mesh, axes, dim, role, bwd_role):
        return all_gather(x, mesh, axes, dim, role=role)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.spec = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, role, bwd_role = ctx.spec
        with hlo.backward_pass():
            return (_Scatter.apply(g, mesh, axes, dim, bwd_role, role),
                    None, None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, x, mesh, axes, dim, role, bwd_role):
        d = in_dims[0]
        return _Gather.apply(_front(x, d), mesh, axes,
                             dim if d is None else _shift(dim), role,
                             bwd_role), 0 if d is not None else None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter along ``dim`` forward; all-gather backward."""

    @staticmethod
    def forward(x, mesh, axes, dim, role, bwd_role):
        return reduce_scatter(x, mesh, axes, dim, role=role)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.spec = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, role, bwd_role = ctx.spec
        with hlo.backward_pass():
            return (_Gather.apply(g, mesh, axes, dim, bwd_role, role),
                    None, None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, x, mesh, axes, dim, role, bwd_role):
        d = in_dims[0]
        return _Scatter.apply(_front(x, d), mesh, axes,
                              dim if d is None else _shift(dim), role,
                              bwd_role), 0 if d is not None else None


class _Max(torch.autograd.Function):
    """Max over ``axes``; no gradient (a softmax's shift)."""

    @staticmethod
    def forward(x, mesh, axes, role):
        return all_reduce(x.detach().clone(), mesh, axes, "max", role=role)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axes, role):
        return _Max.apply(_front(x, in_dims[0]), mesh, axes, role), 0


class _GatherSplit(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward keeps this rank's
    block of the incoming gradient (Megatron's split), with no
    collective: for a gather whose result feeds work replicated over
    ``axes``, whose gradient is already whole on every rank."""

    @staticmethod
    def forward(x, mesh, axes, dim, role):
        return all_gather(x, mesh, axes, dim, role=role)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.spec = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, _ = ctx.spec
        n = axes_size(mesh, _live(mesh, axes))
        m = g.shape[dim] // n
        b = block_index(mesh, _live(mesh, axes), coords(mesh))
        return g.narrow(dim, b * m, m), None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axes, dim, role):
        d = in_dims[0]
        return _GatherSplit.apply(_front(x, d), mesh, axes,
                                  dim if d is None else _shift(dim),
                                  role), 0 if d is not None else None


class _Stack(torch.autograd.Function):
    """Every rank's ``x`` over ``axes``, stacked on a new leading dim in
    block order; no gradient (integer counts)."""

    @staticmethod
    def forward(x, mesh, axes, role):
        return all_gather(x.detach().unsqueeze(0), mesh, axes, 0,
                          role=role)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axes, role):
        x = _front(x, in_dims[0])
        if in_dims[0] is None:
            return _Stack.apply(x, mesh, axes, role), None
        out = all_gather(x.detach().unsqueeze(1), mesh, axes, 1, role=role)
        return out, 0


def copy_to(x: torch.Tensor, mesh, axes: Sequence[str], *,
            role: str = "tp_grad") -> torch.Tensor:
    """Identity forward; backward sums the gradient over ``axes``
    (recorded with ``role``): where a tensor replicated over ``axes``
    enters per-rank work whose gradients are partial."""
    return _Copy.apply(x, mesh, tuple(axes), role)


def reduce_from(x: torch.Tensor, mesh, axes: Sequence[str], *,
                role: str = "tp_reduce") -> torch.Tensor:
    """The sum of ``x``'s partial sums over ``axes`` (a new tensor);
    identity backward."""
    return _Sum.apply(x, mesh, tuple(axes), role, role)


def gather_from(x: torch.Tensor, mesh, axes: Sequence[str], dim: int, *,
                role: str = "fsdp_gather",
                bwd_role: str = "fsdp_scatter") -> torch.Tensor:
    """The blocks of ``x`` over ``axes`` concatenated along ``dim``;
    backward reduce-scatters the gradient (``bwd_role``)."""
    return _Gather.apply(x, mesh, tuple(axes), dim, role, bwd_role)


def gather_split(x: torch.Tensor, mesh, axes: Sequence[str], dim: int, *,
                 role: str = "mtp_gather") -> torch.Tensor:
    """The blocks of ``x`` over ``axes`` concatenated along ``dim``;
    backward takes this rank's block of the gradient (no collective)."""
    return _GatherSplit.apply(x, mesh, tuple(axes), dim, role)


def stack_over(x: torch.Tensor, mesh, axes: Sequence[str], *,
               role: str = "moe_counts") -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` over ``axes`` in block order,
    detached; ``x`` itself as one block over axes of size 1."""
    if not _live(mesh, axes):
        return x.detach().unsqueeze(0)
    return _Stack.apply(x, mesh, tuple(axes), role)


def max_over(x: torch.Tensor, mesh, axes: Sequence[str], *,
             role: str = "vocab") -> torch.Tensor:
    """The max of ``x`` over ``axes``, detached."""
    return _Max.apply(x, mesh, tuple(axes), role)


def _entry(rank, fn, world, rendezvous, device, threads, args):
    if threads:
        torch.set_num_threads(threads)
    init(rank, world, rendezvous, device)
    try:
        fn(rank, world, *args)
    finally:
        shutdown()


def spawn(fn, world: int, args: tuple = (), device="cuda", *,
          threads: int = 0) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes (start
    method "spawn"), each joined to one process group through a fresh
    ``file://`` rendezvous; ``threads`` > 0 sets each rank's torch
    threads. Waits for every rank; if one raises, the others are
    stopped and the error is raised here. ``fn`` must be importable by
    module path (a module-level function)."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="repro_torch_rdv_")
    try:
        rendezvous = "file://" + os.path.join(tmp, "store")
        mp.start_processes(_entry, args=(fn, world, rendezvous, str(device),
                                         threads, tuple(args)),
                           nprocs=world, join=True, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
