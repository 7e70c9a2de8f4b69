"""The collective recorder and the sharding checks that read it.

Port of ``repro/sharding/hlo.py``. The reference inspects the compiled
HLO of a sharded round; the port has no HLO, so every collective wrapper
of ``repro_torch.sharding.dist`` appends one ``CollectiveOp`` to this
module's log, and the checks read the log:

  * ``assert_flat_buffer_sharded``: no collective moves a payload of
    the global (C, N) f32 slab's size — the slab never exists on one
    rank (the reference's ``flat_buffer_report``); with ``client_n``
    no local-step op of the flat round holds a client's whole N either
    (the round on the ranks' tensor-parallel blocks, ``core.sharded``);
  * ``assert_no_fullprec_delta_collective``: no collective over a
    client axis moves an f32 payload of a (C_loc, N_loc) per-client
    slab or more — compression and the robust ladder finish before any
    client-crossing sum (``fullprec_collective_report``). Collectives
    over the N-shard axes alone stay within one client coordinate (the
    pack/unpack seam) and are exempt, as in the reference;
  * ``assert_peak_below_global``: on the card, a rank's peak allocation
    stays below the bytes of the global slabs the unsharded step holds;
    ``assert_peak_within_local`` bounds it by the rank's own slabs.

  * ``assert_no_param_gather``: a ``cross_device`` tensor-parallel
    serve step moves no param (but the Mamba2 conv's small weights and
    the sLSTM's recurrent matrix, gathered once a layer) and
    crosses no data axis but with an MoE layer's per-expert counts
    (``moe_counts``): its ops are the roles ``tp_reduce``,
    ``kv_gather``, ``vocab``, the Mamba2 and xLSTM mixers' and the
    time-block decode's over ``model``; a
    training round's forward and backward ops likewise stay on
    ``model`` and move no param, and only ``fedavg`` and ``metrics``
    cross the client axes (``TRAIN_ROLES`` names every role).

Each record says whether its op ran in a backward pass (``backward``:
a gradient's collective or a remat recompute, ``backward_pass``).

``CollectiveOp.wire_bytes`` is ``repro/roofline.py``'s ring rule. The
fleet's cohort-materialization report waits for a meshed fleet loop
(ROADMAP A17, second half).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class CollectiveOp:
    kind: str                      # "all-reduce" | "all-gather"
    bytes: int                     # the result's bytes
    group_size: int
    axes: Tuple[str, ...] = ()     # mesh axes the group spans
    dtype: str = "float32"
    shape: Tuple[int, ...] = ()    # the result's shape
    op: str = "sum"                # reduce op of an all-reduce
    staged: bool = False           # went through pinned host memory
    role: str = ""                 # what the op is for (dist's roles)
    backward: bool = False         # ran in a backward pass (a gradient's
    #                                collective, or a remat recompute)

    @property
    def elems(self) -> int:
        return math.prod(self.shape)

    @property
    def wire_bytes(self) -> float:
        """Per-rank bytes on the wire, ring algorithm."""
        n = max(self.group_size, 2)
        if self.kind == "all-reduce":
            return 2 * (n - 1) / n * self.bytes
        if self.kind in ("all-gather", "reduce-scatter"):
            return (n - 1) / n * self.bytes
        if self.kind == "all-to-all":
            return (n - 1) / n * self.bytes
        return self.bytes  # collective-permute: one hop


LOG: List[CollectiveOp] = []
_PASS = threading.local()


@contextlib.contextmanager
def backward_pass():
    """Ops recorded inside (on this thread) ran in a backward pass."""
    depth = getattr(_PASS, "depth", 0)
    _PASS.depth = depth + 1
    try:
        yield
    finally:
        _PASS.depth = depth


def record(op: CollectiveOp) -> None:
    if getattr(_PASS, "depth", 0) and not op.backward:
        op = dataclasses.replace(op, backward=True)
    LOG.append(op)


def reset() -> None:
    LOG.clear()


def snapshot() -> List[CollectiveOp]:
    return list(LOG)


def summary(ops: Sequence[CollectiveOp], rounds: int = 1) -> Dict:
    """The ``static`` event's collective fields (the reference's
    ``profiling.static_telemetry``), per block and per round."""
    rounds = max(rounds, 1)
    nbytes = sum(c.bytes for c in ops)
    return {"collective_count": len(ops),
            "collectives_per_round": len(ops) / rounds,
            "collective_bytes": int(nbytes),
            "collective_bytes_per_round": nbytes / rounds,
            "collective_wire_bytes": float(sum(c.wire_bytes for c in ops)),
            "collective_kinds": sorted({c.kind for c in ops}),
            "collective_staged": sum(c.staged for c in ops)}


# the sharded flat round's own roles: a local step's gathers of the
# leaves its placement leaves whole over some N-shard axes
# (``flat_gather``) and its Δ-SGD ``norms`` sum; the tail's reshard of
# the round-end local params to contiguous columns (``flat_reshard``),
# the robust ladder's sums (``robust``), the packed client-axis sum and
# the η extrema (``flat_sum``, ``flat_min``), telemetry's loss gather
# (``metrics``) and the aggregate's gather over the N-shard axes
# (``flat_params``: the server's params, whole on every rank)
FLAT_STEP_ROLES = ("flat_gather", "norms")
FLAT_TAIL_ROLES = ("flat_reshard", "robust", "flat_sum", "flat_min",
                   "metrics", "flat_params")


def _per_client(c: CollectiveOp) -> int:
    """A record's elements a leading row: the clients' stacked dim of a
    local step's op; all of a vector's."""
    return c.elems // max(1, c.shape[0]) if len(c.shape) > 1 else c.elems


def flat_buffer_report(ops: Sequence[CollectiveOp], C: int, N: int, *,
                       client_n: Optional[int] = None) -> Dict:
    """Collectives whose f32 payload is the global (C, N) slab or more:
    {"full_shape": count, "sample": the first few}. With ``client_n``
    (a client's whole N, the layout's valid elements) also
    ``client_whole_n``: the local steps' f32 ops (every role but the
    tail's ``FLAT_TAIL_ROLES``) that hold ``client_n`` elements or more
    of one client (of a leading row: the clients' stacked dim). The
    aggregate's ``flat_params`` gather is the server's (N,) params,
    whole on every rank by design: with one client it has the slab's
    size, and it is not counted."""
    bad = [c for c in ops if c.dtype == "float32" and c.elems >= C * N
           and c.role != "flat_params"]
    rep = {"full_shape": len(bad), "sample": bad[:4]}
    if client_n is not None:
        whole = [c for c in ops if c.dtype == "float32"
                 and c.role not in FLAT_TAIL_ROLES
                 and _per_client(c) >= client_n]
        rep.update(client_whole_n=len(whole), client_sample=whole[:4])
    return rep


def assert_flat_buffer_sharded(ops: Sequence[CollectiveOp], C: int,
                               N: int, *,
                               client_n: Optional[int] = None) -> Dict:
    """No collective moves the global (C, N) slab; with ``client_n``,
    none of a local step holds a client's whole N (the tensor-parallel
    route: a model with no placement gathers its leaves whole)."""
    rep = flat_buffer_report(ops, C, N, client_n=client_n)
    if rep["full_shape"]:
        raise AssertionError(
            f"a collective moved the global ({C}, {N}) flat slab: {rep}")
    if rep.get("client_whole_n"):
        raise AssertionError(
            f"a local step's collective held a client's whole N "
            f"({client_n} elements): {rep['client_sample']}")
    return rep


def fullprec_collective_report(ops: Sequence[CollectiveOp], *,
                               max_elems: int,
                               client_axes: Sequence[str]) -> Dict:
    """Collectives that move >= ``max_elems`` f32 elements across
    client shards (over any of ``client_axes``): {"collectives": count
    of all, "fullprec": violations, "sample": the first few}."""
    ca = set(client_axes)
    bad = [c for c in ops if c.dtype == "float32"
           and c.elems >= max_elems and ca.intersection(c.axes)]
    return {"collectives": len(ops), "fullprec": len(bad),
            "sample": bad[:4]}


def assert_no_fullprec_delta_collective(ops: Sequence[CollectiveOp],
                                        C: int, N: int, *, mesh,
                                        federation,
                                        max_payload_elems: Optional[int]
                                        = None) -> Dict:
    """No full-precision (C_loc, N_loc) client delta crossed the client
    shard boundary. Needs C_loc >= 2 to tell a delta slab from the
    aggregated (N_loc,) mean; ``max_payload_elems`` tightens the bound
    (a robust round's largest legitimate client-crossing payload)."""
    from repro_torch.sharding.spec import axes_size
    client_axes, _ = federation.flat_axes(mesh)
    c_shards = axes_size(mesh, client_axes)
    n_shards = federation.flat_shards(mesh)
    c_loc, n_loc = C // max(1, c_shards), N // max(1, n_shards)
    if c_loc < 2:
        raise ValueError(
            "assert_no_fullprec_delta_collective needs >= 2 clients per "
            f"client shard to separate a delta slab from the aggregated "
            f"mean (C={C}, client shards={c_shards})")
    max_elems = c_loc * n_loc
    if max_payload_elems is not None:
        if max_payload_elems < 1:
            raise ValueError(
                f"max_payload_elems must be >= 1, got {max_payload_elems}")
        max_elems = min(max_elems, int(max_payload_elems) + 1)
    rep = fullprec_collective_report(ops, max_elems=max_elems,
                                     client_axes=client_axes)
    if rep["fullprec"]:
        raise AssertionError(
            f"full-precision client delta (>= ({c_loc}, {n_loc}) f32) "
            f"crossed the client shard boundary: {rep}")
    return rep


# the Mamba2 mixer's roles over the tensor axis: its column block's
# product gathered whole (``ssm_zx``), its conv's weights gathered at use
# (``ssm_conv``: the one param a cross_device step moves, 5 rows of
# conv_ch, because its channel blocks do not line up with the heads) and
# its gated norm's sum of squares (``ssm_norm``)
SSM_ROLES = ("ssm_zx", "ssm_conv", "ssm_norm")
# the xLSTM mixers': the mLSTM's ``w_up`` product gathered whole
# (``xlstm_up``), its four partial products with ``wq | wk | wv | w_if``
# summed in one (``xlstm_qkv``) and, where a decode cache holds the
# rank's heads, its norm's sum of squares (``xlstm_norm``); the sLSTM's
# ``w_x`` product gathered once a layer (``xlstm_wx``), its recurrent
# matrix ``r`` gathered once a layer before the time loop (``xlstm_r``:
# the one param besides the Mamba2 conv's that a cross_device step
# moves, 4·D·hd values, so that the loop makes no collective), a decode
# step's partial recurrent product summed with the input's block
# (``xlstm_rec``), and a decode cache cut over its units gathered once
# a step (``xlstm_state``)
XLSTM_ROLES = ("xlstm_up", "xlstm_qkv", "xlstm_norm", "xlstm_wx", "xlstm_r",
               "xlstm_rec", "xlstm_state")
# the decode on a cache whose time dim is cut over ``model`` (rows that
# do not split over the data axes): every query head gathered
# (``seq_q``), the blocks' maxima (``seq_max``) and their rescaled sums
# and outputs (``seq_sum``)
SEQ_ROLES = ("seq_q", "seq_max", "seq_sum")
# the roles a tensor-parallel serve step's collectives may have on a
# cross_device mesh: none moves a param but the Mamba2 conv's weights
# and the sLSTM's r
SERVE_ROLES = ("tp_reduce", "kv_gather", "vocab", "moe_counts") \
    + SSM_ROLES + XLSTM_ROLES + SEQ_ROLES
# the roles that cross the batch axes to make an MoE layer's capacity
# order (``moe_counts``: each rank's per-expert counts) and aux loss
# (``moe_aux``: Σprobs and the routed counts) global: they move (E,)
# vectors, no param
BATCH_ROLES = ("moe_counts", "moe_aux")
# the roles of a tensor-parallel training round's collectives: forward
# partial sums (``tp_reduce``; ``vocab`` for the vocab-parallel
# embedding and cross-entropy; ``loss`` for its mean over rows split on
# an fsdp axis), the backward's sums of partial gradients (``tp_grad``),
# the fsdp gather at use and its reduce-scatter (``fsdp_gather``,
# ``fsdp_scatter``), the gradient sums over the fsdp axes of leaves they
# do not shard (``grad_sync``), Δ-SGD's norm sums (``norms``), an MoE
# layer's ``moe_counts`` and ``moe_aux`` over the rows' fsdp axes, the
# MTP projection's gather (``mtp_gather``), the Mamba2 mixer's
# (``SSM_ROLES``, each with one op in the backward: the gathers'
# reduce-scatters, the norm's sum), the xLSTM mixers' (``XLSTM_TRAIN``:
# the mLSTM's gather, with its reduce-scatter in the backward, and its
# sum; the sLSTM's two gathers, whose backward keeps the rank's block
# with no collective), and over the client axes the FedAvg sum
# (``fedavg``) and the metrics' gather (``metrics``)
XLSTM_TRAIN = ("xlstm_up", "xlstm_qkv", "xlstm_wx", "xlstm_r")
TRAIN_ROLES = ("tp_reduce", "tp_grad", "vocab", "loss", "fsdp_gather",
               "fsdp_scatter", "grad_sync", "norms", "moe_counts",
               "moe_aux", "mtp_gather") + SSM_ROLES + XLSTM_TRAIN \
    + ("fedavg", "metrics")
# the training roles that stay inside a model replica on a cross_device
# mesh (none moves a param but the Mamba2 conv's weights and the sLSTM's
# r), and the two that cross the client axes
TRAIN_REPLICA_ROLES = ("tp_reduce", "tp_grad", "vocab", "norms",
                       "mtp_gather") + SSM_ROLES + XLSTM_TRAIN
CLIENT_ROLES = ("fedavg", "metrics")


def assert_no_param_gather(ops: Sequence[CollectiveOp], spec, *,
                           train: bool = False) -> Dict:
    """In a ``cross_device`` step no collective moves a param and a
    model replica lives within one ``model`` group. A serve step's ops
    are partial-sum reduces, KV gathers and vocab ops (none an fsdp
    gather), none over the data axes (the client axes of ``spec``, a
    FederationSpec) but an MoE layer's ``moe_counts``, which makes the
    capacity order of the rows the data axes split global. A training
    round's (``train=True``) forward and backward ops are partial sums
    of activations or gradients, the MTP gather and Δ-SGD's norm sums
    over ``model``; only ``fedavg`` and ``metrics`` cross the client
    axes."""
    if spec.fsdp_axes:
        raise ValueError("assert_no_param_gather checks a cross_device "
                         f"step; this spec shards params over "
                         f"{spec.fsdp_axes}")
    data = set(spec.client_axes) | {"pod", "data"}
    if train:
        bad = [c for c in ops
               if (c.role in CLIENT_ROLES) != bool(data.intersection(c.axes))
               or c.role not in TRAIN_REPLICA_ROLES + CLIENT_ROLES]
        roles = TRAIN_REPLICA_ROLES + CLIENT_ROLES
    else:
        bad = [c for c in ops if c.role not in SERVE_ROLES
               or (c.role not in BATCH_ROLES
                   and data.intersection(c.axes))]
        roles = SERVE_ROLES
    if bad:
        raise AssertionError(f"{len(bad)} of {len(ops)} collectives move a "
                             f"param or cross the data axes: {bad[:4]}")
    return {"collectives": len(ops),
            "roles": {r: sum(c.role == r for c in ops) for r in roles}}


def global_slab_bytes(C: int, N: int, slabs: int = 3) -> int:
    """Bytes of the ``slabs`` (C, N) f32 slabs the unsharded flat step
    holds (params, gradients, previous gradients)."""
    return slabs * C * N * 4


def assert_peak_below_global(peak_bytes: int, C: int, N: int,
                             slabs: int = 3) -> Dict:
    bound = global_slab_bytes(C, N, slabs)
    if peak_bytes >= bound:
        raise AssertionError(
            f"rank peak allocation {peak_bytes} B is not below the "
            f"{slabs} global ({C}, {N}) slabs' {bound} B")
    return {"peak_bytes": int(peak_bytes), "global_bytes": bound}


def assert_peak_within_local(peak_bytes: int, C_loc: int, N_loc: int,
                             slabs: int) -> Dict:
    """A rank's peak allocation is at most ``slabs`` of its own
    (C_loc, N_loc) f32 slabs: the caller counts the slabs its step
    holds live, plus its slack. A rank that kept a full-width (C_loc,
    N) row block, or any other slab beyond its count, fails."""
    bound = slabs * C_loc * N_loc * 4
    if peak_bytes > bound:
        raise AssertionError(
            f"rank peak allocation {peak_bytes} B exceeds {slabs} local "
            f"({C_loc}, {N_loc}) slabs' {bound} B")
    return {"peak_bytes": int(peak_bytes), "local_bound_bytes": bound,
            "local_slabs": peak_bytes / (C_loc * N_loc * 4)}
