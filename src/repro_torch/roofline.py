"""Roofline analysis from counted work: the dry run's three terms per
(arch × shape × mesh), in seconds, for one rank of an H100 mesh.

    compute    = FLOPs / peak                  peak = 989e12 bf16 dense
    memory     = HBM bytes / hbm_bw            hbm  = 3.35e12 B/s
    collective = Σ_ops wire bytes / link_bw    450e9 B/s a direction on
                                               NVLink within a host of
                                               8, 50e9 B/s a GPU across
                                               hosts (400 Gb/s NDR)

The constants are the H100 SXM5 80GB (700 W) data sheet's and
InfiniBand NDR's line rate, not measurements. Port of
``repro/roofline.py``: the reference reads FLOPs and bytes from XLA's
``compiled.cost_analysis()``; the port counts them while a step runs on
fake tensors (``count_work``): FLOPs from
``torch.utils.flop_counter.FlopCounterMode``, HBM bytes as every op's
input and output bytes (the counterpart of XLA's ``bytes accessed``,
which also counts operands and results; views move nothing and are not
counted), and the collectives from the recorder
(``repro_torch.sharding.hlo``) with the ring ``wire_bytes``. Eager
mode runs every layer, so the dry run's counts are the full depth's;
``launch/perf.py`` counts its variants at the reference's two
calibration depths and takes the full depth from them with
``extrapolate``, as the reference does.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.sharding import hlo

PEAK_FLOPS = 989e12      # bf16 dense, H100 SXM5 (700 W) data sheet
HBM_BW = 3.35e12         # bytes/s, HBM3
NVLINK_BW = 450e9        # bytes/s a direction within a host of 8
NET_BW = 50e9            # bytes/s a GPU across hosts (400 Gb/s NDR)
# mesh axes whose groups stay inside one host
HOST_AXES = ("model",)


def link_bw(op: hlo.CollectiveOp) -> float:
    """The bandwidth of the link ``op``'s group crosses."""
    return NVLINK_BW if set(op.axes) <= set(HOST_AXES) else NET_BW


@dataclass
class Roofline:
    flops: float                  # per-device counted flops
    hbm_bytes: float
    coll_bytes: float             # summed wire bytes (per device)
    chips: int
    coll_by_kind: Dict[str, float] = field(default_factory=dict)
    per_device: bool = True       # the counts are one rank's
    coll_seconds: float = None    # Σ wire bytes / link bandwidth

    @property
    def t_compute(self) -> float:
        f = self.flops if self.per_device else self.flops / self.chips
        return f / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        b = self.hbm_bytes if self.per_device else self.hbm_bytes / self.chips
        return b / HBM_BW

    @property
    def t_collective(self) -> float:
        if self.coll_seconds is not None:
            return self.coll_seconds
        return self.coll_bytes / NET_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def summary(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "coll_by_kind": self.coll_by_kind,
        }


# aten ops that allocate and move no bytes (views, and ops outside aten
# such as ``prim.device``, are not counted either)
_NO_TRAFFIC = ("aten::empty", "aten::new_empty", "aten::empty_like",
               "aten::empty_strided", "aten::new_empty_strided")


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(t) for t in tree)
    return 0


class _ByteCounter(TorchDispatchMode):
    """Sums each op's tensor input and output bytes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "aten" and not func.is_view \
                and func._schema.name not in _NO_TRAFFIC:
            self.bytes += (_nbytes(list(args)) + _nbytes(
                list((kwargs or {}).values())) + _nbytes(out))
        return out


@dataclass
class Work:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: List[hlo.CollectiveOp] = field(default_factory=list)


@contextlib.contextmanager
def count_work():
    """Counts the FLOPs, HBM bytes and collectives of the ops run inside
    (on fake tensors or real ones); yields a ``Work`` filled in on
    exit."""
    work = Work()
    start = len(hlo.LOG)
    flops = FlopCounterMode(display=False)
    nbytes = _ByteCounter()
    with flops, nbytes:
        yield work
    work.flops = float(flops.get_total_flops())
    work.hbm_bytes = float(nbytes.bytes)
    work.collectives = hlo.LOG[start:]


def analyze(work: Work, chips: int, rounds: int = 1) -> Roofline:
    """The roofline of ``work``; counted over ``rounds`` rounds (a fused
    block), its terms are one round's, as the reference's cost analysis
    counts a scanned round once."""
    ops = work.collectives
    by_kind: Dict[str, float] = {}
    for o in ops:
        by_kind[o.kind] = by_kind.get(o.kind, 0.0) + o.wire_bytes / rounds
    return Roofline(work.flops / rounds, work.hbm_bytes / rounds,
                    sum(o.wire_bytes for o in ops) / rounds, chips, by_kind,
                    coll_seconds=sum(o.wire_bytes / link_bw(o)
                                     for o in ops) / rounds)


def extrapolate(r1: Roofline, r2: Roofline, l1: int, l2: int,
                L: int) -> Roofline:
    """Affine-in-depth extrapolation (the reference's): a program is a
    fixed part plus L times a layer's, so the counts at depths ``l1``
    and ``l2`` fix the count at ``L``; each term is clamped at 0. The
    collectives' bytes by kind and their seconds (each op's bytes over
    its link's bandwidth, summed) are extrapolated like the bytes."""
    def ext(a, b):
        slope = (b - a) / (l2 - l1)
        return max(0.0, a + slope * (L - l1))

    kinds = set(r1.coll_by_kind) | set(r2.coll_by_kind)
    by_kind = {k: ext(r1.coll_by_kind.get(k, 0.0),
                      r2.coll_by_kind.get(k, 0.0)) for k in kinds}
    seconds = (None if r1.coll_seconds is None or r2.coll_seconds is None
               else ext(r1.coll_seconds, r2.coll_seconds))
    return Roofline(ext(r1.flops, r2.flops),
                    ext(r1.hbm_bytes, r2.hbm_bytes),
                    ext(r1.coll_bytes, r2.coll_bytes),
                    r1.chips, by_kind, per_device=r1.per_device,
                    coll_seconds=seconds)


def model_flops(cfg, tokens: int) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE): the 'useful
    compute' beside the counted work. For inference steps use 2·N·D."""
    from repro_torch.launch.specs import param_count
    return 6.0 * param_count(cfg, active_only=True) * tokens
