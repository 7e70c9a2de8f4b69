"""CompressionSpec: the client->server delta-compression config.

Port of ``repro/compression/spec.py``. A spec picks a compressor for the
packed (C, N) flat delta (``repro_torch.compression.ops`` applies it,
``repro_torch.kernels.compress`` supplies the kernels):

  kind="none"  — identity. The round engine takes its exact
                 pre-compression code path.
  kind="int8"  — per-chunk symmetric int8 with one f32 scale per chunk
                 (chunk = LANES consecutive elements).
  kind="topk"  — magnitude top-k per chunk: keep
                 ``k = max(1, round(k_frac * LANES))`` slots, zero the
                 rest.

``error_feedback=True`` adds EF21 error feedback: each cohort slot
carries a reconstruction g_c (``FLState.ef``), the client ships
C(Δ_c − g_c), and both sides roll g_c ← g_c + C(Δ_c − g_c), so the
compression error does not accumulate across rounds.

The LEVELS ladder ("none" < "int8" < "topk" by wire cost) is shared with
the scenario's ``bandwidth`` axis: a bandwidth-heterogeneous scenario
draws a level per client per round and the round picks that client's
compressor.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.flat import LANES

KINDS = ("none", "int8", "topk")
# bandwidth-level ladder: index into KINDS, drawn per client per round
# by bandwidth-heterogeneous scenarios (0 = uncompressed)
LEVELS = KINDS


@dataclass(frozen=True)
class CompressionSpec:
    kind: str = "none"            # none | int8 | topk
    k_frac: float = 0.25          # topk: keep round(k_frac*LANES)/chunk
    error_feedback: bool = False  # EF21 state in FLState.ef

    def __post_init__(self):
        if self.kind not in KINDS:
            raise KeyError(f"unknown compression kind {self.kind!r}; "
                           f"one of {KINDS}")
        if not 0.0 < self.k_frac <= 1.0:
            raise ValueError(f"k_frac must be in (0, 1], got {self.k_frac}")

    @property
    def k(self) -> int:
        """topk slots kept per LANES-chunk."""
        return max(1, min(LANES, int(round(self.k_frac * LANES))))

    @property
    def level(self) -> int:
        return KINDS.index(self.kind)

    def active(self, scenario=None) -> bool:
        """Does this spec change the round at all? Inert specs keep the
        round on its exact pre-compression code path."""
        if self.kind != "none" or self.error_feedback:
            return True
        return scenario is not None and getattr(
            scenario, "bandwidth_heterogeneous", False)

    def level_wire_bytes(self, n: int) -> np.ndarray:
        """(len(LEVELS),) f32: client->server payload bytes for an
        n-element delta at each level. int8 ships 1 byte per element +
        one f32 scale per chunk; topk ships k (f32 value + 1-byte lane
        index) per chunk; none ships raw f32. ``n`` is the VALID element
        count (FlatLayout.size): tail padding never crosses the wire."""
        chunks = -(-n // LANES)
        return np.asarray([
            4.0 * n,                          # none: f32
            1.0 * n + 4.0 * chunks,           # int8: values + scales
            (4.0 + 1.0) * self.k * chunks,    # topk: values + lane idx
        ], np.float32)

    def wire_bytes(self, n: int, levels: Optional[torch.Tensor] = None,
                   num_clients: int = 1, device=None) -> torch.Tensor:
        """(C,) f32 per-client wire bytes for one round's deltas.
        ``levels`` is the optional (C,) per-client bandwidth draw (None =
        everyone at this spec's kind); the result lies on its device,
        else on ``device``."""
        if levels is not None:
            device = levels.device
        table = torch.from_numpy(self.level_wire_bytes(n)).to(device)
        if levels is None:
            return table[self.level].expand(num_clients).clone()
        return table[levels.long()]


def get_compression(spec_or_kind, **overrides) -> CompressionSpec:
    """Resolve a CompressionSpec from a spec (passed through), a kind
    name, or None (-> inert "none" spec), with field overrides."""
    if spec_or_kind is None:
        spec_or_kind = "none"
    if isinstance(spec_or_kind, CompressionSpec):
        return (dataclasses.replace(spec_or_kind, **overrides)
                if overrides else spec_or_kind)
    return CompressionSpec(kind=spec_or_kind, **overrides)
