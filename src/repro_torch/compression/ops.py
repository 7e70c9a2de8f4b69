"""Apply a CompressionSpec to the packed (C, N) flat delta.

Port of ``compress_flat`` of ``repro/compression/ops.py``. It maps each
client's flat delta row to what the SERVER reconstructs after the client
shipped the compressed form (int8 values + scales, or top-k values +
indices). Quantize and dequantize run back to back on the device; the
wire cost is counted analytically (``CompressionSpec.wire_bytes``).

Per-client bandwidth levels: with a (C,) level vector (0 = none,
1 = int8, 2 = topk) every representation the ladder needs is computed
once for the whole slab and then picked per client lane, as the
reference does: 3 launches per round whatever the mix. The mesh-sharded
variant (``compress_flat_sharded``) comes with ROADMAP A17.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.compression.spec import CompressionSpec
from repro_torch.kernels.compress import compress as kernels


def _qdq(x: torch.Tensor) -> torch.Tensor:
    return kernels.dequantize_int8(*kernels.quantize_int8(x))


def compress_flat(delta: torch.Tensor, spec: CompressionSpec, *,
                  levels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(C, N) f32 delta -> (C, N) f32 server-side reconstruction.

    ``levels`` is the optional (C,) per-client bandwidth draw (None =
    every client at ``spec.kind``). Deterministic and chunk-local."""
    if levels is None:
        if spec.kind == "int8":
            return _qdq(delta)
        if spec.kind == "topk":
            return kernels.topk_mask(delta, spec.k)
        return delta
    out = torch.where((levels == 1)[:, None], _qdq(delta), delta)
    return torch.where((levels == 2)[:, None],
                       kernels.topk_mask(delta, spec.k), out)
