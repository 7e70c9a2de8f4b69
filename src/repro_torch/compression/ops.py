"""Apply a CompressionSpec to the packed (C, N) flat delta.

Port of ``compress_flat`` of ``repro/compression/ops.py``. It maps each
client's flat delta row to what the SERVER reconstructs after the client
shipped the compressed form (int8 values + scales, or top-k values +
indices). Quantize and dequantize run back to back on the device; the
wire cost is counted analytically (``CompressionSpec.wire_bytes``).

Per-client bandwidth levels: with a (C,) level vector (0 = none,
1 = int8, 2 = topk) every representation the ladder needs is computed
once for the whole slab and then picked per client lane, as the
reference does: 3 launches per round whatever the mix.

``compress_flat_sharded`` is the same on a rank's (C_loc, N_loc) slab of
a mesh-sharded buffer. It makes no collective call: the compressors are
chunk-local and N_loc is a multiple of the 128-lane chunk, so no chunk
straddles a shard, and compression finishes strictly before the
client-mean all_reduce.
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


def compress_flat_sharded(delta: torch.Tensor, spec: CompressionSpec, *,
                          mesh, pspec,
                          levels: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """``compress_flat`` on this rank's (C_loc, N_loc) slab of a
    mesh-sharded (C, N) buffer (``pspec`` is
    ``FederationSpec.flat_spec(mesh)``); ``levels`` are the rank's
    (C_loc,) lanes. No collective."""
    from repro_torch.core.flat import LANES
    if delta.shape[-1] % LANES:
        raise ValueError(f"N_loc={delta.shape[-1]} is not a multiple of "
                         f"the {LANES}-lane chunk")
    return compress_flat(delta, spec, levels=levels)
