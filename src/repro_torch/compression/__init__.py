"""Delta compression on the packed (C, N) flat buffer.

  spec — CompressionSpec (kind / k_frac / error_feedback), the LEVELS
         bandwidth ladder, and wire-byte accounting.
  ops  — compress_flat: apply a spec to the flat delta, per-client
         bandwidth levels as lane selects; compress_flat_sharded: the
         same on a rank's slab of a mesh-sharded buffer.

The kernels live in repro_torch.kernels.compress, with their plain
versions in repro_torch.kernels.compress.ref.
"""
from repro_torch.compression.ops import compress_flat, compress_flat_sharded
from repro_torch.compression.spec import (KINDS, LEVELS, CompressionSpec,
                                          get_compression)

__all__ = ["KINDS", "LEVELS", "CompressionSpec", "get_compression",
           "compress_flat", "compress_flat_sharded"]
