"""Conformance for the port: so far the kernel parity matrix
(``repro_torch.conformance.kernels``). The oracles, fuzzer, replay and
corpus of the reference's ``repro/conformance`` come with ROADMAP A18."""
from repro_torch.conformance.kernels import (KERNEL_MATRIX, NAMESPACES,
                                             KernelCell, cells_for,
                                             check_cell)

__all__ = ["KERNEL_MATRIX", "NAMESPACES", "KernelCell", "cells_for",
           "check_cell"]
