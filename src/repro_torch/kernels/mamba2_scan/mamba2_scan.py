"""Mamba2 SSD chunk kernel: wrapper around the CUDA kernel.

Port of ``repro/kernels/mamba2_scan/mamba2_scan.py``:

  ssd_chunks — per (batch, head, chunk): the intra-chunk output
               ``y = (C Bᵀ ⊙ decay ⊙ dt) x``, the chunk state ``S_c``,
               the chunk decay and ``exp(cumsum(dA))``. Replaces the TPU
               kernel ``_ssd_chunk_kernel``.

The inter-chunk combine is ``ops.ssd_scan``, in plain PyTorch. What the
CUDA design does about the card is written at the top of
``csrc/mamba2_scan.cu``; ``ssd_grid`` picks its grid (chunks packed per
block, slices of P, warp groups per block) from the shape and the SM
count; neither the slicing nor the warp groups change a bit of the
output, and the packing, which may at L not a multiple of 8, follows
from L alone. Given CUDA tensors
the wrapper launches the kernel (built from that source at first use, see
``repro_torch.kernels.build``) or raises; given CPU tensors it runs the
plain version in ``ref.py``. There is no other switch. The kernel has no
backward: an input that requires grad is refused.

B and C come in by group (B, S, G, N); the kernel reads group
``h // (H/G)`` for head h instead of a per-head copy, and the plain
version expands them as the reference's ``jnp.repeat`` does.
``LAUNCHES`` counts calls per ``(function, device type)``.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.common import sm_count
from repro_torch.kernels.mamba2_scan import ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "mamba2_scan.cu",)

CHUNK = 64
# the kernel's largest P and N (kMaxDim in csrc/mamba2_scan.cu)
MAX_DIM = 128
# the most columns of P one block owns (kMaxSlice)
MAX_SLICE = 64
# chunks shorter than this many steps share a block, PACK_ROWS // L of
# them
PACK_ROWS = 32

LAUNCHES: Counter = Counter()


def reset_launch_count() -> None:
    LAUNCHES.clear()


def launch_count(device_type: Optional[str] = None) -> int:
    """Total calls, or only those on ``device_type`` ("cuda"/"cpu")."""
    return common.count(LAUNCHES, device_type)


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library (compiled from SOURCES at first use)."""
    lib = build.load_library("mamba2_scan", SOURCES)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_max_chunk.argtypes = []
    lib.ssd_max_chunk.restype = i32
    lib.ssd_max_dim.argtypes = []
    lib.ssd_max_dim.restype = i32
    lib.ssd_max_slice.argtypes = []
    lib.ssd_max_slice.restype = i32
    lib.ssd_chunks_forward.argtypes = [vp] * 9 + [i32] * 10 + [vp]
    lib.ssd_chunks_forward.restype = i32
    if (lib.ssd_max_chunk() != CHUNK or lib.ssd_max_dim() != MAX_DIM
            or lib.ssd_max_slice() != MAX_SLICE):
        raise RuntimeError("csrc/mamba2_scan.cu and mamba2_scan.py disagree "
                           "on the largest chunk, dim or slice")
    return lib


def ssd_grid(batch: int, s_len: int, heads: int, p_dim: int, chunk: int,
             sms: int) -> Tuple[int, int, bool]:
    """(chunks per block, slices of P, two groups) of the kernel's grid.
    Chunks shorter than PACK_ROWS steps are packed PACK_ROWS // L to a
    block, so that the chunk states stream out of few blocks. P is cut
    into the fewest slices of at most MAX_SLICE columns: slicing further,
    to fill the SMs at a short prefill, was measured slower on the H100
    (PERF.md), since a block's time is its chain of dependent
    tensor-core products, which a slice shortens little. A grid whose
    blocks each have an SM of their own takes blocks of two warp groups,
    one on C Bᵀ, M and y and one on S_c at the same time; a larger grid
    takes one group a block, two blocks to an SM, one's staging beside
    the other's products (chip_smoke.py's "ssd_chunks groups" line)."""
    cpb = max(1, PACK_ROWS // chunk)
    split = -(-p_dim // MAX_SLICE)
    blocks = batch * heads * -(-(s_len // chunk) // cpb) * split
    return cpb, split, blocks <= sms


def ssd_chunks(x: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = CHUNK):
    """x: (B,S,H,P), dt/dA: (B,S,H), Bm/Cm: (B,S,G,N) with H % G == 0,
    all f32 and contiguous. The chunk length is ``min(chunk, S)`` and
    must divide S.

    Returns (y_intra (B,S,H,P), S_c (B,nc,H,P,N), chunk_decay (B,nc,H),
    exp_cs (B,S,H)), all f32."""
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"x must be (B,S,H,P) and B/C (B,S,G,N), got "
                         f"{tuple(x.shape)} and {tuple(Bm.shape)}")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    f32 = torch.float32
    common.check_tensor("x", x, x.shape, f32, x)
    common.check_tensor("dt", dt, (Bsz, S, H), f32, x)
    common.check_tensor("dA", dA, (Bsz, S, H), f32, x)
    common.check_tensor("Bm", Bm, (Bsz, S, G, N), f32, x)
    common.check_tensor("Cm", Cm, (Bsz, S, G, N), f32, x)
    if G < 1 or H % G:
        raise ValueError(f"{H} heads do not group over {G} groups")
    if any(t.requires_grad for t in (x, dt, dA, Bm, Cm)):
        raise RuntimeError("ssd_chunks has no backward: its inputs must "
                           "not require grad")
    L = min(chunk, S)
    if L < 1 or S % L:
        raise ValueError(f"seq {S} not divisible by chunk {L}")
    if common.device_type(x) == "cpu":
        LAUNCHES[("ssd_chunks", "cpu")] += 1
        return ref.ssd_chunks_ref(x, dt, dA, Bm, Cm, L)
    if L > CHUNK or P > MAX_DIM or N > MAX_DIM:
        raise ValueError(f"the CUDA kernel takes chunks up to {CHUNK} and "
                         f"P, N up to {MAX_DIM}, got L={L}, P={P}, N={N}")
    nc = S // L
    cpb, split, two = ssd_grid(Bsz, S, H, P, L, sm_count(x.device.index))
    y = torch.empty_like(x)
    s_c = torch.empty((Bsz, nc, H, P, N), dtype=f32, device=x.device)
    cd = torch.empty((Bsz, nc, H), dtype=f32, device=x.device)
    ecs = torch.empty((Bsz, S, H), dtype=f32, device=x.device)
    common.raise_on(library().ssd_chunks_forward(
        x.data_ptr(), dt.data_ptr(), dA.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), s_c.data_ptr(), cd.data_ptr(),
        ecs.data_ptr(), Bsz, S, H, G, P, N, L, cpb, split, int(two),
        torch.cuda.current_stream(x.device).cuda_stream), "ssd_chunks")
    LAUNCHES[("ssd_chunks", "cuda")] += 1
    return y, s_c, cd, ecs
