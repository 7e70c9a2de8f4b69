"""Flash attention: wrapper around the CUDA kernel.

Port of ``repro/kernels/flash_attention/flash_attention.py``:

  flash_attention — causal (or bidirectional) GQA attention with an
                    optional sliding window, online softmax, output in
                    q's dtype. Replaces the TPU kernel ``_fa_kernel``.

It is bound by operations on the card; what its CUDA design does about
it is written at the top of ``csrc/flash_attention.cu``: f32 inputs run
f32 FMA on the CUDA cores, bf16 inputs the tensor cores. For f32 the
wrapper picks the rows of a q tile (``q_tile_rows``) so that short
prefills still give every SM a block. Given CUDA tensors the wrapper launches
the kernel (built from that source at first use, see
``repro_torch.kernels.build``) or raises; given CPU tensors it runs the
plain version in ``ref.py``. There is no other switch. The
kernel has no backward: an input that requires grad is refused, so
training cannot run through it silently.

``LAUNCHES`` counts calls per ``(function, device type)``: one book per
kernel namespace, the ``"cuda"`` entry counting exactly the kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.common import sm_count
from repro_torch.kernels.flash_attention import ref

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",)

# the reference's default tiles: they decide when bidirectional
# attention would need padded keys (which it refuses)
DEFAULT_BLOCK_K = 128
# the kernel's largest head dim (kMaxHeadDim in csrc/flash_attention.cu);
# it takes multiples of 16 up to it
MAX_HEAD_DIM = 128
# the q-tile heights the f32 kernel is built for, the preferred first;
# the bf16 kernel has 64-row tiles only (smaller ones measured no faster)
Q_TILE_ROWS = (64, 32, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Counter = Counter()


def reset_launch_count() -> None:
    LAUNCHES.clear()


def launch_count(device_type: Optional[str] = None) -> int:
    """Total calls, or only those on ``device_type`` ("cuda"/"cpu")."""
    return common.count(LAUNCHES, device_type)


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library (compiled from SOURCES at first use)."""
    lib = build.load_library("flash_attention", SOURCES)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fa_max_head_dim.argtypes = []
    lib.fa_max_head_dim.restype = i32
    lib.fa_forward.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                               i32, i32, i32, ctypes.c_float, i32, vp]
    lib.fa_forward.restype = i32
    if lib.fa_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("csrc/flash_attention.cu and flash_attention.py "
                           "disagree on the largest head dim")
    return lib


def q_tile_rows(batch: int, s_len: int, heads: int, sms: int,
                dtype: torch.dtype) -> int:
    """Rows of a q tile: 64 for bf16. For f32, 64 unless that grid (one
    block per q tile, head and batch) has fewer blocks than the card has
    SMs; then the first of 32 and 16 that fills them, else 16."""
    if dtype == torch.bfloat16:
        return Q_TILE_ROWS[0]
    for rows in Q_TILE_ROWS:
        if -(-s_len // rows) * heads * batch >= sms:
            return rows
    return Q_TILE_ROWS[-1]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B,S,H,hd) and k/v (B,T,KV,hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    # the bf16 kernel copies rows in 16-byte pieces
    aligned = q.dtype == torch.bfloat16
    common.check_tensor("q", q, q.shape, q.dtype, q, aligned=aligned)
    common.check_tensor("k", k, (B, T, KV, hd), q.dtype, q, aligned=aligned)
    common.check_tensor("v", v, (B, T, KV, hd), q.dtype, q, aligned=aligned)
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward: its inputs "
                           "must not require grad")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if causal and T < S:
        raise ValueError(f"causal attention needs at least as many keys "
                         f"as queries, got T={T} < S={S}")
    if not causal and T % min(DEFAULT_BLOCK_K, T):
        raise ValueError("non-causal padding needs an explicit mask")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,hd), k/v: (B,T,KV,hd), contiguous, all f32 or all bf16
    -> (B,S,H,hd) in q's dtype. Query head h reads KV head h // (H/KV);
    the causal mask is col <= row, a window adds row − col < window."""
    _check(q, k, v, causal, window)
    if common.device_type(q) == "cpu":
        LAUNCHES[("flash_attention", "cpu")] += 1
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    B, S, H, hd = q.shape
    if hd % 16 or hd > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head dims that are "
                         f"multiples of 16 up to {MAX_HEAD_DIM}, got {hd}")
    T, KV = k.shape[1], k.shape[2]
    # the tile decides only which block computes a row, not how
    rows = q_tile_rows(B, S, H, sm_count(q.device.index), q.dtype)
    out = torch.empty_like(q)
    common.raise_on(library().fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, S, T, H, KV, hd, int(causal),
        -1 if window is None else int(window), 1.0 / math.sqrt(hd), rows,
        torch.cuda.current_stream(q.device).cuda_stream), "flash_attention")
    LAUNCHES[("flash_attention", "cuda")] += 1
    return out
