"""Build hand-written CUDA sources into a shared library and load it.

Each kernel namespace keeps its sources under ``csrc/`` with a plain C
interface. At first use ``load_library`` runs ``nvcc`` for Hopper
(``sm_90a``) into ``build/torch_kernels/`` at the repository root and
loads the result with ``ctypes``. The output name carries a hash of the
sources and the flags, so a stale library is never loaded; the library
is written under a temporary name and renamed into place, so a build
that is cut off leaves nothing loadable behind. The compiler's
``-Xptxas -v`` report (registers, shared memory, spills) is kept next to
the library as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin): the CUDA kernels are built "
                       "from source at first use")


def library_path(name: str, sources: Sequence[Path]) -> Path:
    """Where the library for these sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(Path(src).name.encode())
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[Path]) -> Path:
    """Compile ``sources`` unless the hashed library already exists."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Build (if needed) and load; one handle per library per process."""
    path = build(name, sources)
    lib = _LOADED.get(path)
    if lib is None:
        lib = _LOADED[path] = ctypes.CDLL(str(path))
    return lib
