"""Host-side structured event log: a buffered JSONL sink.

Port of ``repro/telemetry/events.py``. Line 1 is a run-metadata header
(config hash, git sha, torch / CUDA versions, the device); every later
line is one event dict with a ``kind`` field. ``emit()`` only appends to
an in-memory buffer, device tensors included and UNCONVERTED, and
``flush()`` converts everything buffered with ONE device-to-host copy
(``to_host``) and writes it. The drivers flush at block boundaries only,
so a fused block makes no host transfer per round.

Consumed by ``launch/report.py`` through ``load_events``.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

# numpy dtype a tensor comes back as from to_host (bf16 as f32: exact)
_NUMPY = {torch.float32: np.float32, torch.float64: np.float64,
          torch.bfloat16: np.float32, torch.float16: np.float16,
          torch.int64: np.int64, torch.int32: np.int32,
          torch.int16: np.int16, torch.int8: np.int8, torch.uint8: np.uint8,
          torch.bool: np.bool_}


def to_host(values: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Tensors -> numpy values of the same shapes and kinds (a numpy
    scalar for a 0-d tensor), with ONE device-to-host copy per device for
    all of them: the device tensors are flattened, widened to f64 (exact
    for f32, bf16, bool and integers below 2**53) and concatenated on
    the device, copied once, and split on the host."""
    out: list = [None] * len(values)
    by_device: Dict[torch.device, List[int]] = {}
    for i, v in enumerate(values):
        if v.device.type == "cpu":
            out[i] = v.detach().to(torch.float32 if v.dtype ==
                                   torch.bfloat16 else v.dtype).numpy()[()]
        else:
            by_device.setdefault(v.device, []).append(i)
    for idx in by_device.values():
        flat = torch.cat([values[i].detach().reshape(-1).to(torch.float64)
                          for i in idx]).cpu().numpy()
        start = 0
        for i in idx:
            v = values[i]
            n = v.numel()
            out[i] = flat[start:start + n].reshape(tuple(v.shape)).astype(
                _NUMPY[v.dtype])[()]
            start += n
    return out


def config_hash(config: Optional[dict]) -> str:
    """Stable short hash of a (JSON-able) run config."""
    if not config:
        return ""
    blob = json.dumps(config, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def run_metadata(config: Optional[dict] = None, mesh: Any = None,
                 device=None) -> Dict[str, Any]:
    """The header payload: enough to tie an event stream back to the
    exact code + config + runtime that produced it. ``device`` is the
    run's device (default: the card when there is one); ``mesh`` (a
    DeviceMesh, or anything ``sharding.spec.mesh_shape`` reads) is
    recorded as ``{axis: size}``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    meta: Dict[str, Any] = {
        "kind": "header",
        "time": time.time(),
        "git_sha": git_sha(),
        "config_hash": config_hash(config),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "device_count": torch.cuda.device_count(),
        "mesh": None,
    }
    if mesh is not None:
        from repro_torch.sharding.spec import mesh_shape
        meta["mesh"] = mesh_shape(mesh)
    if config:
        meta["config"] = config
    return meta


def _jsonable(v):
    """numpy leaves -> plain python."""
    if isinstance(v, np.ndarray):
        return v.item() if v.ndim == 0 else v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


class EventLog:
    """Buffered JSONL event sink; see module docstring.

    Usable as a context manager; ``close()`` flushes. ``emit()`` is
    sync-free by contract: values (device tensors included) are stored
    as they are and converted in ``flush()``."""

    def __init__(self, path: str, *, config: Optional[dict] = None,
                 mesh: Any = None, device=None):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._buf: list = []
        self._f = open(path, "w", encoding="utf-8")
        self._f.write(json.dumps(run_metadata(config, mesh, device),
                                 default=str) + "\n")
        self._f.flush()
        self.events_written = 0

    def emit(self, kind: str, **fields) -> None:
        self._buf.append((kind, fields))

    def flush(self) -> int:
        """Convert (one device-to-host copy) and write every buffered
        event; returns the count."""
        n = len(self._buf)
        slots = [(i, k) for i, (_, fields) in enumerate(self._buf)
                 for k, v in fields.items() if isinstance(v, torch.Tensor)]
        host = to_host([self._buf[i][1][k] for i, k in slots])
        for (i, k), v in zip(slots, host):
            self._buf[i][1][k] = v
        for kind, fields in self._buf:
            row = {"kind": kind}
            row.update({k: _jsonable(v) for k, v in fields.items()})
            self._f.write(json.dumps(row, default=str) + "\n")
        self._buf.clear()
        self._f.flush()
        self.events_written += n
        return n

    def close(self) -> None:
        if not self._f.closed:
            self.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_events(path: str):
    """-> (header dict, [event dicts]) from a JSONL artifact."""
    with open(path, encoding="utf-8") as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    if not lines or lines[0].get("kind") != "header":
        raise ValueError(f"{path}: missing event-log header line")
    return lines[0], lines[1:]
