"""Checkpointing: save and restore any tree of tensors (params, an
``FLState``, a ``FlatFLState``, the fleet ``ClientArena``) to a
directory of ``.npy`` files and a JSON manifest. Port of
``repro/checkpoint/checkpoint.py``, in its on-disk format, so a
checkpoint crosses between the two packages in both directions:

  * ``<ckpt_dir>/step_%08d/``, written to ``step_%08d.tmp`` and renamed;
  * ``NNNNN.npy`` per leaf, in the reference's leaf order;
  * ``manifest.json``: ``{"step", "leaves": [{"key", "file", "dtype",
    "shape"}]}``;
  * a bf16 leaf is stored as f32 under the logical dtype ``"bfloat16"``
    (numpy has no bf16) and read back exactly, since its values are
    bf16 to start with;
  * the newest ``keep`` steps are kept.

Leaf order and keys are those of the reference's
``tree_flatten_with_path``: dict keys sorted, NamedTuple fields in field
order by name, list and tuple entries by index, ``None`` dropped, the
path joined with ``/``. The port's host counters (``FLState.round``)
are Python ints in memory and 0-d int32 arrays on disk, as the
reference carries them.

    save(path, state, step=12)
    state, step = restore(path, like=state_template)
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree, path=()) -> List[Tuple[str, Any]]:
    """[(key, leaf)] in the reference's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten_with_paths(getattr(tree, f), path + (f,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_paths(v, path + (str(i),))]
    return [("/".join(path) or "leaf", tree)]


def _rebuild(like, leaves: Iterator):
    """``like``'s structure with its leaves taken from ``leaves`` in the
    order ``_flatten_with_paths`` lists them."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """-> (the array written, its logical dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.to(torch.float32).numpy(), "bfloat16"
        arr = t.numpy()
    elif isinstance(leaf, (bool, np.bool_)):
        arr = np.asarray(leaf)
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)       # a host counter
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _shape(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return tuple(np.shape(leaf))


def _like_template(arr: np.ndarray, tmpl):
    """The loaded array in the template leaf's type, dtype and device."""
    if isinstance(tmpl, torch.Tensor):
        return torch.from_numpy(np.asarray(arr, order="C")).to(
            device=tmpl.device, dtype=tmpl.dtype)
    if isinstance(tmpl, (bool, np.bool_)):
        return bool(arr)
    if isinstance(tmpl, int):
        return int(arr)
    return np.asarray(arr, dtype=np.asarray(tmpl).dtype)


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(ckpt_dir: str, tree: Any, *, step: int = 0, keep: int = 3) -> str:
    """Write checkpoint ``step``; returns its directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (key, leaf) in enumerate(_flatten_with_paths(tree)):
        arr, logical = _to_numpy(leaf)
        fname = f"{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"key": key, "file": fname,
                                   "dtype": logical,
                                   "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _steps(ckpt_dir: str) -> List[int]:
    return [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp")]


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def _manifest(ckpt_dir: str, step: Optional[int]) -> Tuple[str, dict, int]:
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        return d, json.load(f), step


def _load(d: str, meta: dict, key: str, tmpl):
    arr = np.load(os.path.join(d, meta["file"]))
    if arr.shape != _shape(tmpl):
        raise ValueError(f"shape mismatch at {key}: {arr.shape} vs "
                         f"{_shape(tmpl)}")
    return _like_template(arr, tmpl)


def restore(ckpt_dir: str, like: Any, *, step: Optional[int] = None
            ) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (leaf count and shapes
    verified; each leaf takes its template's dtype and device). Returns
    (tree, step); ``step`` None takes the newest."""
    d, manifest, step = _manifest(ckpt_dir, step)
    metas = manifest["leaves"]
    tmpl = _flatten_with_paths(like)
    if len(tmpl) != len(metas):
        raise ValueError(f"checkpoint has {len(metas)} leaves, template "
                         f"has {len(tmpl)}")
    leaves = [_load(d, meta, meta["key"], t)
              for meta, (_, t) in zip(metas, tmpl)]
    return _rebuild(like, iter(leaves)), step


def restore_params(ckpt_dir: str, like_params: Any, *,
                   step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore just the params from a checkpoint of bare params or of a
    full FLState (what training saves): a template leaf with key ``k``
    matches the manifest's ``k`` or ``params/k``."""
    d, manifest, step = _manifest(ckpt_dir, step)
    by_key = {m["key"]: m for m in manifest["leaves"]}
    leaves = []
    for key, tmpl in _flatten_with_paths(like_params):
        meta = by_key.get(key) or by_key.get("params/" + key)
        if meta is None:
            raise KeyError(
                f"param leaf {key!r} not in checkpoint step {step} "
                f"(neither bare nor under 'params/'); sample keys: "
                f"{sorted(by_key)[:4]}")
        leaves.append(_load(d, meta, key, tmpl))
    return _rebuild(like_params, iter(leaves)), step


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in sorted(_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
