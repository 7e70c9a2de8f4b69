"""Round-versioned model registry: watch a training checkpoint dir and
stage new params for the decode engine to hot-swap. Port of
``repro/serving/registry.py``.

The training CLI saves FLState checkpoints keyed on the round
counter (``launch/train``'s ``--ckpt-dir``); the registry polls
``repro_torch.checkpoint.latest_step`` and, whenever a round newer than
the one currently serving appears, loads its params subtree through
``restore_params`` (the ``params/`` manifest-prefix mapping, so training
checkpoints serve directly; a checkpoint written by either package
reads) into a :class:`StagedVersion`. Each restored leaf takes its
template leaf's dtype and device, so a template on the card stages on
the card.

The registry only stages; the engine applies. ``DecodeEngine.step``
polls once per flush interval and swaps at the block boundary: params
are never replaced while a decode block is in flight, so no token is
ever produced from mixed-version params. ``StagedVersion.seen_at`` is
stamped when the poll first notices the new checkpoint on disk; the
engine's ``serve_swap_stall_s`` is the time from then until the staged
params serve traffic (restore + wait-to-boundary).
"""
from __future__ import annotations

import os
import time
from typing import Any, NamedTuple, Optional

from repro_torch.checkpoint import latest_step, restore_params


class StagedVersion(NamedTuple):
    params: Any          # restored params tree (serving template shapes)
    step: int            # training round the checkpoint was keyed on
    seen_at: float       # wall time the poll first saw the checkpoint


class ModelRegistry:
    """Poll-based checkpoint watcher; see module docstring.

    ``template`` fixes the serving param shapes, dtypes and device: every
    restore is checked leaf by leaf against it (``restore_params`` raises
    on any shape mismatch), so a staged version can always hot-swap into
    an engine built from the same template.
    """

    def __init__(self, ckpt_dir: str, template: Any):
        self.ckpt_dir = ckpt_dir
        self.template = template
        self.version: Optional[int] = None   # last step handed out
        self.loads = 0

    def poll(self) -> Optional[StagedVersion]:
        """Stage the newest checkpoint round if it is newer than the last
        one handed out; None when already current (or the dir is still
        empty). ``save`` publishes through an atomic rename of its temp
        dir, so a half-written checkpoint is never read."""
        step = latest_step(self.ckpt_dir)
        if step is None or (self.version is not None
                            and step <= self.version):
            return None
        seen_at = time.time()
        params, step = restore_params(self.ckpt_dir, self.template,
                                      step=step)
        self.version = step
        self.loads += 1
        return StagedVersion(params=params, step=step, seen_at=seen_at)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"step_{step:08d}")
