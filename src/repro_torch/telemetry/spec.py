"""TelemetrySpec: the switch for the round's telemetry block, plus the
device-side metrics it gates.

Port of ``repro/telemetry/spec.py``. Non-perturbing by construction:
``round_telemetry`` only READS round-end values (``S.eta``, the loss
matrix, the guard latches) and adds new keys to the metrics dict; it
never touches the update path, so trajectories are bitwise equal with
telemetry on and off. All outputs are fixed-shape device tensors, so
they stack over a fused block like the scalar metrics, with no host
sync. The two kernels of ``repro_torch.kernels.telemetry`` run on the
device of their inputs: there is no backend switch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.kernels.telemetry import telemetry as tk
from repro_torch.utils.numerics import xla_mean


class TelemetrySpec(NamedTuple):
    """Round telemetry configuration.

    ``eta_bins`` log-spaced η bins between ``eta_lo`` and ``eta_hi``
    (the first bin catches [0, eta_lo), the last [eta_hi, inf): Δ-SGD's
    η is nonnegative); ``loss_deciles`` adds the per-client mean-loss
    order statistics."""
    enabled: bool = False
    eta_bins: int = 16
    eta_lo: float = 1e-4
    eta_hi: float = 10.0
    loss_deciles: bool = True
    quantiles: int = 11

    def eta_edges(self) -> np.ndarray:
        """(eta_bins+1,) ascending f32 bin edges: 0, log-spaced
        interior, +inf."""
        if self.eta_bins < 3:
            raise ValueError(f"eta_bins must be >= 3 (underflow + >=1 "
                             f"log bin + overflow), got {self.eta_bins}")
        interior = np.logspace(np.log10(self.eta_lo),
                               np.log10(self.eta_hi),
                               self.eta_bins - 1)
        return np.concatenate([[0.0], interior, [np.inf]]
                              ).astype(np.float32)

    def edges_on(self, device) -> torch.Tensor:
        """``eta_edges()`` as a tensor on ``device``. The host-to-device
        copy is queued without a host sync; the round builds it once."""
        return torch.from_numpy(self.eta_edges()).to(device,
                                                     non_blocking=True)


def resolve_telemetry(telemetry: Union[None, bool, TelemetrySpec]
                      ) -> TelemetrySpec:
    """None/False -> disabled spec; True -> enabled defaults; a spec
    passes through."""
    if isinstance(telemetry, TelemetrySpec):
        return telemetry
    if telemetry is None or telemetry is False:
        return TelemetrySpec()
    if telemetry is True:
        return TelemetrySpec(enabled=True)
    raise ValueError(f"telemetry must be None, bool, or TelemetrySpec, "
                     f"got {telemetry!r}")


def round_telemetry(tele: TelemetrySpec, etas: torch.Tensor,
                    losses: torch.Tensor, clips: Optional[torch.Tensor] = None,
                    valid: Optional[torch.Tensor] = None, *,
                    edges: Optional[torch.Tensor] = None) -> dict:
    """The telemetry block of one round: the η histogram over client
    lanes (``lane_histogram``), the per-client mean-loss deciles
    (``lane_quantiles``), and the absolute η-clamp and NaN-guard counts.
    ``etas`` is (C,), ``losses`` (C, K). ``edges`` is the (B+1,) bin
    edge tensor on the round's device; without it the edges are built
    here, a copy per call."""
    if not tele.enabled:
        return {}
    if edges is None:
        edges = tele.edges_on(etas.device)
    out = {"eta_hist": tk.lane_histogram(etas, edges)}
    if tele.loss_deciles:
        # the per-client mean as XLA computes the reference's jnp.mean,
        # so the same losses give the reference's deciles bit for bit
        client_loss = xla_mean(losses.to(torch.float32), dim=1)
        out["loss_deciles"] = tk.lane_quantiles(client_loss, tele.quantiles)
    if clips is not None:
        out["eta_clip_count"] = clips.to(torch.float32).sum()
    if valid is not None:
        out["nan_guard_count"] = (~valid).to(torch.float32).sum()
    return out
