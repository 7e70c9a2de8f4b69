"""Async buffered aggregation (FedBuff, Nguyen et al. 2022). Port of
``repro/federation/buffer.py``.

Synchronous FedAvg waits every round for its slowest client. FedBuff
lets clients report when they finish: the server accumulates
staleness-weighted deltas in a buffer and takes a server step only once
``M`` client updates have arrived.

  * each round, the C cohort clients contribute ``Δ_c = x_c^K − x_t``
    with a per-client staleness ``s_c`` (rounds in flight, drawn by the
    scenario) and weight ``w(s_c) = (1+s_c)^{−a}``;
  * the buffer carries the weighted delta SUM as a tree like the params
    (f32) plus scalar weight, count and staleness accumulators, all
    device tensors;
  * once ``count ≥ M`` the buffered pseudo-average ``x_t + Σ wΔ / Σ w``
    goes to any ``ServerOpt`` as the round's client mean, and the
    buffer resets.

The reference picks flush or hold with ``lax.cond``. Here
``buffer_step`` computes the flushed result and selects it or the held
one on the device (``torch.where``), so a round makes no host read of
the count. With the round's staleness draw queued to the device
(``core.fed_round``), a fused block of the plain async tail syncs the
host nowhere, which a CUDA graph of the block (ROADMAP A8) needs;
``chip_smoke.py`` phase 4d checks it with
``torch.cuda.set_sync_debug_mode``. The guarded tail (faults, a robust
aggregator or a quorum) reads the host once a round where a quorum is
set, the quorum's ``float(n_valid)``, as the synchronous guarded tail
does. The held rounds pay one
server update whose result is dropped.

With staleness ≡ 0 and M = C the flush happens every round with unit
weights, and the pseudo-average is the plain client mean: the async
round then gives synchronous FedAvg. Under compression the round hands
``buffer_merge`` the weighted sum of the reconstructed deltas Δ̂_c.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Union

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


class AsyncBufferState(NamedTuple):
    delta: Any                  # tree like params, f32: Σ_c w(s_c)·Δ_c
    weight: torch.Tensor        # 0-d f32: Σ_c w(s_c)
    count: torch.Tensor         # 0-d int32: client updates since flush
    stale_sum: torch.Tensor     # 0-d f32: Σ s_c since flush (metrics)
    stale_max: torch.Tensor     # 0-d f32: max s_c since flush (metrics)


def buffer_init(params) -> AsyncBufferState:
    delta = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    device = tree_leaves(params)[0].device

    def zero(dtype=torch.float32):
        return torch.zeros((), dtype=dtype, device=device)
    return AsyncBufferState(delta, zero(), zero(torch.int32), zero(), zero())


def staleness_weights(staleness: torch.Tensor,
                      exponent: float) -> torch.Tensor:
    """FedBuff's polynomial discount w(s) = (1+s)^(−a), (C,) f32."""
    return torch.pow(1.0 + staleness.to(torch.float32), -float(exponent))


def buffer_merge(buf: AsyncBufferState, delta_sum, weight_sum,
                 num_updates: Union[int, torch.Tensor],
                 staleness: torch.Tensor) -> AsyncBufferState:
    """Fold one cohort's pre-weighted delta SUM (a tree like params, f32:
    one reduction over the packed client axis) into the buffer."""
    s = staleness.to(torch.float32)
    return AsyncBufferState(
        tree_map(lambda a, b: a + b, buf.delta, delta_sum),
        buf.weight + weight_sum,
        buf.count + num_updates,
        buf.stale_sum + s.sum(),
        torch.maximum(buf.stale_max, s.max()))


def buffer_step(params, server_state, buf: AsyncBufferState, server_opt,
                buffer_size: int):
    """Flush if ``count ≥ M``, else hold -> ``(params, server_state,
    buffer, flushed)``, ``flushed`` a 0-d f32 0/1. The flush hands the
    server optimizer ``x_t + Σ w·Δ / Σ w``, what a synchronous round
    would hand it, so every ServerOpt works unmodified. Both results
    are computed and one is selected on the device."""
    flush = buf.count >= buffer_size
    den = torch.clamp(buf.weight, min=1e-12)
    mean = tree_map(lambda p, d: (p.to(torch.float32) + d / den).to(p.dtype),
                    params, buf.delta)
    new_p, new_s = server_opt.update(params, mean, server_state)

    def pick(a, b):
        return torch.where(flush, a, b)
    fresh = buffer_init(params)
    return (tree_map(pick, new_p, params),
            tree_map(pick, new_s, server_state),
            AsyncBufferState(*(tree_map(pick, a, b)
                               for a, b in zip(fresh, buf))),
            flush.to(torch.float32))
