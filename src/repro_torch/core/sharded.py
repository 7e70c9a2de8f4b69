"""The collectives of the federation's multi-device round.

The sharded round is ``repro_torch.core.fed_round``'s flat body run on
each rank of a ``torch.distributed`` mesh (its module docstring). This
module counts what that body calls on a rank, for the collective
recorder's checks (``repro_torch.sharding.hlo``) and the ``static``
event: per local step, one params all-gather a gradient chunk of
``grad_chunk`` clients over the N-shard axes and the norms all_reduce;
per round the tail's packed client-axis sum and (2,) min, the robust
ladder's own sums, telemetry's loss gather and the aggregate's gather
over the N-shard axes. Collectives over axes of size 1 are not made.
"""
from __future__ import annotations


def grad_chunk(C_loc: int, shards: int) -> int:
    """Clients a rank evaluates at once: ceil(C_loc / S), so the chunk's
    full-N rows match the local (C_loc, N_loc) slab in size."""
    return max(1, -(-C_loc // max(1, shards)))


def local_step_collectives(C_loc: int, shards: int) -> int:
    """Collectives a rank makes per local step: one params all-gather a
    gradient chunk and the norms all_reduce, when N is sharded."""
    if shards <= 1:
        return 0
    return -(-C_loc // grad_chunk(C_loc, shards)) + 1


def round_collectives(C_loc: int, K: int, shards: int, *,
                      client_axes: bool, robust: str = None,
                      skipped: bool = False, deciles: bool = False) -> int:
    """The collectives one sharded round makes on a rank: per local
    step ``local_step_collectives``; the robust ladder's (clip: the
    norms over the N-shard axes and the packed client sum; mean,
    trimmed, median: one client sum); the packed metric sum and the η
    extrema over the client axes, and with telemetry's ``loss_deciles``
    the loss gather over them; the aggregate's all-gather over the
    N-shard axes (none when a quorum skip keeps the params)."""
    n = K * local_step_collectives(C_loc, shards)
    if robust is not None:
        n += int(client_axes)
        if robust == "clip" and shards > 1:
            n += 1
    n += (3 if deciles else 2) * int(client_axes)
    if shards > 1 and not skipped:
        n += 1
    return n
