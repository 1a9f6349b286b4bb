"""Hardware message queues (paper §5.2) — batched scheduler (port of
:mod:`repro.core.hmq`).

A step's requests are reordered malloc-first, then refill, then free, with
round-robin fairness across lanes inside each priority class:

  key(i) = (priority(op_i) * (Q + 1) + rr_rank(i)) * (L + 1) + lane_i

The JAX package keeps this key in int32 and falls back to a lexicographic
sort when large lane ids could overflow it.  Here the key is int64, which
cannot overflow for any int32 lane id, so one stable sort always yields the
same ``(prio, rr, lane)`` order -- and the identical permutation.
"""
from __future__ import annotations

import torch

from .packets import (OP_FREE, OP_MALLOC, OP_MALLOC_RUN, OP_NOP, OP_REFILL,
                      RequestQueue)


def round_robin_rank(lane: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """For each slot, the number of earlier valid slots with the same lane
    (int32; 0 for invalid slots)."""
    q = lane.shape[0]
    idx = torch.arange(q, device=lane.device)
    # invalid slots go to a fake lane so they don't perturb real ranks
    eff_lane = torch.where(valid, lane, q + 1)
    # stable sort by lane == sort by (lane, position)
    order = torch.argsort(eff_lane, stable=True)
    sorted_lane = eff_lane[order]
    is_start = torch.ones((q,), dtype=torch.bool, device=lane.device)
    is_start[1:] = sorted_lane[1:] != sorted_lane[:-1]
    group_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = torch.empty_like(idx).scatter_(0, order, idx - group_start)
    return torch.where(valid, rank, 0).to(torch.int32)


def max_safe_lanes(q: int) -> int:
    """Largest lane-id count for which the JAX package's fused int32 sort
    key ``(prio * (q+1) + rr) * (lanes+1) + lane`` cannot overflow
    (``prio <= 3``, ``rr <= q``): ``lanes + 1 <= (2**31 - 1) // (4 * (q +
    1))``.  The port's key is int64, so its :func:`schedule` is exact past
    this bound too; the bound says where the JAX package switches to its
    lexicographic sort."""
    return max((2**31 - 1) // (4 * (q + 1)) - 1, 0)


def schedule(queue: RequestQueue) -> tuple[RequestQueue, torch.Tensor]:
    """Reorder a request queue per the HMQ policy.

    Returns ``(scheduled_queue, unperm)`` where ``unperm`` (int64) maps
    scheduled positions back to the caller's slots.
    """
    q = queue.capacity
    valid = queue.op != OP_NOP
    is_free = queue.op == OP_FREE
    is_refill = queue.op == OP_REFILL
    # priority: malloc(0) < refill(1) < free(2) < nop(3)
    prio = torch.where(valid, torch.where(is_free, 2, torch.where(
        is_refill, 1, 0)), 3).long()
    # each priority class keeps its own round-robin arrival rounds
    rr_m = round_robin_rank(queue.lane, valid & ~is_free & ~is_refill)
    rr_r = round_robin_rank(queue.lane, valid & is_refill)
    rr_f = round_robin_rank(queue.lane, valid & is_free)
    rr = torch.where(is_free, rr_f, torch.where(is_refill, rr_r, rr_m)).long()
    lanes = queue.lane.max().clamp(min=0).long() + 1
    key = (prio * (q + 1) + rr) * (lanes + 1) + queue.lane.long()
    perm = torch.argsort(key, stable=True)
    sched = RequestQueue(op=queue.op[perm], lane=queue.lane[perm],
                         size_class=queue.size_class[perm],
                         arg=queue.arg[perm])
    unperm = torch.empty_like(perm).scatter_(
        0, perm, torch.arange(q, device=perm.device))
    return sched, unperm


def queue_occupancy(queue: RequestQueue) -> dict[str, torch.Tensor]:
    """Occupancy statistics (int32 scalars): live slots, and mallocs (with
    ``OP_MALLOC_RUN``, a malloc with a contiguity hint), refills and
    frees."""
    def count(mask):
        return mask.sum().to(torch.int32)
    return {
        "total": count(queue.op != OP_NOP),
        "malloc": count((queue.op == OP_MALLOC) | (queue.op == OP_MALLOC_RUN)),
        "refill": count(queue.op == OP_REFILL),
        "free": count(queue.op == OP_FREE),
    }
