"""Request/response packet formats for the support-core (port of
:mod:`repro.core.packets`).

A whole step's requests form one :class:`RequestQueue` of ``[Q]`` int32
tensors (the HMQ ingress), answered by ``blocks [Q, R]`` and ``status
[Q]`` (:class:`repro_torch.alloc.BurstResult`).  The
opcodes and sentinels are the JAX package's values, so queues built by
either package describe the same bursts.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

OP_NOP = 0
OP_MALLOC = 1
OP_FREE = 2
OP_REFILL = 3
OP_MALLOC_RUN = 4

#: ``arg`` sentinel for OP_FREE meaning "free all blocks owned by lane".
FREE_ALL = -1

#: Response sentinel for "no block allocated" (failed or nop slot).
NO_BLOCK = -1

#: Lane-id sentinel for padded slots in compact lane-packet arrays.
NO_LANE = -1


class RequestQueue(NamedTuple):
    """Fixed-capacity batch of allocation requests; all fields ``[Q]``
    int32 on one device.  Slots with ``op == OP_NOP`` are ignored."""

    op: torch.Tensor
    lane: torch.Tensor
    size_class: torch.Tensor
    arg: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.op.shape[0]


def make_queue(ops, lanes, size_classes, args, capacity: int | None = None,
               device: torch.device | str = "cpu") -> RequestQueue:
    """Build a queue from python/array slot lists, padding with nops."""
    def vec(x):
        return torch.as_tensor(x, dtype=torch.int32, device=device).reshape(-1)

    fields = [vec(x) for x in (ops, lanes, size_classes, args)]
    n = fields[0].shape[0]
    cap = capacity if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < number of requests {n}")
    if cap > n:
        pad = torch.zeros((cap - n,), dtype=torch.int32, device=device)
        fields = [torch.cat([f, pad]) for f in fields]
    return RequestQueue(*fields)
