"""Central-allocator policies behind one seam (port of
:mod:`repro.alloc.policies`).

A policy owns only the scheduled-step body: how an already-scheduled burst
transforms the segregated metadata.  HMQ scheduling, response routing,
gating and telemetry live in :class:`repro_torch.alloc.AllocService`.

This slice ports the paper's design, :class:`FreeListPolicy`.  The bitmap
and buddy policies of the JAX package are still to be ported (ROADMAP.md,
Queue 1 item 8); asking for them raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..core.freelist import FreeListState, init_freelist
from ..core.packets import RequestQueue
from ..kernels.support_core.ops import support_core_burst

#: Policies the port implements.
ALLOC_POLICIES = ("freelist",)


class FreeListPolicy:
    """Per-class LIFO free stacks (the paper's design, §5.1).

    The burst runs through :func:`~repro_torch.kernels.support_core.ops
    .support_core_burst`: the CUDA kernel for a state on the card, its plain
    PyTorch version for a state on the CPU.
    """

    name = "freelist"
    #: the free list has no contiguity placement: ``malloc_run`` lowers to
    #: a plain malloc at staging time
    supports_runs = False

    def init(self, capacities: Sequence[int],
             device: torch.device) -> FreeListState:
        return init_freelist(capacities, device=device)

    def step_scheduled(self, state: FreeListState, sched: RequestQueue,
                       max_blocks_per_req: int, gated: bool = False):
        return support_core_burst(state, sched, max_blocks_per_req,
                                  gated=gated)


def get_policy(name: str) -> FreeListPolicy:
    """Resolve a policy by name; only ``freelist`` is ported so far."""
    if name == "freelist":
        return FreeListPolicy()
    raise NotImplementedError(
        f"alloc policy {name!r} is not ported to repro_torch yet; only "
        f"'freelist' is (see ROADMAP.md, Queue 1 item 8)")
