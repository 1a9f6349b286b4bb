"""Plain version of the fused support-core kernel: the scheduled-step body
of :mod:`repro_torch.core.support_core`, which the kernel matches bit for
bit."""
from __future__ import annotations

from ...core.freelist import FreeListState
from ...core.packets import RequestQueue
from ...core.support_core import _step_scheduled_torch


def support_core_burst_ref(
    state: FreeListState,
    sched: RequestQueue,
    max_blocks_per_req: int = 1,
    gated: bool = False,
):
    """(new_state, blocks [Q, R], ok [Q]) for a scheduled HMQ burst."""
    return _step_scheduled_torch(state, sched, max_blocks_per_req, gated=gated)
