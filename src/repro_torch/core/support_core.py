"""The SpeedMalloc support-core step in plain PyTorch (port of
:mod:`repro.core.support_core`).

One already-``hmq.schedule``\\ d burst transforms the segregated metadata:

  malloc:  request i of class c takes ``free_stack[c, top_c-1-off_i-j]``
           for j < want_i, where ``off_i`` is what earlier GRANTED requests
           of the class consumed (a sequential-skip grant scan);
  free:    single-block frees add one reference drop each; FREE_ALL drops
           one reference from every block the lane owns (post-alloc owner
           map, so a block granted this burst can be freed in it); a block
           whose refcount reaches 0 returns to the stack through a
           per-class compaction in ascending id order.

Frees are deferred: this burst's mallocs are served from the pre-burst
stack.  This module is the plain version of the CUDA kernel in
:mod:`repro_torch.kernels.support_core`: the CPU path runs it, and on the
card it is the yardstick the kernel is held to bit for bit.  Every tensor
the JAX package keeps in int32 stays int32 here (torch's ``sum``/``cumsum``
default to int64, so each names its dtype).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .freelist import FreeListState
from .packets import (FREE_ALL, NO_BLOCK, OP_FREE, OP_MALLOC, OP_MALLOC_RUN,
                      OP_REFILL, RequestQueue)
from .scatter import add_drop, set_drop

I32 = torch.int32
#: FREE_ALL lane-list pad (lane id 2**31-1 is reserved for it).
LANE_PAD = 2**31 - 1


class StepStats(NamedTuple):
    """Telemetry emitted by one support-core step (int32 scalars)."""

    mallocs: torch.Tensor
    frees: torch.Tensor
    failed: torch.Tensor
    blocks_allocated: torch.Tensor
    blocks_freed: torch.Tensor


def grant_scan(
    free_top: torch.Tensor,    # [C] pre-step availability per class
    want: torch.Tensor,        # [Q] sanitized block counts (0 for non-mallocs)
    onehot: torch.Tensor,      # [Q, C] bool class membership
    is_malloc: torch.Tensor,   # [Q] bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """The HMQ grant recurrence: a request is granted iff its want fits on
    top of what EARLIER GRANTED requests of its class consumed (a failed
    request consumes nothing).  Returns ``(ok [Q] bool, my_goff [Q] int32)``.

    A true prefix recurrence with ``[C]`` state, run as a loop over the
    queue of tensor ops (no host sync).
    """
    oh = onehot.to(I32)
    consumed = torch.zeros_like(free_top)
    oks, offs = [], []
    for i in range(want.shape[0]):
        my = (oh[i] * consumed).sum(dtype=I32)
        av = (oh[i] * free_top).sum(dtype=I32)
        ok_i = is_malloc[i] & (want[i] > 0) & (my + want[i] <= av)
        consumed = consumed + torch.where(ok_i, want[i], 0) * oh[i]
        oks.append(ok_i)
        offs.append(my)
    return torch.stack(oks), torch.stack(offs)


def deferred_free_counts(
    sched: RequestQueue,
    owner: torch.Tensor,       # [C, N] POST-alloc owner map
    cls: torch.Tensor,         # [Q] clipped size classes
    onehot: torch.Tensor,      # [Q, C] bool
    is_free: torch.Tensor,     # [Q] bool
) -> torch.Tensor:
    """``[C, N]`` references this burst drops: single frees scatter-add one
    each; FREE_ALL contributes at most one per block the lane owns, found
    by a binary search of each class's sorted FREE_ALL lane list.  Only
    owned blocks count."""
    C, N = owner.shape
    Q = sched.capacity
    is_single = is_free & (sched.arg >= 0)
    sgl_c = torch.where(is_single, cls, C)
    sgl_b = torch.where(is_single & (sched.arg < N), sched.arg, N)
    single_cnt = add_drop(torch.zeros((C, N), dtype=I32, device=owner.device),
                          (sgl_c, sgl_b), 1)

    is_fa = is_free & (sched.arg == FREE_ALL)
    fa_lanes = torch.where(is_fa[None, :] & onehot.T, sched.lane[None, :],
                           LANE_PAD)                                    # [C, Q]
    fa_sorted = torch.sort(fa_lanes, dim=1).values.contiguous()
    fa_pos = torch.searchsorted(fa_sorted, owner)                       # [C, N]
    hit = torch.gather(fa_sorted, 1, fa_pos.clamp(0, Q - 1))
    whole_lane = (hit == owner) & (owner != LANE_PAD)
    return (single_cnt + whole_lane.to(I32)) * (owner >= 0).to(I32)


def _step_scheduled_torch(
    state: FreeListState,
    sched: RequestQueue,
    max_blocks_per_req: int,
    gated: bool = False,
) -> tuple[FreeListState, torch.Tensor, torch.Tensor]:
    """Process an already-scheduled queue; returns ``(new_state, blocks
    [Q, R], ok [Q])`` in scheduled order (the JAX ``_step_scheduled_jnp``,
    op for op).

    ``gated=True`` gives the skip semantics of ``AllocService.commit
    (gated=True)`` without a host sync: on a queue with no live packet the
    step changes nothing, not even ``peak_used``.  (Every other field of an
    all-NOP step is unchanged by construction.)
    """
    C, N = state.num_classes, state.max_capacity
    Q, R = sched.capacity, max_blocks_per_req
    dev = state.free_stack.device

    is_malloc = ((sched.op == OP_MALLOC) | (sched.op == OP_REFILL)
                 | (sched.op == OP_MALLOC_RUN))
    is_free = sched.op == OP_FREE
    want = torch.where(is_malloc, sched.arg.clamp(min=0), 0)
    want = torch.where(want <= R, want, 0)                   # overwide -> fail
    cls = sched.size_class.clamp(0, C - 1)
    onehot = torch.arange(C, dtype=I32, device=dev)[None, :] == cls[:, None]

    # ---- malloc phase (served from the pre-step stack; frees deferred) ----
    ok, my_goff = grant_scan(state.free_top, want, onehot, is_malloc)
    fail = is_malloc & ~ok
    granted = torch.where(ok, want, 0)

    j = torch.arange(R, dtype=I32, device=dev)[None, :]
    top_i = state.free_top[cls]
    pos = top_i[:, None] - 1 - my_goff[:, None] - j                     # [Q, R]
    take = ok[:, None] & (j < granted[:, None])
    safe_pos = torch.where(take, pos, 0)
    blocks = state.free_stack[cls.long()[:, None], safe_pos.long()]
    blocks = torch.where(take, blocks, NO_BLOCK)

    upd_c = torch.where(take, cls[:, None], C)
    upd_b = torch.where(take, blocks, N)
    owner = set_drop(state.owner, (upd_c, upd_b), sched.lane[:, None])
    refcount = set_drop(state.refcount, (upd_c, upd_b), 1)

    taken_per_class = (granted[:, None] * onehot).sum(0, dtype=I32)     # [C]
    top_after_alloc = state.free_top - taken_per_class
    used_after_alloc = state.used + taken_per_class
    peak = torch.maximum(state.peak_used, used_after_alloc)
    if gated:
        peak = torch.where((sched.op != 0).any(), peak, state.peak_used)

    # ---- free phase (deferred append) ----
    free_cnt = deferred_free_counts(sched, owner, cls, onehot, is_free)
    dec = refcount - free_cnt
    ret_mask = (free_cnt > 0) & (dec <= 0)
    refcount = dec.clamp(min=0)

    ret = ret_mask.to(I32)
    freed_per_class = ret.sum(1, dtype=I32)
    dest = top_after_alloc[:, None] + ret.cumsum(1, dtype=I32) - ret    # [C, N]
    dest = torch.where(ret_mask, dest, N)                # N -> dropped
    rows = torch.arange(C, dtype=I32, device=dev)[:, None]
    blk_ids = torch.arange(N, dtype=I32, device=dev)[None, :]
    new_stack = set_drop(state.free_stack, (rows, dest), blk_ids)
    owner = torch.where(ret_mask, -1, owner)

    new_state = FreeListState(
        free_stack=new_stack,
        free_top=top_after_alloc + freed_per_class,
        owner=owner,
        refcount=refcount,
        capacity=state.capacity,
        alloc_count=state.alloc_count + taken_per_class,
        free_count=state.free_count + freed_per_class,
        fail_count=state.fail_count + (fail[:, None] & onehot).sum(0, dtype=I32),
        used=used_after_alloc - freed_per_class,
        peak_used=peak,
        split_count=state.split_count,   # the free list never splits/merges
        merge_count=state.merge_count,
    )
    return new_state, blocks, ok.to(I32)
