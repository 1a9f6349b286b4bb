"""Plain versions of the fused support-core kernel.

:func:`support_core_burst_ref` is the scheduled-step body of
:mod:`repro_torch.core.support_core`, which the kernel matches bit for bit.

:func:`support_core_burst_sliced` computes the same function the way the
card does (``csrc/support_core.cu``): per class, the grant fast path or
the warp-batched sequential-skip recurrence, then the class's ids cut into
contiguous slices that each sweep their ids, count what they return, and
append it after the slices before them.  Only the tests use it: it shows
on the CPU that the kernel's algorithm is the plain step's function for
any slicing.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.freelist import FreeListState
from ...core.packets import (FREE_ALL, NO_BLOCK, OP_FREE, OP_MALLOC,
                             OP_MALLOC_RUN, OP_NOP, OP_REFILL, RequestQueue)
from ...core.support_core import LANE_PAD, _step_scheduled_torch

WARP = 32


def support_core_burst_ref(
    state: FreeListState,
    sched: RequestQueue,
    max_blocks_per_req: int = 1,
    gated: bool = False,
):
    """(new_state, blocks [Q, R], ok [Q]) for a scheduled HMQ burst."""
    return _step_scheduled_torch(state, sched, max_blocks_per_req, gated=gated)


def warp_grant(want: np.ndarray, top: int) -> tuple[np.ndarray, np.ndarray,
                                                    int]:
    """The kernel's slow grant path: ``want`` holds one class's mallocs in
    scheduled order (0 for a malloc that cannot be granted, -1 for a
    request that is no malloc of the class).  Requests go 32 at a time;
    within a batch, requests wanting more than what is left fail at once,
    and a prefix sum grants the run before the first one that does not fit,
    which fails.  Returns ``(granted [Q], offset [Q], fails)``."""
    Q = len(want)
    granted = np.zeros(Q, np.int64)
    offset = np.zeros(Q, np.int64)
    consumed = fails = 0
    for base in range(0, Q, WARP):
        batch = range(base, min(Q, base + WARP))
        fails += sum(1 for i in batch if want[i] == 0)
        und = [i for i in batch if want[i] > 0]
        while und:
            left = top - consumed
            fails += sum(1 for i in und if want[i] > left)
            und = [i for i in und if want[i] <= left]
            if not und:
                break
            incl = np.cumsum([want[i] for i in und])
            bad = np.flatnonzero(incl > left)
            run = und if not len(bad) else und[:bad[0]]
            for t, i in enumerate(run):
                granted[i] = want[i]
                offset[i] = consumed + incl[t] - want[i]
            if run:
                consumed += int(incl[len(run) - 1])
            if len(bad):
                fails += 1
                und = und[bad[0] + 1:]
            else:
                und = []
    return granted, offset, fails


def support_core_burst_sliced(
    state: FreeListState,
    sched: RequestQueue,
    max_blocks_per_req: int,
    slice_ids: int,
    gated: bool = False,
) -> tuple[FreeListState, torch.Tensor, torch.Tensor]:
    """The kernel's algorithm with each class cut into slices of
    ``slice_ids`` ids (the plan's ``slice``); CPU tensors in and out."""
    C, N = state.free_stack.shape
    Q, R = sched.capacity, max_blocks_per_req
    op, lane, arg = (t.numpy().astype(np.int64)
                     for t in (sched.op, sched.lane, sched.arg))
    cls = np.clip(sched.size_class.numpy(), 0, C - 1)
    st0 = state.free_stack.numpy()
    stack, owner, ref = (t.numpy().astype(np.int64).copy()
                         for t in (state.free_stack, state.owner,
                                   state.refcount))
    counters = {n: getattr(state, n).numpy().astype(np.int64).copy()
                for n in ("free_top", "alloc_count", "free_count",
                          "fail_count", "used", "peak_used")}
    blocks = np.full((Q, R), NO_BLOCK, np.int64)
    ok = np.zeros(Q, np.int64)
    if gated and not (op != OP_NOP).any():
        new = state._replace(**{n: getattr(state, n).clone()
                                for n in state._fields})
        return (new, torch.from_numpy(blocks.astype(np.int32)),
                torch.from_numpy(ok.astype(np.int32)))

    is_malloc = (op == OP_MALLOC) | (op == OP_REFILL) | (op == OP_MALLOC_RUN)
    want_all = np.where(is_malloc & (arg > 0) & (arg <= R), arg, 0)
    bounds = [(lo, min(N, lo + slice_ids)) for lo in range(0, N, slice_ids)]
    for c in range(C):
        mine = cls == c
        top = int(counters["free_top"][c])
        # ---- 1. grants: fast path when the class's total want fits ----
        want = np.where(mine & is_malloc, want_all, 0)
        if want.sum() <= top:
            granted = want
            offset = np.cumsum(want) - want
            fails = int((mine & is_malloc & (want_all == 0)).sum())
        else:
            granted, offset, fails = warp_grant(
                np.where(mine & is_malloc, want_all, -1), top)
        taken = int(granted.sum())
        ok[mine] = granted[mine] > 0
        # ---- 2. LIFO gather from the pre-burst stack; owner map; frees ----
        for i in np.flatnonzero(mine):
            for j in range(int(granted[i])):
                b = int(st0[c, top - 1 - offset[i] - j])
                blocks[i, j] = b
                if 0 <= b < N:
                    owner[c, b] = lane[i]
                    ref[c, b] = 1
        single = mine & (op == OP_FREE) & (arg >= 0) & (arg < N)
        cnt = np.bincount(arg[single], minlength=N)
        fa = np.sort(lane[mine & (op == OP_FREE) & (arg == FREE_ALL)])
        # ---- 3. each slice sweeps its ids and counts what returns ----
        returned = []
        for lo, hi in bounds:
            ow = owner[c, lo:hi]
            pos = np.searchsorted(fa, ow)
            whole = (pos < len(fa)) & (fa[np.minimum(pos, len(fa) - 1)] == ow) \
                if len(fa) else np.zeros(hi - lo, bool)
            drop = np.where(ow >= 0, cnt[lo:hi] + (whole & (ow != LANE_PAD)),
                            0)
            dec = ref[c, lo:hi] - drop
            ret = (drop > 0) & (dec <= 0)
            ref[c, lo:hi] = np.maximum(dec, 0)
            owner[c, lo:hi] = np.where(ret, -1, ow)
            returned.append(lo + np.flatnonzero(ret))
        # ---- 4. append after the slices before, in ascending id order ----
        before = np.cumsum([0] + [len(r) for r in returned])
        for s, ids in enumerate(returned):
            dest = top - taken + before[s] + np.arange(len(ids))
            keep = (dest >= 0) & (dest < N)
            stack[c, dest[keep]] = ids[keep]
        freed = int(before[-1])
        used_after = int(counters["used"][c]) + taken
        counters["free_top"][c] = top - taken + freed
        counters["alloc_count"][c] += taken
        counters["free_count"][c] += freed
        counters["fail_count"][c] += fails
        counters["used"][c] = used_after - freed
        counters["peak_used"][c] = max(int(counters["peak_used"][c]),
                                       used_after)

    def t32(x):
        return torch.from_numpy(np.asarray(x).astype(np.int32))

    new = state._replace(free_stack=t32(stack), owner=t32(owner),
                         refcount=t32(ref),
                         **{n: t32(v) for n, v in counters.items()})
    return new, t32(blocks), t32(ok)
