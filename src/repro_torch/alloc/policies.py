"""Central-allocator policies behind one seam (port of
:mod:`repro.alloc.policies`).

A policy owns only the scheduled-step body: how an already-scheduled burst
transforms the segregated metadata.  HMQ scheduling, response routing and
telemetry live in :class:`repro_torch.alloc.AllocService`; every client
talks to the service, so a new central design plugs in without touching
them -- the paper's "adopt new allocator designs" made executable
(:func:`register_policy`).

* :class:`FreeListPolicy` -- the paper's per-class LIFO free stacks: the
  CUDA kernel for a state on the card, its plain PyTorch version on the
  CPU.
* :class:`BitmapPolicy` -- address-ordered first fit over the owner
  bitmap; the free stack is rebuilt ascending from the bitmap each burst.
* :class:`BuddyPolicy` -- power-of-two buddy placement: a grant takes the
  lowest aligned fully-free run of ``2**ceil(log2(n))`` blocks, falling
  back to first-fit singles, with cumulative split/merge counts.

Bitmap and buddy are plain PyTorch on whichever device the state lives
on (the JAX package has them in ``jnp`` only, with no Pallas kernel).
Grant/fail sets are policy-independent (the shared
:func:`~repro_torch.core.support_core.grant_scan`); only the ids differ.
``gated=True`` is the JAX service's ``lax.cond`` skip, decided on the
device: an all-NOP burst leaves the state bit-identical (free stack and
``peak_used`` included), grants nothing and reports every slot failed.
"""
from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import torch

from ..core.freelist import FreeListState, init_freelist
from ..core.packets import (NO_BLOCK, OP_FREE, OP_MALLOC, OP_MALLOC_RUN,
                            OP_NOP, OP_REFILL, RequestQueue)
from ..core.scatter import set_drop
from ..core.support_core import deferred_free_counts, grant_scan
from ..kernels.support_core.ops import support_core_burst

I32 = torch.int32

#: Built-in policies (``register_policy`` adds more).
ALLOC_POLICIES = ("freelist", "bitmap", "buddy")


@runtime_checkable
class AllocatorPolicy(Protocol):
    """The central-allocator seam: one scheduled HMQ burst over the
    metadata, on the state's device."""

    name: str
    #: whether ``OP_MALLOC_RUN`` packets are placed as contiguous aligned
    #: runs; without it ``BurstBuilder.malloc_run`` stages a plain malloc
    supports_runs: bool

    def init(self, capacities: Sequence[int],
             device: torch.device) -> FreeListState:
        """Fresh metadata for the given per-class capacities."""
        ...

    def step_scheduled(self, state: FreeListState, sched: RequestQueue,
                       max_blocks_per_req: int, gated: bool = False):
        """``(new_state, blocks [Q, R], ok [Q])`` in scheduled order."""
        ...


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
    #: whether every burst rebuilds the free stack from the owner bitmap
    #: (read by ``loadgen.trace.certify_complete``: a compaction pass's
    #: stack rebuild is in no trace event); a policy without the attribute
    #: counts as not rebuilding
    rebuilds_stack = False

    def init(self, capacities: Sequence[int],
             device: torch.device) -> FreeListState:
        return init_freelist(capacities, device=device)

    def step_scheduled(self, state: FreeListState, sched: RequestQueue,
                       max_blocks_per_req: int, gated: bool = False):
        return support_core_burst(state, sched, max_blocks_per_req,
                                  gated=gated)


def _burst_terms(state: FreeListState, sched: RequestQueue, R: int):
    """Per-slot terms every policy shares: ``(is_malloc, is_free, want,
    cls, onehot)`` (overwide requests want 0, so they fail)."""
    C = state.num_classes
    is_malloc = ((sched.op == OP_MALLOC) | (sched.op == OP_REFILL)
                 | (sched.op == OP_MALLOC_RUN))
    is_free = sched.op == OP_FREE
    want = torch.where(is_malloc, sched.arg.clamp(min=0), 0)
    want = torch.where(want <= R, want, 0)
    cls = sched.size_class.clamp(0, C - 1)
    onehot = torch.arange(C, dtype=I32, device=cls.device)[None, :] \
        == cls[:, None]
    return is_malloc, is_free, want, cls, onehot


def _ascending_stack(free_bm: torch.Tensor) -> torch.Tensor:
    """``[C, N]``: each row's free ids in ascending order, ``NO_BLOCK``
    past them (the ``r``-th entry is the ``r``-th lowest free id)."""
    C, N = free_bm.shape
    dev = free_bm.device
    rank = free_bm.cumsum(1, dtype=I32) - free_bm.to(I32)
    rows = torch.arange(C, dtype=I32, device=dev)[:, None]
    blk_ids = torch.arange(N, dtype=I32, device=dev)[None, :]
    return set_drop(torch.full((C, N), NO_BLOCK, dtype=I32, device=dev),
                    (rows, torch.where(free_bm, rank, N)), blk_ids)


def _finish(state, sched, granted, fail, onehot, cls, is_free, owner,
            refcount, real):
    """The shared tail of the bitmap and buddy bursts: grant bookkeeping,
    the refcount-gated deferred free phase and the ascending stack rebuild.
    Returns ``(new_state, final_free)``."""
    taken_per_class = (granted[:, None] * onehot).sum(0, dtype=I32)
    used_after_alloc = state.used + taken_per_class
    free_cnt = deferred_free_counts(sched, owner, cls, onehot, is_free)
    dec = refcount - free_cnt
    ret_mask = (free_cnt > 0) & (dec <= 0)
    refcount = dec.clamp(min=0)
    freed_per_class = ret_mask.sum(1, dtype=I32)
    owner = torch.where(ret_mask, -1, owner)
    final_free = (owner < 0) & real
    new_state = FreeListState(
        free_stack=_ascending_stack(final_free),
        free_top=state.free_top - taken_per_class + freed_per_class,
        owner=owner,
        refcount=refcount,
        capacity=state.capacity,
        alloc_count=state.alloc_count + taken_per_class,
        free_count=state.free_count + freed_per_class,
        fail_count=state.fail_count + (fail[:, None] & onehot).sum(
            0, dtype=I32),
        used=used_after_alloc - freed_per_class,
        peak_used=torch.maximum(state.peak_used, used_after_alloc),
        split_count=state.split_count,
        merge_count=state.merge_count,
    )
    return new_state, final_free


def _grant_owners(state, sched, blocks, cls):
    """Owner and refcount rows with every granted block mapped to its
    lane at refcount 1 (``NO_BLOCK`` slots go to the sink)."""
    C, N = state.num_classes, state.max_capacity
    take = blocks != NO_BLOCK
    upd_c = torch.where(take, cls[:, None], C)
    upd_b = torch.where(take, blocks, N)
    owner = set_drop(state.owner, (upd_c, upd_b), sched.lane[:, None])
    refcount = set_drop(state.refcount, (upd_c, upd_b), 1)
    return owner, refcount


def _gate(state, new_state, blocks, ok, sched, gated):
    """``gated=True``: with no live packet, the old state, no blocks and
    every slot failed -- selected on the device, no host sync."""
    if not gated:
        return new_state, blocks, ok
    live = (sched.op != OP_NOP).any()
    kept = FreeListState(*[torch.where(live, n, o)
                           for n, o in zip(new_state, state)])
    return (kept, torch.where(live, blocks, NO_BLOCK),
            torch.where(live, ok, 0))


class BitmapPolicy:
    """Address-ordered first fit over the owner bitmap.

    The free set of class ``c`` is ``owner[c] < 0`` over real ids (``id <
    capacity[c]``); a granted request takes the LOWEST free ids of its
    class, in grant order, and the free stack is rebuilt ascending after
    the free phase -- a cache of the bitmap.  Grants, failures, counters
    and deferred frees are the free list's; only the block ids differ.
    """

    name = "bitmap"
    supports_runs = False
    rebuilds_stack = True

    def init(self, capacities: Sequence[int],
             device: torch.device) -> FreeListState:
        # an ascending stack is the bitmap's first-fit order from step one
        return init_freelist(capacities, device=device)

    def step_scheduled(self, state: FreeListState, sched: RequestQueue,
                       max_blocks_per_req: int, gated: bool = False):
        N = state.max_capacity
        R = max_blocks_per_req
        dev = state.owner.device
        is_malloc, is_free, want, cls, onehot = _burst_terms(state, sched, R)
        real = torch.arange(N, dtype=I32, device=dev)[None, :] \
            < state.capacity[:, None]                                  # [C, N]
        nth_free = _ascending_stack((state.owner < 0) & real)

        # the shared grant scan: availability free_top == popcount of the
        # bitmap (I3), so the ok/fail pattern is the free list's
        ok, my_goff = grant_scan(state.free_top, want, onehot, is_malloc)
        fail = is_malloc & ~ok
        granted = torch.where(ok, want, 0)

        # first fit: request i takes ranks [my_goff, my_goff + granted)
        j = torch.arange(R, dtype=I32, device=dev)[None, :]
        take = ok[:, None] & (j < granted[:, None])                    # [Q, R]
        pos = torch.where(take, my_goff[:, None] + j, 0)
        blocks = nth_free[cls.long()[:, None], pos.long()]
        blocks = torch.where(take, blocks, NO_BLOCK)

        owner, refcount = _grant_owners(state, sched, blocks, cls)
        new_state, _ = _finish(state, sched, granted, fail, onehot, cls,
                               is_free, owner, refcount, real)
        return _gate(state, new_state, blocks, ok.to(I32), sched, gated)


def _pow2_ceil(n: torch.Tensor) -> torch.Tensor:
    """Elementwise least power of two ``>= max(n, 1)`` for ``n < 2**30``,
    by smearing the top bit of ``n - 1`` downwards: the values the JAX
    package's float32 ``log2`` gives, in integers."""
    v = n.clamp(min=1) - 1
    for shift in (1, 2, 4, 8, 16):
        v = v | (v >> shift)
    return v + 1


def _aligned_free_runs(free_bm: torch.Tensor, size: int) -> torch.Tensor:
    """``[C, P // size]`` bool: size-aligned runs of ``size`` all free
    (``free_bm`` is ``[C, P]`` with ``P`` a multiple of ``size``)."""
    return free_bm.reshape(free_bm.shape[0], -1, size).all(dim=2)


class BuddyPolicy:
    """Power-of-two buddy placement over the owner bitmap.

    Per class the pool is an implicit buddy tree: level ``k`` nodes are the
    ``2**k``-aligned runs of ``2**k`` blocks.  A granted request of ``n``
    blocks takes the first ``n`` ids of the LOWEST fully-free aligned run
    of ``2**ceil(log2(n))`` (a prefix of a larger free node IS the split)
    and falls back to the lowest free singles when no such run exists, so
    a grant never fails for lack of contiguity.  ``OP_MALLOC_RUN`` places
    like ``OP_MALLOC``/``OP_REFILL``.

    Placement is sequential over the ``Q`` scheduled rows (each row sees
    the bitmap the rows before it left), as the JAX package's
    ``lax.scan``: on the card that is ``Q`` rounds of small launches.
    ``split_count`` adds the aligned runs (all levels) fully free before
    the malloc phase and broken after it, ``merge_count`` those made newly
    fully free by the free phase.
    """

    name = "buddy"
    supports_runs = True
    rebuilds_stack = True

    def init(self, capacities: Sequence[int],
             device: torch.device) -> FreeListState:
        # ascending stack: id order is the buddy tree's address order
        return init_freelist(capacities, device=device)

    def step_scheduled(self, state: FreeListState, sched: RequestQueue,
                       max_blocks_per_req: int, gated: bool = False):
        C, N = state.num_classes, state.max_capacity
        Q, R = sched.capacity, max_blocks_per_req
        dev = state.owner.device
        is_malloc, is_free, want, cls, onehot = _burst_terms(state, sched, R)
        blk_ids = torch.arange(N, dtype=I32, device=dev)
        real = blk_ids[None, :] < state.capacity[:, None]              # [C, N]
        free_bm0 = (state.owner < 0) & real

        ok, _ = grant_scan(state.free_top, want, onehot, is_malloc)
        fail = is_malloc & ~ok
        granted = torch.where(ok, want, 0)
        run_len = torch.where(granted > 0, _pow2_ceil(granted), 0)     # [Q]

        # ---- placement: one row at a time over a bitmap with a sink
        # column N, so taking a NO_BLOCK slot is a write to the sink ----
        j = torch.arange(R, dtype=I32, device=dev)
        bm = torch.cat([free_bm0, torch.zeros((C, 1), dtype=torch.bool,
                                              device=dev)], dim=1)
        zero = torch.zeros((1,), dtype=I32, device=dev)
        false = torch.zeros((), dtype=torch.bool, device=dev)
        cls_l = cls.long()
        rows = []
        for i in range(Q):
            # a one-element index tensor, not a 0-d one: indexing with a
            # 0-d tensor reads it on the host (a sync on the card)
            n_i, run_i, c_i = granted[i], run_len[i], cls_l[i:i + 1]
            row = bm[c_i, :N][0]
            counts = row.cumsum(0, dtype=I32)
            prefix = torch.cat([zero, counts])                         # [N+1]
            span = prefix[(blk_ids + run_i).clamp(max=N).long()] \
                - prefix[:N]
            cand = ((run_i > 0) & (blk_ids % run_i.clamp(min=1) == 0)
                    & (blk_ids + run_i <= N) & (span == run_i))
            start = torch.where(cand, blk_ids, N).min()
            run_blocks = start + j
            # fallback: the n_i lowest free ids (address-ordered first fit)
            nth = set_drop(torch.full((N,), NO_BLOCK, dtype=I32, device=dev),
                           (torch.where(row, counts - row.to(I32), N),),
                           blk_ids)
            single = nth[j.clamp(max=N - 1).long()]
            blocks_i = torch.where((start < N) & (n_i > 0), run_blocks,
                                   single)
            blocks_i = torch.where(j < n_i, blocks_i, NO_BLOCK)
            taken = torch.where(blocks_i != NO_BLOCK, blocks_i, N).long()
            bm.index_put_((c_i.expand_as(taken), taken), false)
            rows.append(blocks_i)
        blocks = torch.stack(rows) if rows else \
            torch.full((0, R), NO_BLOCK, dtype=I32, device=dev)
        free_bm_mid = bm[:, :N]

        owner, refcount = _grant_owners(state, sched, blocks, cls)
        # the split/merge counts need the post-free bitmap: count after
        new_state, final_free = _finish(state, sched, granted, fail, onehot,
                                        cls, is_free, owner, refcount, real)
        P = 1
        while P < N:
            P *= 2
        pad = torch.zeros((C, P - N), dtype=torch.bool, device=dev)
        bm0, bm_mid, bm_fin = (torch.cat([b, pad], dim=1)
                               for b in (free_bm0, free_bm_mid, final_free))
        splits = torch.zeros((C,), dtype=I32, device=dev)
        merges = torch.zeros((C,), dtype=I32, device=dev)
        size = 2
        while size <= P:
            was0 = _aligned_free_runs(bm0, size)
            mid = _aligned_free_runs(bm_mid, size)
            fin = _aligned_free_runs(bm_fin, size)
            splits = splits + (was0 & ~mid).sum(1, dtype=I32)
            merges = merges + (~mid & fin).sum(1, dtype=I32)
            size *= 2
        new_state = new_state._replace(
            split_count=state.split_count + splits,
            merge_count=state.merge_count + merges)
        return _gate(state, new_state, blocks, ok.to(I32), sched, gated)


_POLICIES: dict[str, AllocatorPolicy] = {
    "freelist": FreeListPolicy(),
    "bitmap": BitmapPolicy(),
    "buddy": BuddyPolicy(),
}


def get_policy(name: str) -> AllocatorPolicy:
    """Resolve a policy by name (built-ins plus ``register_policy``
    entries)."""
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown alloc policy {name!r}; expected one of "
            f"{tuple(_POLICIES)}") from None


def register_policy(policy: AllocatorPolicy) -> None:
    """Register a custom :class:`AllocatorPolicy` (the adopt-new-designs
    seam; replaces an existing entry of the same name)."""
    _POLICIES[policy.name] = policy
