"""Segregated free-list metadata (port of :mod:`repro.core.freelist`).

Per size class ``c``: a stack of free block ids, an owner map, a refcount
plane and int32 counters -- the paper's support-core metadata, kept apart
from the KV payload it describes.  Every field is an int32 tensor with the
JAX package's shape and meaning, so states compare bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class FreeListState(NamedTuple):
    """Per-size-class segregated allocator metadata (``C`` classes, ``N``
    = max capacity over classes; padded ids are never enqueued)."""

    free_stack: torch.Tensor   # [C, N] stack of free ids; valid in [0, free_top)
    free_top: torch.Tensor     # [C] stack pointer (== number of free blocks)
    owner: torch.Tensor        # [C, N] owning lane per block, -1 if free
    refcount: torch.Tensor     # [C, N] references per block (0 == free)
    capacity: torch.Tensor     # [C] true capacity per class
    alloc_count: torch.Tensor  # [C] total blocks handed out
    free_count: torch.Tensor   # [C] total blocks returned
    fail_count: torch.Tensor   # [C] malloc requests not fully served
    used: torch.Tensor         # [C] currently allocated blocks
    peak_used: torch.Tensor    # [C] high-water mark (post-alloc, pre-free)
    split_count: torch.Tensor  # [C] buddy splits; passes through the freelist
    merge_count: torch.Tensor  # [C] buddy merges; passes through the freelist

    @property
    def num_classes(self) -> int:
        return self.free_stack.shape[0]

    @property
    def max_capacity(self) -> int:
        return self.free_stack.shape[1]

    def debug_summary(self, tenant_names: Sequence[str] | None = None,
                      stash_depth=None) -> str:
        """One line per size class: capacity / free / used / peak and the
        lifetime counters (host side)."""
        f = {k: v.cpu().numpy() for k, v in self._asdict().items()}
        lines = []
        for c in range(self.num_classes):
            name = tenant_names[c] if tenant_names and c < len(tenant_names) \
                else f"class{c}"
            cap = f["capacity"][c]
            owned = int((f["owner"][c, :cap] >= 0).sum())
            aliased = int((f["refcount"][c, :cap] > 1).sum())
            lines.append(
                f"  [{c}] {name}: used {f['used'][c]}/{cap} (quota), "
                f"free_top={f['free_top'][c]} owned={owned} aliased={aliased} "
                f"peak={f['peak_used'][c]} | allocs={f['alloc_count'][c]} "
                f"frees={f['free_count'][c]} fails={f['fail_count'][c]}")
        if stash_depth is not None:
            sd = np.asarray(_host(stash_depth))
            lines.append(f"  lane stash: {int(sd.sum())} blocks across "
                         f"{int((sd > 0).sum())} lanes (max depth "
                         f"{int(sd.max(initial=0))})")
        return "\n".join(lines)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def init_freelist(capacities: Sequence[int],
                  device: torch.device | str = "cpu") -> FreeListState:
    """A fresh free list: each class's stack holds ``0..cap-1`` in order
    (so the first pops return the highest ids), padded tail entries -1."""
    caps = np.asarray(capacities, np.int32)
    c, n = len(caps), int(caps.max())
    stack = np.tile(np.arange(n, dtype=np.int32), (c, 1))
    for i, cap in enumerate(caps):
        stack[i, cap:] = -1

    def zeros():
        return torch.zeros((c,), dtype=torch.int32, device=device)

    caps_t = torch.as_tensor(caps, device=device)
    return FreeListState(
        free_stack=torch.as_tensor(stack, device=device),
        free_top=caps_t.clone(),
        owner=torch.full((c, n), -1, dtype=torch.int32, device=device),
        refcount=torch.zeros((c, n), dtype=torch.int32, device=device),
        capacity=caps_t,
        alloc_count=zeros(), free_count=zeros(), fail_count=zeros(),
        used=zeros(), peak_used=zeros(), split_count=zeros(),
        merge_count=zeros(),
    )


class FreelistInvariantError(AssertionError):
    """An allocator invariant (I1–I6) failed; the message names it and
    carries :meth:`FreeListState.debug_summary`."""


def validate_freelist(
    state: FreeListState,
    stash_pages=None,
    stash_depth=None,
    in_use=None,
    stash_class: int = 0,
    tenant_names: Sequence[str] | None = None,
    refcount_expected=None,
    cache_pages=None,
    cache_owner: int | None = None,
) -> None:
    """Host-side invariant check (tests / debugging only).

      I1. free_top in [0, capacity]
      I2. stack entries below free_top are unique, valid ids, and unowned
      I3. used == capacity - free_top
      I4. every block is either on the stack or owned (exactly once)
      I5. (stash given) every block of the stash's class is exactly one of
          {central free stack, some lane's stash, in use, prefix cache};
          stashed blocks are owner-mapped to their lane and cached blocks
          to ``cache_owner``.  A cached block may also sit in live block
          tables (an alias); for the partition it counts once, as cached.
      I6. a block's refcount is positive iff it is owned; with
          ``refcount_expected`` the stash class's refcounts equal it (the
          caller's block-table in-degree plus cache and stash references).

    ``cache_pages`` with ``cache_owner`` (the demotion owner tag) lists the
    prefix cache's blocks; every block owner-mapped to ``cache_owner`` must
    be listed (no leaked demotion).
    """
    def fail(msg: str):
        raise FreelistInvariantError(
            f"{msg}\nallocator state at failure:\n"
            + state.debug_summary(tenant_names=tenant_names,
                                  stash_depth=stash_depth))

    def check(cond, msg: str):
        if not cond:
            fail(msg)

    fs = _host(state.free_stack)
    ft = _host(state.free_top)
    owner = _host(state.owner)
    refc = _host(state.refcount)
    caps = _host(state.capacity)
    used = _host(state.used)

    def cname(c: int) -> str:
        if tenant_names and c < len(tenant_names):
            return f"class {c} ({tenant_names[c]})"
        return f"class {c}"

    for c in range(fs.shape[0]):
        top, cap = int(ft[c]), int(caps[c])
        check(0 <= top <= cap,
              f"I1 (stack pointer in range) violated: {cname(c)} "
              f"free_top={top} outside [0, capacity={cap}]")
        live = fs[c, :top]
        check(len(np.unique(live)) == top,
              f"I2 (free stack hygiene) violated: duplicate ids below "
              f"free_top in {cname(c)}")
        check(live.min(initial=0) >= 0 and live.max(initial=0) < cap,
              f"I2 (free stack hygiene) violated: out-of-range id in "
              f"{cname(c)} free stack (capacity {cap})")
        bad = live[owner[c, live] != -1] if top else np.zeros((0,), np.int64)
        check(bad.size == 0,
              f"I2 (free stack hygiene) violated: free block(s) "
              f"{bad[:8].tolist()} of {cname(c)} still owner-mapped")
        check(used[c] == cap - top,
              f"I3 (occupancy accounting) violated: {cname(c)} "
              f"used={used[c]} but capacity - free_top = {cap - top}")
        owned = np.where(owner[c, :cap] >= 0)[0]
        check(len(owned) + top == cap,
              f"I4 (block conservation) violated: {cname(c)} has "
              f"{len(owned)} owned + {top} free != capacity {cap}")
        check(not np.intersect1d(owned, live).size,
              f"I4 (block conservation) violated: {cname(c)} block(s) "
              f"{np.intersect1d(owned, live)[:8].tolist()} both owned and free")
        mismatch = np.where((refc[c, :cap] > 0) != (owner[c, :cap] >= 0))[0]
        check(mismatch.size == 0,
              f"I6 (refcount conservation) violated: {cname(c)} block(s) "
              f"{mismatch[:8].tolist()} referenced but not owned (or the "
              f"reverse)")
        check(refc[c, :cap].min(initial=0) >= 0,
              f"I6 (refcount conservation) violated: negative refcount in "
              f"{cname(c)}")

    if stash_pages is None:
        return
    sp = _host(stash_pages)
    sd = _host(stash_depth)
    c = stash_class
    cap = int(caps[c])
    stack_ids = fs[c, : int(ft[c])]
    stashed_all = []
    for lane in range(sp.shape[0]):
        d = int(sd[lane])
        check(0 <= d <= sp.shape[1],
              f"I5 (stash partition) violated: lane {lane} stash depth {d} "
              f"outside [0, {sp.shape[1]}]")
        row = sp[lane, :d]
        check((sp[lane, d:] == -1).all(),
              f"I5 (stash partition) violated: lane {lane} has live entries "
              f"above its stash depth {d}")
        if d == 0:
            continue
        check(row.min() >= 0 and row.max() < cap,
              f"I5 (stash partition) violated: lane {lane} stashed "
              f"out-of-range id (capacity {cap})")
        check((owner[c, row] == lane).all(),
              f"I5 (stash partition) violated: lane {lane} stashed block(s) "
              f"{row[owner[c, row] != lane][:8].tolist()} not owner-mapped "
              f"to it")
        stashed_all.append(row)
    stashed = np.concatenate(stashed_all) if stashed_all else \
        np.zeros((0,), np.int32)
    check(len(np.unique(stashed)) == len(stashed),
          "I5 (stash partition) violated: block stashed by two lanes at once")
    dup = np.intersect1d(stashed, stack_ids)
    check(not dup.size,
          f"I5 (stash partition) violated: block(s) {dup[:8].tolist()} of "
          f"{cname(c)} on both the central stack and a lane stash")

    cached = np.asarray(_host(cache_pages) if cache_pages is not None
                        else [], np.int64)
    if cache_owner is not None:
        check(len(np.unique(cached)) == len(cached),
              "I5 (cache partition) violated: block cached twice")
        if cached.size:
            check(cached.min() >= 0 and cached.max() < cap,
                  f"I5 (cache partition) violated: cached out-of-range id "
                  f"(capacity {cap})")
            bad = cached[owner[c, cached] != cache_owner]
            check(bad.size == 0,
                  f"I5 (cache partition) violated: cached block(s) "
                  f"{bad[:8].tolist()} not owner-mapped to the cache owner "
                  f"{cache_owner}")
        tagged = np.where(owner[c, :cap] == cache_owner)[0]
        check(np.array_equal(np.sort(cached), tagged),
              f"I5 (cache partition) violated: owner map tags "
              f"{len(tagged)} block(s) as cache-owned but the cache lists "
              f"{len(cached)} -- demoted pages leaked outside the cache")
        for what, ids in (("free", stack_ids), ("stashed", stashed)):
            dup = np.intersect1d(cached, ids)
            check(not dup.size,
                  f"I5 (cache partition) violated: block(s) "
                  f"{dup[:8].tolist()} both cached and {what}")

    if in_use is not None:
        used_ids = np.setdiff1d(np.where(_host(in_use)[:cap])[0], cached)
        dup = np.intersect1d(used_ids, stashed)
        check(not dup.size,
              f"I5 (stash partition) violated: block(s) {dup[:8].tolist()} "
              f"both stashed and in use")
        dup = np.intersect1d(used_ids, stack_ids)
        check(not dup.size,
              f"I5 (stash partition) violated: block(s) {dup[:8].tolist()} "
              f"both free and in use")
        bad = used_ids[owner[c, used_ids] < 0] if used_ids.size else used_ids
        check(bad.size == 0,
              f"I5 (partition) violated: in-use block(s) {bad[:8].tolist()} "
              f"of {cname(c)} not owner-mapped")
        check(len(stack_ids) + len(stashed) + len(used_ids) + len(cached)
              == cap,
              f"I5 (partition) violated: stack {len(stack_ids)} + "
              f"stash {len(stashed)} + in-use {len(used_ids)} + cache "
              f"{len(cached)} != capacity "
              f"{cap} for {cname(c)}")

    if refcount_expected is not None:
        expected = _host(refcount_expected)[:cap]
        got = refc[c, :cap]
        bad = np.where(expected != got)[0]
        check(bad.size == 0,
              f"I6 (refcount == in-degree) violated: {cname(c)} block(s) "
              f"{bad[:8].tolist()} carry refcount {got[bad[:8]].tolist()} "
              f"but their block-table + cache + stash references are "
              f"{expected[bad[:8]].tolist()}")
