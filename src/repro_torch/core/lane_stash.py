"""Per-lane page stash: the front tier of the two-tier allocator (port of
:mod:`repro.core.lane_stash`).

Each lane keeps a small LIFO stash of pre-granted KV pages, so a decode step
pops its page-boundary allocation with tensor ops and reaches the central
support-core only in bulk refill bursts.  Every stashed page is
owner-mapped to its lane, so a lane's FREE_ALL reclaims its stash too.
All ops are out of place and shape-static.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .packets import NO_BLOCK
from .scatter import set_drop

I32 = torch.int32


class LaneStashState(NamedTuple):
    """``pages[l, :depth[l]]`` are valid; slots above hold ``NO_BLOCK``.
    A disabled stash still carries a ``[max_lanes, 1]`` dummy."""

    pages: torch.Tensor   # [max_lanes, S] int32
    depth: torch.Tensor   # [max_lanes] int32

    @property
    def size(self) -> int:
        return self.pages.shape[1]

    @property
    def max_lanes(self) -> int:
        return self.pages.shape[0]


def validate_stash_params(size: int, watermark: int, refill: int) -> None:
    """A refill must always fit above the watermark (grants are
    all-or-nothing): ``watermark + refill <= size``."""
    if size < 0 or watermark < 0 or refill < 0:
        raise ValueError("stash parameters must be non-negative")
    if size == 0:
        return
    if watermark < 1:
        raise ValueError("a non-empty stash needs stash_watermark >= 1")
    if refill < 1:
        raise ValueError("a non-empty stash needs stash_refill >= 1")
    if watermark + refill > size:
        raise ValueError(
            f"stash_watermark ({watermark}) + stash_refill ({refill}) must "
            f"not exceed stash_size ({size}): an all-or-nothing refill of a "
            f"below-watermark lane could overflow the stash")


def autotune_stash(page_size: int, window: int | None, num_lanes: int,
                   pool_pages: int) -> tuple[int, int, int]:
    """``(stash_size, stash_watermark, stash_refill)`` from boundary cadence
    and a quarter-of-the-pool budget (the JAX package's derivation);
    ``(0, 2, 4)`` when the pool cannot fund a stash."""
    if num_lanes <= 0 or pool_pages <= 0 or page_size <= 0:
        return 0, 2, 4
    budget = pool_pages // (4 * num_lanes)
    if budget < 3:
        return 0, 2, 4
    if window:
        ramp = -(-window // page_size)
        refill = max(2, min(ramp // 2, budget - 1, 8))
    else:
        refill = min(8, budget - 1)
    watermark = min(2, budget - refill)
    size = watermark + refill
    validate_stash_params(size, watermark, refill)
    return size, watermark, refill


def init_stash(max_lanes: int, size: int,
               device: torch.device) -> LaneStashState:
    return LaneStashState(
        pages=torch.full((max_lanes, max(size, 1)), NO_BLOCK, dtype=I32,
                         device=device),
        depth=torch.zeros((max_lanes,), dtype=I32, device=device),
    )


def stash_pop(stash: LaneStashState, want: torch.Tensor
              ) -> tuple[LaneStashState, torch.Tensor, torch.Tensor]:
    """Pop each wanting lane's stash top: ``(stash, pages, got)`` with
    ``got = want & (depth > 0)`` and ``NO_BLOCK`` where the pop missed."""
    L, S = stash.pages.shape
    lane_ids = torch.arange(L, dtype=I32, device=want.device)
    got = want & (stash.depth > 0)
    top = (stash.depth - 1).clamp(0, S - 1)
    pages = torch.where(got, stash.pages[lane_ids.long(), top.long()],
                        NO_BLOCK)
    new_pages = set_drop(stash.pages, (torch.where(got, lane_ids, L), top),
                         NO_BLOCK)
    return LaneStashState(new_pages, stash.depth - got.to(I32)), pages, got


def stash_push(stash: LaneStashState, pages: torch.Tensor, want: torch.Tensor
               ) -> tuple[LaneStashState, torch.Tensor]:
    """Push one page per wanting lane where there is room: ``(stash,
    pushed)``.  ``want & ~pushed`` lanes must route their page to the
    central free list instead (overflow flush)."""
    L, S = stash.pages.shape
    lane_ids = torch.arange(L, dtype=I32, device=want.device)
    pushed = want & (stash.depth < S)
    slot = stash.depth.clamp(0, S - 1)
    new_pages = set_drop(stash.pages, (torch.where(pushed, lane_ids, L), slot),
                         pages)
    return LaneStashState(new_pages, stash.depth + pushed.to(I32)), pushed


def stash_push_batch(stash: LaneStashState, blocks: torch.Tensor,
                     count: int, want: torch.Tensor) -> LaneStashState:
    """Append ``blocks[l, :count]`` to each wanting lane's stash (bulk
    refill install); callers guarantee room."""
    L, S = stash.pages.shape
    lane_ids = torch.arange(L, dtype=I32, device=want.device)
    j = torch.arange(count, dtype=I32, device=want.device)[None, :]
    slot = (stash.depth[:, None] + j).clamp(0, S - 1)
    rows = torch.where(want[:, None], lane_ids[:, None], L)
    new_pages = set_drop(stash.pages, (rows, slot), blocks[:, :count])
    return LaneStashState(new_pages, stash.depth + count * want.to(I32))


def stash_set_rows(stash: LaneStashState, lanes: torch.Tensor,
                   blocks: torch.Tensor, count: int,
                   got: torch.Tensor) -> LaneStashState:
    """Overwrite whole stash rows for ``lanes`` (admission pre-charge):
    granted lanes get ``blocks[:, :count]``, others an empty row."""
    S = stash.size
    rows = torch.full((lanes.shape[0], S), NO_BLOCK, dtype=I32,
                      device=lanes.device)
    if count:
        rows[:, :count] = torch.where(got[:, None], blocks[:, :count],
                                      NO_BLOCK)
    pages = stash.pages.clone()
    depth = stash.depth.clone()
    pages[lanes.long()] = rows
    depth[lanes.long()] = torch.where(got, count, 0).to(I32)
    return LaneStashState(pages=pages, depth=depth)


def stash_clear(stash: LaneStashState, mask: torch.Tensor) -> LaneStashState:
    """Empty the stash rows of masked lanes (their pages return through
    FREE_ALL)."""
    return LaneStashState(
        pages=torch.where(mask[:, None], NO_BLOCK, stash.pages),
        depth=torch.where(mask, 0, stash.depth),
    )


def below_watermark(stash: LaneStashState, active: torch.Tensor,
                    watermark: int) -> torch.Tensor:
    """Lanes whose stash needs a bulk refill this step."""
    return active & (stash.depth < watermark)
