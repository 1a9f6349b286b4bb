"""Paged KV cache managed by the support-core (port of the device half of
:mod:`repro.core.paged_kv`).

KV pages are the "user data"; block tables and free lists are the
segregated metadata the support-core owns.  One page holds ``page_size``
tokens of K and V for every layer (one allocation per page covers all
layers):

    k_pages, v_pages : [num_pages + 1, num_kv_layers, page_size, kv_heads, head_dim]
    block_tables     : [max_lanes, max_pages_per_lane] int32
    seq_lens         : [max_lanes] int32

The pools carry one page more than the allocator hands out: page
``num_pages`` is a write sink for masked lanes, the counterpart of the JAX
package's ``mode="drop"`` scatter, so no boolean compaction (and no host
sync) sits on the decode path.  The pools are updated IN PLACE -- a JAX
state is a value, a port state shares its pools with the state it came
from -- while the allocator metadata stays out of place.

Size classes: ``kv_pages`` is class 0 and the per-lane ``scratch`` tenant
the next one.  This slice serves the dense family; the recurrent-state
tenant, sliding-window recycling, deferred refills, the prefix cache and
compaction wait for later slices (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..alloc.service import (AllocService, BurstStats, TenantHandle,
                             TenantStats)
from ..device import DeviceLike
from .freelist import FreeListState, validate_freelist
from .lane_stash import (LaneStashState, below_watermark, init_stash,
                         stash_clear, stash_pop, stash_push_batch,
                         stash_set_rows, validate_stash_params)
from .packets import NO_BLOCK
from .scatter import add_drop, set_drop
from .support_core import StepStats

I32 = torch.int32

KV_TENANT = "kv_pages"
SCRATCH_TENANT = "scratch"


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    num_kv_layers: int
    kv_heads: int
    head_dim: int
    page_size: int
    num_pages: int
    max_lanes: int
    max_pages_per_lane: int
    dtype: torch.dtype = torch.bfloat16
    # per-lane workspace slots: a second tenant of the one support-core
    scratch_slots: int = 0
    # per-lane page stash (0 disables the tier)
    stash_size: int = 0
    stash_watermark: int = 2
    stash_refill: int = 4

    def __post_init__(self):
        if self.stash_size:
            validate_stash_params(self.stash_size, self.stash_watermark,
                                  self.stash_refill)


class PagedKVState(NamedTuple):
    alloc: FreeListState          # segregated metadata (support-core owned)
    block_tables: torch.Tensor    # [max_lanes, max_pages_per_lane] int32
    seq_lens: torch.Tensor        # [max_lanes] int32
    active: torch.Tensor          # [max_lanes] bool
    k_pages: torch.Tensor         # [num_pages + 1, L, page_size, kv_heads, head_dim]
    v_pages: torch.Tensor         # same
    stash: LaneStashState         # per-lane page stash
    scratch_slot: torch.Tensor    # [max_lanes] int32 workspace block (NO_BLOCK if none)


class DecodeStats(NamedTuple):
    """Decode-step telemetry: the support-core stats plus the stash tier
    (the JAX ``DecodeStats``; ``bursts`` is 1 when the step's burst had a
    live packet)."""

    core: StepStats
    tenant: TenantStats
    failed: torch.Tensor          # on-path (emergency) malloc failures
    refill_failed: torch.Tensor   # benign speculative-refill failures
    stash_hits: torch.Tensor
    stash_misses: torch.Tensor
    bursts: torch.Tensor
    stash_depth_hist: torch.Tensor  # [stash_size + 1] active-lane histogram
    queue_live: torch.Tensor
    queue_capacity: torch.Tensor


class PagedTenants(NamedTuple):
    """One engine's allocator clients: the service and its tenant handles."""

    service: AllocService
    kv: TenantHandle
    scratch: Optional[TenantHandle] = None

    @property
    def handles(self) -> tuple:
        return tuple(t for t in (self.kv, self.scratch) if t is not None)


def paged_tenants(cfg: PagedKVConfig, device: DeviceLike = None
                  ) -> PagedTenants:
    """A fresh service on ``device`` with this config's tenants registered
    in class order: ``kv_pages`` (class 0), then ``scratch``."""
    svc = AllocService(device=device)
    kv = svc.register_tenant(KV_TENANT, cfg.num_pages)
    scratch = svc.register_tenant(SCRATCH_TENANT, cfg.scratch_slots) \
        if cfg.scratch_slots else None
    return PagedTenants(service=svc, kv=kv, scratch=scratch)


def init_paged_kv(cfg: PagedKVConfig, tenants: PagedTenants) -> PagedKVState:
    """Fresh paged-KV state on the tenants' device."""
    dev = tenants.service.device
    shape = (cfg.num_pages + 1, cfg.num_kv_layers, cfg.page_size,
             cfg.kv_heads, cfg.head_dim)
    L = cfg.max_lanes
    return PagedKVState(
        alloc=tenants.service.init_state(),
        block_tables=torch.full((L, cfg.max_pages_per_lane), NO_BLOCK,
                                dtype=I32, device=dev),
        seq_lens=torch.zeros((L,), dtype=I32, device=dev),
        active=torch.zeros((L,), dtype=torch.bool, device=dev),
        k_pages=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        v_pages=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        stash=init_stash(L, cfg.stash_size, dev),
        scratch_slot=torch.full((L,), NO_BLOCK, dtype=I32, device=dev),
    )


# --------------------------------------------------------------------------
# Admission (prefill): B lanes -> ceil(len_i / page_size) pages per lane,
# allocated by ONE support-core burst for the whole batch.
# --------------------------------------------------------------------------

def admit_prefill_many(
    cfg: PagedKVConfig,
    state: PagedKVState,
    lanes: torch.Tensor,          # [B] int32, distinct lane ids
    k: torch.Tensor,              # [B, L, T, kv_heads, head_dim]
    v: torch.Tensor,
    lengths: torch.Tensor,        # [B] int32, each <= T
    tenants: PagedTenants,
) -> tuple[PagedKVState, BurstStats]:
    """Admit B prefilled sequences with a single support-core step.

    The burst carries one KV-page malloc per lane, one scratch malloc when
    the config has that tenant, and -- with the stash on -- one pre-charge
    refill per lane.  A sequence whose pages overflow its block-table row
    gets overwide packets, so all of them fail.  The KV of admitted lanes
    is written into their pages in place.
    """
    B, L, T = k.shape[:3]
    ps = cfg.page_size
    max_pages = (T + ps - 1) // ps
    lanes = lanes.to(I32)
    n_pages = (lengths.to(I32) + ps - 1) // ps                         # [B]
    fits = n_pages <= cfg.max_pages_per_lane
    pre = cfg.stash_refill if cfg.stash_size else 0
    resp_width = max(max_pages, pre)
    forced_fail = resp_width + 1
    one = torch.ones_like(n_pages)

    svc = tenants.service
    burst = svc.new_burst()
    t_kv = burst.malloc_run(tenants.kv, lanes,
                            n=torch.where(fits, n_pages, forced_fail))
    t_scratch = burst.malloc(tenants.scratch, lanes,
                             n=torch.where(fits, one, forced_fail)) \
        if cfg.scratch_slots else None
    if cfg.stash_size:
        t_pre = burst.refill(tenants.kv, lanes,
                             n=torch.where(fits, one * pre, forced_fail))
    alloc, res = svc.commit(state.alloc, burst, max_blocks_per_req=resp_width)
    stats = res.stats
    if cfg.stash_size:
        # a failed pre-charge is benign: "failed" counts required packets
        kv_required = (~res.ok_for(t_kv)).sum(dtype=I32)
        required = kv_required
        if t_scratch is not None:
            required = required + (~res.ok_for(t_scratch)).sum(dtype=I32)
        pt = stats.per_tenant
        failed = pt.failed.clone()
        failed[tenants.kv.size_class] = kv_required
        stats = stats._replace(core=stats.core._replace(failed=required),
                               per_tenant=pt._replace(failed=failed))

    pages = res.blocks_for(t_kv)[:, :max_pages]                        # [B, P]
    got = res.ok_for(t_kv)
    if t_scratch is not None:
        got = got & res.ok_for(t_scratch)
    p_lim = min(max_pages, cfg.max_pages_per_lane)
    rows = torch.full((B, cfg.max_pages_per_lane), NO_BLOCK, dtype=I32,
                      device=lanes.device)
    rows[:, :p_lim] = torch.where(got[:, None], pages[:, :p_lim], NO_BLOCK)
    lanes_l = lanes.long()
    block_tables = state.block_tables.clone()
    block_tables[lanes_l] = rows

    # KV into the granted pages: [B, L, T, kv, hd] -> [B * P, L, ps, kv, hd];
    # rows of ungranted or unused pages go to the sink page
    pad = max_pages * ps - T
    kv_shape = (B, L, max_pages, ps, cfg.kv_heads, cfg.head_dim)
    valid = (torch.arange(max_pages, device=lanes.device)[None, :]
             < n_pages[:, None]) & got[:, None]
    dst = torch.where(valid, pages, cfg.num_pages).reshape(-1).long()
    for src, pool in ((k, state.k_pages), (v, state.v_pages)):
        src = torch.nn.functional.pad(src, (0, 0, 0, 0, 0, pad))
        src = src.reshape(kv_shape).transpose(1, 2).reshape(
            B * max_pages, L, ps, cfg.kv_heads, cfg.head_dim)
        pool[dst] = src.to(cfg.dtype)

    scratch = state.scratch_slot.clone()
    if t_scratch is not None:
        scratch[lanes_l] = torch.where(got, res.blocks_for(t_scratch)[:, 0],
                                       NO_BLOCK)
    else:
        scratch[lanes_l] = NO_BLOCK
    stash = state.stash
    if cfg.stash_size:
        stash = stash_set_rows(stash, lanes, res.blocks_for(t_pre)[:, :pre],
                               pre, res.ok_for(t_pre))
    seq_lens = state.seq_lens.clone()
    seq_lens[lanes_l] = torch.where(got, lengths.to(I32), 0)
    active = state.active.clone()
    active[lanes_l] = got
    new = state._replace(alloc=alloc, block_tables=block_tables,
                         seq_lens=seq_lens, active=active, stash=stash,
                         scratch_slot=scratch)
    return new, stats


# --------------------------------------------------------------------------
# Decode: append one token per active lane; allocate pages at boundaries.
# --------------------------------------------------------------------------

def decode_append(
    cfg: PagedKVConfig,
    state: PagedKVState,
    new_k: torch.Tensor,          # [max_lanes, L, kv_heads, head_dim]
    new_v: torch.Tensor,
    tenants: PagedTenants,
) -> tuple[PagedKVState, DecodeStats]:
    """Append one token per active lane through the two-tier allocator.

    Boundary lanes pop their page from the stash; ONE gated burst carries
    emergency 1-page mallocs for stash misses and refills for every
    below-watermark lane, and skips all metadata work when no packet is
    live.  The new token's K/V is written into each lane's page in place.
    """
    ps = cfg.page_size
    L = cfg.max_lanes
    S = cfg.stash_size
    dev = state.seq_lens.device
    pos = state.seq_lens
    lane_ids = torch.arange(L, dtype=I32, device=dev)
    needs_page = state.active & (pos % ps == 0) \
        & (pos // ps < cfg.max_pages_per_lane)

    stash = state.stash
    if S:
        stash, popped, got_stash = stash_pop(stash, needs_page)
        missed = needs_page & ~got_stash
    else:
        popped = torch.full((L,), NO_BLOCK, dtype=I32, device=dev)
        got_stash = torch.zeros((L,), dtype=torch.bool, device=dev)
        missed = needs_page

    svc, kv = tenants.service, tenants.kv
    burst = svc.new_burst()
    t_malloc = burst.malloc(kv, lane_ids, 1, where=missed)
    if S:
        below = below_watermark(stash, state.active, cfg.stash_watermark)
        t_refill = burst.refill(kv, lane_ids, cfg.stash_refill, where=below)
    alloc, res = svc.commit(state.alloc, burst,
                            max_blocks_per_req=max(1, cfg.stash_refill if S
                                                   else 1),
                            gated=True)

    new_blocks = res.blocks_for(t_malloc)[:, 0]
    e_got = res.ok_for(t_malloc) & missed
    got = got_stash | e_got
    page_for_lane = torch.where(got_stash, popped, new_blocks)
    tbl_idx = (pos // ps).clamp(0, cfg.max_pages_per_lane - 1)
    block_tables = set_drop(state.block_tables,
                            (torch.where(got, lane_ids, L), tbl_idx),
                            torch.where(got, page_for_lane, NO_BLOCK))

    if S:
        r_got = res.ok_for(t_refill) & below
        stash = stash_push_batch(
            stash, res.blocks_for(t_refill)[:, :cfg.stash_refill],
            cfg.stash_refill, r_got)
        refill_failed = (below & ~r_got).sum(dtype=I32)
    else:
        refill_failed = torch.zeros((), dtype=I32, device=dev)

    writable = state.active & (got | ~needs_page)
    cur_block = block_tables[lane_ids.long(), tbl_idx.long()]
    offset = (pos % ps).long()
    dst_page = torch.where(writable & (cur_block != NO_BLOCK), cur_block,
                           cfg.num_pages).long()
    state.k_pages[dst_page, :, offset] = new_k.to(cfg.dtype)
    state.v_pages[dst_page, :, offset] = new_v.to(cfg.dtype)

    new = state._replace(alloc=alloc, block_tables=block_tables,
                         seq_lens=torch.where(writable, pos + 1, pos),
                         stash=stash)
    dstats = DecodeStats(
        core=res.stats.core,
        tenant=res.stats.per_tenant,
        failed=(missed & ~e_got).sum(dtype=I32),
        refill_failed=refill_failed,
        stash_hits=got_stash.sum(dtype=I32),
        stash_misses=missed.sum(dtype=I32),
        bursts=res.live,
        stash_depth_hist=stash_depth_histogram(cfg, stash, state.active),
        queue_live=res.stats.queue_live,
        queue_capacity=res.stats.queue_capacity,
    )
    return new, dstats


def stash_depth_histogram(cfg: PagedKVConfig, stash: LaneStashState,
                          active: torch.Tensor) -> torch.Tensor:
    """``[stash_size + 1]`` int32 histogram of active lanes' stash depth."""
    bins = cfg.stash_size + 1
    depth = stash.depth.clamp(0, cfg.stash_size)
    hist = torch.zeros((bins,), dtype=I32, device=depth.device)
    return add_drop(hist, (torch.where(active, depth, bins),), 1)


# --------------------------------------------------------------------------
# Completion: free everything a set of lanes owns through FREE_ALL packets.
# --------------------------------------------------------------------------

def release_packets(
    cfg: PagedKVConfig,
    state: PagedKVState,
    lane_ids: torch.Tensor,       # [K] int32 packet slots; NO_LANE = empty
    tenants: PagedTenants,
) -> tuple[PagedKVState, BurstStats]:
    """Release lanes through FREE_ALL packets in one support-core step (one
    ticket per tenant), then clear the lanes' metadata rows.  Duplicate
    lane ids are harmless (FREE_ALL is idempotent within a step)."""
    lane_ids = lane_ids.to(I32)
    valid = lane_ids >= 0
    safe = lane_ids.clamp(0, cfg.max_lanes - 1)
    svc = tenants.service
    burst = svc.new_burst()
    stage_release_ops(tenants, burst, safe, valid)
    alloc, res = svc.commit(state.alloc, burst, max_blocks_per_req=1)
    release_mask = set_drop(
        torch.zeros((cfg.max_lanes,), dtype=torch.bool, device=safe.device),
        (torch.where(valid, safe, cfg.max_lanes),), True)
    return clear_released_lanes(state._replace(alloc=alloc),
                                release_mask), res.stats


def stage_release_ops(tenants: PagedTenants, burst, lane_ids: torch.Tensor,
                      valid) -> None:
    """Stage one FREE_ALL packet per tenant per lane slot onto a burst."""
    for t in tenants.handles:
        burst.free_all(t, lane_ids, where=valid)


def clear_released_lanes(state: PagedKVState,
                         release_mask: torch.Tensor) -> PagedKVState:
    """Clear released lanes' metadata rows (block table, seq_lens, active,
    scratch slot, stash row); their blocks return through FREE_ALL."""
    keep = ~release_mask
    return state._replace(
        block_tables=torch.where(release_mask[:, None], NO_BLOCK,
                                 state.block_tables),
        seq_lens=torch.where(keep, state.seq_lens, 0),
        active=state.active & keep,
        stash=stash_clear(state.stash, release_mask),
        scratch_slot=torch.where(keep, state.scratch_slot, NO_BLOCK),
    )


def release_lanes(
    cfg: PagedKVConfig,
    state: PagedKVState,
    release_mask: torch.Tensor,   # [max_lanes] bool
    tenants: PagedTenants,
) -> tuple[PagedKVState, BurstStats]:
    """Dense-mask release, routed through the packet path."""
    lane_ids = torch.where(
        release_mask, torch.arange(cfg.max_lanes, dtype=I32,
                                   device=release_mask.device), -1)
    return release_packets(cfg, state, lane_ids, tenants)


# --------------------------------------------------------------------------
# Gather (decode's read of the allocator-managed pages) and checks.
# --------------------------------------------------------------------------

def gather_kv(
    cfg: PagedKVConfig,
    state: PagedKVState,
    layer: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(k, v, valid)`` for one layer: k, v ``[max_lanes, P * page_size,
    kv_heads, head_dim]``, valid ``[max_lanes, P * page_size]`` bool."""
    tbl = state.block_tables
    safe = torch.where(tbl == NO_BLOCK, 0, tbl).long()
    lanes, P = tbl.shape
    ps = cfg.page_size
    k = state.k_pages[safe, layer].reshape(lanes, P * ps, cfg.kv_heads,
                                           cfg.head_dim)
    v = state.v_pages[safe, layer].reshape(lanes, P * ps, cfg.kv_heads,
                                           cfg.head_dim)
    tok = torch.arange(P * ps, dtype=I32, device=tbl.device)[None, :]
    valid = (tok < state.seq_lens[:, None]) \
        & (tbl != NO_BLOCK).repeat_interleave(ps, dim=1)
    return k, v, valid & state.active[:, None]


def live_pages(state: PagedKVState, tenants: PagedTenants) -> torch.Tensor:
    """Currently allocated KV pages of the engine's KV class."""
    return state.alloc.used[tenants.kv.size_class]


def kv_pages_in_use(cfg: PagedKVConfig, state: PagedKVState) -> np.ndarray:
    """Host-side ``[num_pages]`` bool: pages referenced by a block table."""
    tbl = state.block_tables.cpu().numpy()
    in_use = np.zeros((cfg.num_pages,), bool)
    in_use[tbl[tbl != NO_BLOCK]] = True
    return in_use


def validate_paged_kv(cfg: PagedKVConfig, state: PagedKVState,
                      tenants: PagedTenants) -> None:
    """Host-side I1–I6 check of the whole paged-KV allocator state: every
    KV page is exactly one of {central stack, lane stash, block-table
    referenced}, and its refcount equals its block-table in-degree plus its
    stash membership."""
    expected = np.zeros((state.alloc.max_capacity,), np.int64)
    tbl = state.block_tables.cpu().numpy()
    np.add.at(expected, tbl[tbl != NO_BLOCK], 1)
    sp = state.stash.pages.cpu().numpy()
    sd = state.stash.depth.cpu().numpy()
    for lane in range(sp.shape[0]):
        np.add.at(expected, sp[lane, :int(sd[lane])], 1)
    validate_freelist(
        state.alloc,
        stash_pages=sp,
        stash_depth=sd,
        in_use=kv_pages_in_use(cfg, state),
        stash_class=tenants.kv.size_class,
        tenant_names=tenants.service.tenant_names(),
        refcount_expected=expected,
    )
