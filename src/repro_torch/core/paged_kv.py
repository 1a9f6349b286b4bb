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

Size classes, in registration order: ``kv_pages`` is class 0, then the
per-lane recurrent-state slots (``state_slots``, class 1, for the hybrid
family), then the per-lane ``scratch`` workspace (class 1, or 2
behind the state slots).  On a service shared by N engine shards each
shard registers its own namespaced set (:func:`register_paged_tenants`),
and every function here indexes metadata through the tenant handles,
never through a class number.

Deferred refills (``decode_append(defer_refill=True)``) return the step's
refill traffic as :class:`PendingDecodeOps` for the multi-engine burst
window.  The prefix cache (:class:`PrefixCache`, host-side) keeps
completed lanes' full pages under :data:`CACHE_OWNER`; a hit either copies
the cached K/V into fresh pages or splices the cached page ids into the
lane's block table with a refcount bump
(``admit_prefill_many(prefix_blocks=)``).  :func:`compact_kv` repacks
sole-owner lane pages between burst windows so the free space coalesces
(:func:`extent_stats` counts the runs admission got).

Sliding-window recycling (``decode_append(window=...)``, mixtral): after
each append the newest page that slid wholly out of the window leaves
the lane's block table (a ``NO_BLOCK`` hole) and goes back to the lane's
stash; where the stash is full or off it is flushed to the central stack
as a single free on the step's burst or, with ``defer_refill``, on the
window commit (``PendingDecodeOps.flush_mask``/``flush_blocks``).

**Split cache** (``PagedKVConfig.split_window``, a model whose windowed
and global layers sit side by side): the global layers keep their K/V in
``kv_pages`` as above, growing with the lane; the windowed layers keep
theirs in a second tenant, ``kv_window_pages`` (class 1, ahead of the
state slots and scratch), with pools, block tables and a stash of its
own (:class:`WindowKVState`, ``PagedKVState.win``), on the same
``seq_lens``.  Admission maps in it only the pages the window of the
prompt's last position can still see, at most ``ceil(window /
page_size) + 1`` a lane, so no dead page is ever mapped; each decode
append then recycles the one page that slid out of the window, which is
therefore every dead page (the single-pool path keeps a long prompt's
older dead pages, as the JAX package does).  Both tenants' packets ride
the step's one burst, the admission's and the window commit's.  The
decode step returns the K/V of the global layers first, then the
windowed layers', each in layer order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..alloc.service import (AllocService, BurstStats, TenantHandle,
                             TenantStats)
from ..alloc.eviction import get_eviction
from ..device import DeviceLike
from .freelist import FreeListState, validate_freelist
from .lane_stash import (LaneStashState, below_watermark, init_stash,
                         stash_clear, stash_pop, stash_push,
                         stash_push_batch, stash_set_rows,
                         validate_stash_params)
from .packets import NO_BLOCK
from .scatter import add_drop, set_drop
from .support_core import StepStats
from ..tracing import COUNTERS

I32 = torch.int32

#: Size classes of an engine's own service: ``kv_pages`` is class 0 and
#: ``state_slots``, when configured, class 1.  On a shared service a
#: tenant's class is its handle's ``size_class``, never these constants.
KV_CLASS = 0
STATE_CLASS = 1

#: Tenant names the paged KV registers on its service, in class order.
KV_TENANT = "kv_pages"
WINDOW_TENANT = "kv_window_pages"
STATE_TENANT = "state_slots"
SCRATCH_TENANT = "scratch"

#: Owner id of KV pages demoted into the prefix cache: far above any lane
#: id, below the FREE_ALL pad sentinel.  A lane's FREE_ALL matches ``owner
#: == lane`` and skips these pages; a single free is owner-agnostic, so
#: eviction reclaims them through the ordinary free path.
CACHE_OWNER = 1 << 30


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
    # per-lane recurrent-state slots (hybrid; 0 = no such tenant)
    state_slots: int = 0
    # per-lane workspace slots: the last tenant of the one support-core
    scratch_slots: int = 0
    # per-lane page stash (0 disables the tier)
    stash_size: int = 0
    stash_watermark: int = 2
    stash_refill: int = 4
    # split cache (0 = one pool): the KV layers ``window_layers`` see
    # ``split_window`` tokens and keep their K/V in the window tenant's
    # ``window_pages`` pages; ``num_kv_layers`` counts the others
    split_window: int = 0
    window_layers: tuple = ()
    window_pages: int = 0

    def __post_init__(self):
        if self.stash_size:
            validate_stash_params(self.stash_size, self.stash_watermark,
                                  self.stash_refill)
        if bool(self.split_window) != bool(self.window_layers) \
                or bool(self.split_window) != bool(self.window_pages):
            raise ValueError("a split cache sets split_window, "
                             "window_layers and window_pages together")

    @property
    def tokens_capacity(self) -> int:
        return self.num_pages * self.page_size

    @property
    def kv_layers(self) -> int:
        """KV layers of the model, in both pools."""
        return self.num_kv_layers + len(self.window_layers)

    @property
    def full_layers(self) -> tuple:
        """KV layers whose K/V lives in ``kv_pages``, in order."""
        win = set(self.window_layers)
        return tuple(i for i in range(self.kv_layers) if i not in win)

    @property
    def window_span(self) -> int:
        """Pages a lane's window tenant maps at most: the
        ``split_window + 1`` positions an append can still see, rounded
        out to pages."""
        return min(-(-self.split_window // self.page_size) + 1,
                   self.max_pages_per_lane)


def page_bytes(cfg: PagedKVConfig, layers: int) -> int:
    """K and V bytes of one page of ``layers`` layers."""
    return 2 * layers * cfg.page_size * cfg.kv_heads * cfg.head_dim \
        * torch.empty((), dtype=cfg.dtype).element_size()


class WindowKVState(NamedTuple):
    """A split cache's window tenant: its own block tables (``NO_BLOCK``
    below the window), pools and stash, on the lanes' ``seq_lens``."""

    block_tables: torch.Tensor    # [max_lanes, max_pages_per_lane] int32
    k_pages: torch.Tensor         # [window_pages + 1, L_win, ps, kv, hd]
    v_pages: torch.Tensor
    stash: LaneStashState


class PagedKVState(NamedTuple):
    alloc: FreeListState          # segregated metadata (support-core owned)
    block_tables: torch.Tensor    # [max_lanes, max_pages_per_lane] int32
    seq_lens: torch.Tensor        # [max_lanes] int32
    active: torch.Tensor          # [max_lanes] bool
    k_pages: torch.Tensor         # [num_pages + 1, L, page_size, kv_heads, head_dim]
    v_pages: torch.Tensor         # same
    stash: LaneStashState         # per-lane page stash
    scratch_slot: torch.Tensor    # [max_lanes] int32 workspace block (NO_BLOCK if none)
    state_slot: torch.Tensor      # [max_lanes] int32 recurrent-state slot (NO_BLOCK if none)
    win: Optional[WindowKVState] = None   # a split cache's window tenant


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

    # forwarders so DecodeStats reads like the StepStats it extends
    @property
    def mallocs(self):
        return self.core.mallocs

    @property
    def frees(self):
        return self.core.frees

    @property
    def blocks_allocated(self):
        return self.core.blocks_allocated

    @property
    def blocks_freed(self):
        return self.core.blocks_freed


class PagedTenants(NamedTuple):
    """One engine's allocator clients: the service and its tenant handles."""

    service: AllocService
    kv: TenantHandle
    state: Optional[TenantHandle] = None
    scratch: Optional[TenantHandle] = None
    window: Optional[TenantHandle] = None

    @property
    def handles(self) -> tuple:
        """The registered handles, in class order."""
        return tuple(t for t in (self.kv, self.window, self.state,
                                 self.scratch) if t is not None)


def register_paged_tenants(svc: AllocService, cfg: PagedKVConfig,
                           namespace: str = "") -> PagedTenants:
    """Register this config's tenant set on ``svc`` in class order
    (``kv_pages``, then ``kv_window_pages``, ``state_slots`` and
    ``scratch`` where configured),
    optionally namespaced: each shard of a multi-engine deployment calls
    this once on the one shared service before ``init_state``."""
    by_base = {t.base_name: t for t in svc.register_tenants(
        _tenant_spec(cfg), namespace=namespace)}
    return PagedTenants(service=svc, kv=by_base[KV_TENANT],
                        state=by_base.get(STATE_TENANT),
                        scratch=by_base.get(SCRATCH_TENANT),
                        window=by_base.get(WINDOW_TENANT))


def _tenant_spec(cfg: PagedKVConfig) -> list[tuple[str, int]]:
    """``(name, capacity)`` of each tenant, in class order."""
    spec = [(KV_TENANT, cfg.num_pages)]
    if cfg.split_window:
        spec.append((WINDOW_TENANT, cfg.window_pages))
    if cfg.state_slots:
        spec.append((STATE_TENANT, cfg.state_slots))
    if cfg.scratch_slots:
        spec.append((SCRATCH_TENANT, cfg.scratch_slots))
    return spec


def num_alloc_classes(cfg: PagedKVConfig) -> int:
    """Size classes (== tenants) this config's allocator carries."""
    return len(_tenant_spec(cfg))


def paged_service(cfg: PagedKVConfig, device: DeviceLike = None,
                  policy: str = "freelist") -> AllocService:
    """A fresh service on ``device`` running ``policy`` with this config's
    tenants registered in class order (:func:`paged_tenants`'s service).
    The JAX package caches one per config; a port service holds its
    device, so each call builds one."""
    return paged_tenants(cfg, device, policy).service


def paged_tenants(cfg: PagedKVConfig, device: DeviceLike = None,
                  policy: str = "freelist") -> PagedTenants:
    """A fresh service on ``device`` running ``policy``, with this
    config's tenants registered in class order: ``kv_pages`` (class 0),
    then ``kv_window_pages``, ``state_slots`` and ``scratch`` where
    configured."""
    return register_paged_tenants(AllocService(policy=policy, device=device),
                                  cfg)


def init_paged_kv(cfg: PagedKVConfig, tenants: PagedTenants,
                  alloc: Optional[FreeListState] = None) -> PagedKVState:
    """Fresh paged-KV state on the tenants' device.  ``alloc`` installs an
    existing allocator state (the one state a multi-engine deployment
    shares across its shards) instead of a fresh one."""
    dev = tenants.service.device
    shape = (cfg.num_pages + 1, cfg.num_kv_layers, cfg.page_size,
             cfg.kv_heads, cfg.head_dim)
    L = cfg.max_lanes
    win = None
    if cfg.split_window:
        wshape = (cfg.window_pages + 1, len(cfg.window_layers),
                  cfg.page_size, cfg.kv_heads, cfg.head_dim)
        win = WindowKVState(
            block_tables=torch.full((L, cfg.max_pages_per_lane), NO_BLOCK,
                                    dtype=I32, device=dev),
            k_pages=torch.zeros(wshape, dtype=cfg.dtype, device=dev),
            v_pages=torch.zeros(wshape, dtype=cfg.dtype, device=dev),
            stash=init_stash(L, cfg.stash_size, dev))
    return PagedKVState(
        alloc=tenants.service.init_state() if alloc is None else alloc,
        block_tables=torch.full((L, cfg.max_pages_per_lane), NO_BLOCK,
                                dtype=I32, device=dev),
        seq_lens=torch.zeros((L,), dtype=I32, device=dev),
        active=torch.zeros((L,), dtype=torch.bool, device=dev),
        k_pages=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        v_pages=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        stash=init_stash(L, cfg.stash_size, dev),
        scratch_slot=torch.full((L,), NO_BLOCK, dtype=I32, device=dev),
        state_slot=torch.full((L,), NO_BLOCK, dtype=I32, device=dev),
        win=win,
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
    prefix_blocks: Optional[torch.Tensor] = None,   # [B, P] int32 cache pages
    prefix_lens: Optional[torch.Tensor] = None,     # [B] int32 aliased tokens
) -> tuple[PagedKVState, BurstStats]:
    """Admit B prefilled sequences with a single support-core step.

    The burst carries one KV-page malloc per lane, one state-slot malloc
    and one scratch malloc when the config has those tenants, and -- with
    the stash on -- one pre-charge refill per lane.  A lane is admitted
    only when every packet but the pre-charge succeeded; the grants of a
    lane that failed stay owned by it until its FREE_ALL (the engine
    releases failed lanes at once).  A sequence whose pages overflow its
    block-table row gets overwide packets, so all of them fail.  The KV
    of admitted lanes is written into their pages in place.

    Alias splice: with ``prefix_blocks`` / ``prefix_lens`` (page-aligned,
    padded with ``NO_BLOCK``), ``k`` / ``v`` / ``lengths`` describe the
    suffix only.  Each admitted lane's row becomes ``[its cached prefix
    pages | fresh suffix pages]``, the prefix pages' refcounts rise by one
    per lane (no burst, no K/V moved) and ``seq_lens`` covers both.

    A split cache (``k``/``v`` over every KV layer, in layer order) maps
    the global layers' pages in ``kv_pages`` and, in the window tenant,
    only the pages the window of the last prompt position can still see
    (``malloc_run`` and pre-charge packets of its own on the same burst);
    a lane is admitted when both tenants granted it.  No prefix cache.
    """
    if cfg.split_window:
        if prefix_blocks is not None and prefix_blocks.shape[1]:
            raise NotImplementedError("a split cache has no prefix cache")
        full = torch.as_tensor(cfg.full_layers, device=k.device)
        win_idx = torch.as_tensor(cfg.window_layers, device=k.device)
        k_win, v_win = k.index_select(1, win_idx), v.index_select(1, win_idx)
        k, v = k.index_select(1, full), v.index_select(1, full)
    B, L, T = k.shape[:3]
    ps = cfg.page_size
    max_pages = (T + ps - 1) // ps
    lanes = lanes.to(I32)
    n_pages = (lengths.to(I32) + ps - 1) // ps                         # [B]
    if prefix_blocks is not None and prefix_blocks.shape[1] == 0:
        prefix_blocks = None                 # no lane aliases anything
    if prefix_blocks is None:
        prefix_lens = torch.zeros_like(n_pages)
    else:
        prefix_blocks = prefix_blocks.to(I32)
        prefix_lens = prefix_lens.to(I32)
    n_prefix = prefix_lens // ps
    fits = n_prefix + n_pages <= cfg.max_pages_per_lane
    pre = cfg.stash_refill if cfg.stash_size else 0
    resp_width = max(max_pages, pre)
    forced_fail = resp_width + 1
    one = torch.ones_like(n_pages)

    svc = tenants.service
    burst = svc.new_burst()
    t_kv = burst.malloc_run(tenants.kv, lanes,
                            n=torch.where(fits, n_pages, forced_fail))
    t_state = burst.malloc(tenants.state, lanes,
                           n=torch.where(fits, one, forced_fail)) \
        if cfg.state_slots else None
    t_scratch = burst.malloc(tenants.scratch, lanes,
                             n=torch.where(fits, one, forced_fail)) \
        if cfg.scratch_slots else None
    slot_tickets = [t for t in (t_state, t_scratch) if t is not None]
    if cfg.stash_size:
        t_pre = burst.refill(tenants.kv, lanes,
                             n=torch.where(fits, one * pre, forced_fail))
    if cfg.split_window:
        # the window tenant: the pages from the first one the window of
        # the last prompt position sees
        first_w = torch.div(lengths.to(I32) - cfg.split_window, ps,
                            rounding_mode="floor").clamp(min=0)
        n_win = n_pages - first_w
        t_win = burst.malloc_run(tenants.window, lanes,
                                 n=torch.where(fits, n_win, forced_fail))
        if cfg.stash_size:
            t_wpre = burst.refill(tenants.window, lanes,
                                  n=torch.where(fits, one * pre, forced_fail))
    alloc, res = svc.commit(state.alloc, burst, max_blocks_per_req=resp_width,
                            kind="admission")
    stats = res.stats
    if cfg.stash_size:
        # a failed pre-charge is benign: "failed" counts required packets
        kv_required = (~res.ok_for(t_kv)).sum(dtype=I32)
        required = kv_required
        for t in slot_tickets:
            required = required + (~res.ok_for(t)).sum(dtype=I32)
        pt = stats.per_tenant
        failed = pt.failed.clone()
        failed[tenants.kv.size_class] = kv_required
        if cfg.split_window:
            win_required = (~res.ok_for(t_win)).sum(dtype=I32)
            required = required + win_required
            failed[tenants.window.size_class] = win_required
        stats = stats._replace(core=stats.core._replace(failed=required),
                               per_tenant=pt._replace(failed=failed))

    pages = res.blocks_for(t_kv)[:, :max_pages]                        # [B, P]
    got = res.ok_for(t_kv)
    for t in slot_tickets:
        got = got & res.ok_for(t)
    if cfg.split_window:
        got = got & res.ok_for(t_win)
    M = cfg.max_pages_per_lane
    if prefix_blocks is None:
        p_lim = min(max_pages, M)
        rows = torch.full((B, M), NO_BLOCK, dtype=I32, device=lanes.device)
        rows[:, :p_lim] = torch.where(got[:, None], pages[:, :p_lim],
                                      NO_BLOCK)
    else:
        # row = [shared prefix pages | fresh suffix pages | NO_BLOCK]
        P = prefix_blocks.shape[1]
        pos = torch.arange(M, dtype=I32, device=lanes.device)[None, :]
        pref = prefix_blocks.gather(1, pos.clamp(0, P - 1).expand(B, M)
                                    .long())
        suf = pages.gather(1, (pos - n_prefix[:, None])
                           .clamp(0, max_pages - 1).long())
        in_pref = pos < n_prefix[:, None]
        in_suf = ~in_pref & (pos < (n_prefix + n_pages)[:, None])
        rows = torch.where(got[:, None] & in_pref, pref,
                           torch.where(got[:, None] & in_suf, suf, NO_BLOCK))
        # one reference per admitted lane; padded or failed slots go to
        # the sentinel past the row, which the bump skips
        valid_pref = (torch.arange(P, dtype=I32, device=lanes.device)[None, :]
                      < n_prefix[:, None]) & got[:, None]
        alloc = svc.bump_refcounts(
            alloc, tenants.kv,
            torch.where(valid_pref, prefix_blocks,
                        alloc.refcount.shape[1]).reshape(-1))
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

    def slot_rows(rows: torch.Tensor, ticket) -> torch.Tensor:
        rows = rows.clone()
        rows[lanes_l] = NO_BLOCK if ticket is None else torch.where(
            got, res.blocks_for(ticket)[:, 0], NO_BLOCK)
        return rows
    stash = state.stash
    if cfg.stash_size:
        stash = stash_set_rows(stash, lanes, res.blocks_for(t_pre)[:, :pre],
                               pre, res.ok_for(t_pre))
    seq_lens = state.seq_lens.clone()
    seq_lens[lanes_l] = torch.where(got, prefix_lens + lengths.to(I32), 0)
    active = state.active.clone()
    active[lanes_l] = got
    win = state.win
    if cfg.split_window:
        win = _admit_window(cfg, win, lanes_l, k_win, v_win, first_w, n_win,
                            got, res.blocks_for(t_win),
                            (res.blocks_for(t_wpre), res.ok_for(t_wpre))
                            if cfg.stash_size else None)
        # pages mapped at admission: counted on a split cache alone, whose
        # readers (kv_bytes_per_token's cell, chip_smoke 4n) exist
        COUNTERS.add_device(
            ("kv_pages.admitted_pages", "kv_window_pages.admitted_pages"),
            torch.stack([(rows != NO_BLOCK).sum(),
                         (win.block_tables[lanes_l] != NO_BLOCK).sum()]))
    new = state._replace(alloc=alloc, block_tables=block_tables,
                         seq_lens=seq_lens, active=active, stash=stash,
                         scratch_slot=slot_rows(state.scratch_slot, t_scratch),
                         state_slot=slot_rows(state.state_slot, t_state),
                         win=win)
    return new, stats


def _admit_window(cfg: PagedKVConfig, win: WindowKVState,
                  lanes: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  first: torch.Tensor, n_win: torch.Tensor,
                  got: torch.Tensor, granted: torch.Tensor, pre=None
                  ) -> WindowKVState:
    """The window tenant's side of an admission: each admitted lane's
    table maps slots ``[first, first + n_win)`` to its granted pages, and
    the windowed layers' K/V (``k``, ``v`` ``[B, L_win, T, kv, hd]``) of
    those pages alone is written into them; ``pre`` = (blocks, ok) of the
    stash pre-charge."""
    B, Lw, T = k.shape[:3]
    ps = cfg.page_size
    max_pages = (T + ps - 1) // ps
    span = min(cfg.window_span, max_pages)
    pages = granted[:, :span]
    M = cfg.max_pages_per_lane
    dev = lanes.device
    rel = torch.arange(M, dtype=I32, device=dev)[None, :] - first[:, None]
    mapped = (rel >= 0) & (rel < n_win[:, None]) & got[:, None]
    rows = torch.where(mapped, pages.gather(1, rel.clamp(0, span - 1).long()),
                       NO_BLOCK)
    block_tables = win.block_tables.clone()
    block_tables[lanes] = rows
    # the pages' K/V: slot first + i of each lane, i < span
    i = torch.arange(span, dtype=I32, device=dev)[None, :]
    slot = (first[:, None] + i).clamp(max=max_pages - 1).long()
    valid = (i < n_win[:, None]) & got[:, None]
    dst = torch.where(valid, pages, cfg.window_pages).reshape(-1).long()
    rows_b = torch.arange(B, device=dev)[:, None]
    for src, pool in ((k, win.k_pages), (v, win.v_pages)):
        src = torch.nn.functional.pad(src, (0, 0, 0, 0, 0, max_pages * ps - T))
        src = src.reshape(B, Lw, max_pages, ps, cfg.kv_heads, cfg.head_dim)
        pool[dst] = src[rows_b, :, slot].reshape(
            B * span, Lw, ps, cfg.kv_heads, cfg.head_dim).to(cfg.dtype)
    stash = win.stash
    if pre is not None:
        R = cfg.stash_refill
        stash = stash_set_rows(stash, lanes.to(I32), pre[0][:, :R], R, pre[1])
    return win._replace(block_tables=block_tables, stash=stash)


def admit_prefill(
    cfg: PagedKVConfig,
    state: PagedKVState,
    lane,                         # scalar int
    k: torch.Tensor,              # [L, T, kv_heads, head_dim]
    v: torch.Tensor,
    length,                       # scalar int, <= T
    tenants: PagedTenants,
) -> tuple[PagedKVState, BurstStats]:
    """Admit one prefilled sequence (batch-of-one
    :func:`admit_prefill_many`)."""
    dev = state.seq_lens.device
    lanes = torch.as_tensor(lane, dtype=I32, device=dev).reshape(1)
    lengths = torch.as_tensor(length, dtype=I32, device=dev).reshape(1)
    return admit_prefill_many(cfg, state, lanes, k[None], v[None], lengths,
                              tenants)


# --------------------------------------------------------------------------
# Decode: append one token per active lane; allocate pages at boundaries.
# --------------------------------------------------------------------------

class PendingDecodeOps(NamedTuple):
    """Deferrable allocator traffic of one decode step (``defer_refill``
    mode): the multi-engine burst window gathers these over a quantum for
    every shard and serves them with ONE merged commit.  Only sliding-window
    recycling produces flushes (a recycled page that found its lane's stash
    full or off); a flushed page stays owned by its lane, out of its table,
    until the window's commit frees it, so a release in the same window
    returns it once through the FREE_ALL and the free together.  A split
    cache's window tenant has its own (``window``)."""

    below: torch.Tensor           # [L] bool: lanes wanting a stash refill
    flush_mask: torch.Tensor      # [L] bool: recycled pages that overflowed
    flush_blocks: torch.Tensor    # [L] int32: their ids (NO_BLOCK else)
    window: Optional["PendingDecodeOps"] = None


def decode_append(
    cfg: PagedKVConfig,
    state: PagedKVState,
    new_k: torch.Tensor,          # [max_lanes, L, kv_heads, head_dim]
    new_v: torch.Tensor,
    tenants: PagedTenants,
    defer_refill: bool = False,
    window: Optional[int] = None,
):
    """Append one token per active lane through the two-tier allocator.

    Boundary lanes pop their page from the stash; ONE gated burst carries
    emergency 1-page mallocs for stash misses, refills for every
    below-watermark lane and, with ``window`` (sliding-window recycling),
    single frees of recycled pages that found the stash full, and skips
    all metadata work when no packet is live.  The new token's K/V is
    written into each lane's page in place.

    With ``window``, the newest page that lies wholly behind the window
    after this append leaves the lane's table and pushes to its stash
    first -- only that page: an older dead page that is still mapped (a
    prompt longer than ``window + 2 * page_size``) stays until the lane's
    release, as in the JAX package.

    A split cache does both at once: ``kv_pages`` as without ``window``
    for the global layers (``new_k[:, :num_kv_layers]``), and the window
    tenant, recycling past ``cfg.split_window``, for the windowed ones
    (the rest, in layer order), their packets on the same burst; a
    lane's token is appended when both tenants had its page.  Since its
    admission maps no dead page, its one recycled page a step is every
    dead page.

    ``defer_refill=True`` keeps only the emergency mallocs in the step's
    burst (response width 1) and returns the refills and flushes as a
    third value, :class:`PendingDecodeOps`, for the caller's burst window.
    Returns ``(state, DecodeStats)``, plus the pending ops in that mode.
    On a mesh (``DTensor`` state) the metadata work runs on every rank
    over the replicated allocator state
    (:func:`repro_torch.distributed.sharding.local_replicated`) and the
    K/V goes into each rank's shard of the pools
    (:func:`~repro_torch.distributed.sharding.pool_write`).
    """
    from ..distributed.sharding import local_replicated, pool_write
    win = state.win
    meta = state._replace(k_pages=None, v_pages=None, win=None if win is None
                          else win._replace(k_pages=None, v_pages=None))
    new, dst_page, win_page, offset, *rest = local_replicated(
        _append_metadata)(cfg, meta, tenants, defer_refill, window)
    if win is not None:
        n = cfg.num_kv_layers
        pool_write(win.k_pages, win_page, offset, new_k[:, n:])
        pool_write(win.v_pages, win_page, offset, new_v[:, n:])
        win = new.win._replace(k_pages=win.k_pages, v_pages=win.v_pages)
        new_k, new_v = new_k[:, :n], new_v[:, :n]
    pool_write(state.k_pages, dst_page, offset, new_k)
    pool_write(state.v_pages, dst_page, offset, new_v)
    return (new._replace(k_pages=state.k_pages, v_pages=state.v_pages,
                         win=win), *rest)


class _TenantStep(NamedTuple):
    """One KV tenant's side of a decode step, staged on the burst."""

    handle: TenantHandle
    block_tables: torch.Tensor
    stash: LaneStashState
    popped: torch.Tensor
    got_stash: torch.Tensor
    missed: torch.Tensor
    below: torch.Tensor
    overflow: torch.Tensor
    dead_block: torch.Tensor
    recycle: torch.Tensor
    t_malloc: object
    t_refill: object


def _stage_tenant(cfg: PagedKVConfig, handle: TenantHandle, block_tables,
                  stash: LaneStashState, active, pos, needs_page, burst,
                  refill: bool, defer_refill: bool,
                  window: Optional[int]) -> _TenantStep:
    """Pop the boundary lanes' stash, recycle the page that slid out of
    ``window``, and stage the tenant's emergency mallocs, refills and (not
    deferred) overflow frees on ``burst``, in that order."""
    L, S = cfg.max_lanes, cfg.stash_size
    dev = pos.device
    lane_ids = torch.arange(L, dtype=I32, device=dev)
    if S:
        stash, popped, got_stash = stash_pop(stash, needs_page)
        missed = needs_page & ~got_stash
    else:
        popped = torch.full((L,), NO_BLOCK, dtype=I32, device=dev)
        got_stash = torch.zeros((L,), dtype=torch.bool, device=dev)
        missed = needs_page
    none = torch.zeros_like(needs_page)
    overflow = recycle = none
    dead_block = torch.full_like(pos, NO_BLOCK)
    if window is not None:
        # after appending at pos, tokens < pos + 1 - window are dead; page
        # p is dead when (p + 1) * ps <= pos + 1 - window
        ps = cfg.page_size
        dead_idx = (pos + 1 - window) // ps - 1
        has_dead = active & (dead_idx >= 0) \
            & ((dead_idx + 1) * ps <= pos + 1 - window)
        safe_idx = dead_idx.clamp(0, cfg.max_pages_per_lane - 1)
        dead_block = block_tables[lane_ids.long(), safe_idx.long()]
        recycle = has_dead & (dead_block != NO_BLOCK)
        if S:
            stash, pushed = stash_push(stash, dead_block, recycle)
            overflow = recycle & ~pushed
        else:
            overflow = recycle
        block_tables = set_drop(block_tables,
                                (torch.where(recycle, lane_ids, L), safe_idx),
                                NO_BLOCK)
    t_malloc = burst.malloc(handle, lane_ids, 1, where=missed)
    below = below_watermark(stash, active, cfg.stash_watermark) if S \
        else none
    t_refill = burst.refill(handle, lane_ids, cfg.stash_refill,
                            where=below) if refill else None
    if window is not None and not defer_refill:
        burst.free(handle, lane_ids, dead_block, where=overflow)
    return _TenantStep(handle, block_tables, stash, popped, got_stash, missed,
                       below, overflow, dead_block, recycle, t_malloc,
                       t_refill)


def _finish_tenant(cfg: PagedKVConfig, st: _TenantStep, res, pos):
    """Install a tenant's boundary pages and refill grants after the
    burst: ``(block_tables, stash, got, e_got, refill_failed)``."""
    L = cfg.max_lanes
    lane_ids = torch.arange(L, dtype=I32, device=pos.device)
    new_blocks = res.blocks_for(st.t_malloc)[:, 0]
    e_got = res.ok_for(st.t_malloc) & st.missed
    got = st.got_stash | e_got
    page_for_lane = torch.where(st.got_stash, st.popped, new_blocks)
    tbl_idx = (pos // cfg.page_size).clamp(0, cfg.max_pages_per_lane - 1)
    block_tables = set_drop(st.block_tables,
                            (torch.where(got, lane_ids, L), tbl_idx),
                            torch.where(got, page_for_lane, NO_BLOCK))
    stash = st.stash
    if st.t_refill is not None:
        r_got = res.ok_for(st.t_refill) & st.below
        stash = stash_push_batch(
            stash, res.blocks_for(st.t_refill)[:, :cfg.stash_refill],
            cfg.stash_refill, r_got)
        refill_failed = (st.below & ~r_got).sum(dtype=I32)
    else:
        # deferred refills fail (benignly) at the window commit, not here
        refill_failed = torch.zeros((), dtype=I32, device=pos.device)
    return block_tables, stash, got, e_got, refill_failed


def _dst_page(cfg: PagedKVConfig, block_tables, writable, pos, sink: int):
    """Each lane's page for this token (``sink`` where it is not
    written)."""
    lane_ids = torch.arange(cfg.max_lanes, device=pos.device)
    tbl_idx = (pos // cfg.page_size).clamp(0, cfg.max_pages_per_lane - 1)
    cur = block_tables[lane_ids, tbl_idx.long()]
    return torch.where(writable & (cur != NO_BLOCK), cur, sink).long()


def _append_metadata(cfg: PagedKVConfig, state: PagedKVState,
                     tenants: PagedTenants, defer_refill: bool,
                     window: Optional[int]):
    """:func:`decode_append`'s allocator and table work: ``(state without
    pools, the kv_pages pages, the window tenant's pages (``None`` but in
    a split cache), the offsets to write, DecodeStats[,
    PendingDecodeOps])``."""
    ps = cfg.page_size
    S = cfg.stash_size
    pos = state.seq_lens
    needs_page = state.active & (pos % ps == 0) \
        & (pos // ps < cfg.max_pages_per_lane)
    refill = bool(S) and not defer_refill
    svc = tenants.service
    burst = svc.new_burst()
    kv = _stage_tenant(cfg, tenants.kv, state.block_tables, state.stash,
                       state.active, pos, needs_page, burst, refill,
                       defer_refill, window)
    steps = [kv]
    if state.win is not None:
        steps.append(_stage_tenant(
            cfg, tenants.window, state.win.block_tables, state.win.stash,
            state.active, pos, needs_page, burst, refill, defer_refill,
            cfg.split_window))
    alloc, res = svc.commit(state.alloc, burst,
                            max_blocks_per_req=max(
                                1, cfg.stash_refill if refill else 1),
                            gated=True, kind="decode")
    done = [_finish_tenant(cfg, st, res, pos) for st in steps]
    writable = state.active
    for _, _, got, _, _ in done:
        writable = writable & (got | ~needs_page)
    offset = (pos % ps).long()
    dst_page = _dst_page(cfg, done[0][0], writable, pos, cfg.num_pages)
    new = state._replace(alloc=alloc, block_tables=done[0][0],
                         seq_lens=torch.where(writable, pos + 1, pos),
                         stash=done[0][1])
    win_page = None
    if state.win is not None:
        win_page = _dst_page(cfg, done[1][0], writable, pos,
                             cfg.window_pages)
        new = new._replace(win=state.win._replace(block_tables=done[1][0],
                                                  stash=done[1][1]))
    _count_held(cfg, new, steps)
    def total(parts):
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out
    dstats = DecodeStats(
        core=res.stats.core,
        tenant=res.stats.per_tenant,
        failed=total([(st.missed & ~d[3]).sum(dtype=I32)
                      for st, d in zip(steps, done)]),
        refill_failed=total([d[4] for d in done]),
        stash_hits=total([st.got_stash.sum(dtype=I32) for st in steps]),
        stash_misses=total([st.missed.sum(dtype=I32) for st in steps]),
        bursts=res.live,
        stash_depth_hist=stash_depth_histogram(cfg, new.stash, state.active),
        queue_live=res.stats.queue_live,
        queue_capacity=res.stats.queue_capacity,
    )
    if not defer_refill:
        return new, dst_page, win_page, offset, dstats
    pend = [PendingDecodeOps(below=st.below, flush_mask=st.overflow,
                             flush_blocks=torch.where(st.overflow,
                                                      st.dead_block,
                                                      NO_BLOCK))
            for st in steps]
    if len(pend) > 1:
        pend[0] = pend[0]._replace(window=pend[1])
    return new, dst_page, win_page, offset, dstats, pend[0]


def _count_held(cfg: PagedKVConfig, state: PagedKVState,
                steps: list) -> None:
    """One decode step's :data:`~repro_torch.tracing.COUNTERS` on a split
    cache (no other cache counts: nothing reads it there): tokens the
    active lanes hold, each tenant's pages and bytes mapped for them, and
    the pages the window tenant recycled."""
    if state.win is None or state.seq_lens.device.type == "meta":
        return
    act = state.active
    full, win = (((tbl != NO_BLOCK) & act[:, None]).sum(dtype=torch.int64)
                 for tbl in (state.block_tables, state.win.block_tables))
    COUNTERS.add_device(
        ("kv.held_tokens", "kv_pages.held_pages", "kv_pages.held_bytes",
         "kv_window_pages.held_pages", "kv_window_pages.held_bytes",
         "kv_window_pages.recycled"),
        torch.stack([torch.where(act, state.seq_lens, 0).sum(
            dtype=torch.int64),
            full, full * page_bytes(cfg, cfg.num_kv_layers),
            win, win * page_bytes(cfg, len(cfg.window_layers)),
            steps[1].recycle.sum(dtype=torch.int64)]))


def empty_decode_stats(cfg: PagedKVConfig, tenants: PagedTenants
                       ) -> DecodeStats:
    """All-zero :class:`DecodeStats` of a step that issues no burst (the
    attention-free decode), shaped like a real one: ``[C]`` per-tenant
    rows over every class of the tenants' service, occupancy included."""
    dev = tenants.service.device
    z = torch.zeros((), dtype=I32, device=dev)
    zc = torch.zeros((tenants.service.num_classes,), dtype=I32, device=dev)
    return DecodeStats(
        core=StepStats(z, z, z, z, z), tenant=TenantStats(zc, zc, zc, zc, zc),
        failed=z, refill_failed=z, stash_hits=z, stash_misses=z, bursts=z,
        stash_depth_hist=torch.zeros((cfg.stash_size + 1,), dtype=I32,
                                     device=dev),
        queue_live=z, queue_capacity=z)


def stash_depth_histogram(cfg: PagedKVConfig, stash: LaneStashState,
                          active: torch.Tensor) -> torch.Tensor:
    """``[stash_size + 1]`` int32 histogram of active lanes' stash depth."""
    bins = cfg.stash_size + 1
    depth = stash.depth.clamp(0, cfg.stash_size)
    hist = torch.zeros((bins,), dtype=I32, device=depth.device)
    return add_drop(hist, (torch.where(active, depth, bins),), 1)


# --------------------------------------------------------------------------
# Prefix cache: KV pages that outlive their request (host-side metadata;
# payloads never move -- ownership is retagged to CACHE_OWNER on demotion
# and pages return through single frees on eviction).  A copy of the JAX
# package's cache.
# --------------------------------------------------------------------------

def default_page_hash(prev: int, page_tokens: np.ndarray) -> int:
    """Rolling per-page hash: fold one page of token ids into the running
    prefix hash.  Page i's key depends on every token in pages 0..i, so a
    probe can stop at the first divergent page.  Injectable (tests force
    collisions to prove the exact-token verification below catches them)."""
    h = prev & 0xFFFFFFFFFFFFFFFF
    for t in page_tokens:
        h = (h * 1000003 ^ (int(t) + 0x9E3779B9)) & 0xFFFFFFFFFFFFFFFF
    return h


@dataclasses.dataclass
class CacheEntry:
    """One cached KV page: the page's block id plus the FULL token prefix
    it closes (pages 0..i of some completed sequence).  ``pkey`` is the
    prefix's byte image — the content-stable identity used for exact
    verification, dedupe, and eviction-policy bookkeeping (block ids get
    recycled by the allocator; content keys never lie)."""
    key: int                 # rolling hash of the prefix (bucket index)
    tokens: np.ndarray       # [(i+1) * page_size] int32 full prefix
    pkey: bytes              # tokens.tobytes() — exact content identity
    block: int               # KV page id, owner-mapped to CACHE_OWNER


class PrefixCache:
    """Token-prefix → KV-page cache with pluggable eviction.

    Keyed per page by rolling prefix hash, so any prefix length can hit;
    every lookup verifies the full token prefix against the entry (hash
    collisions can never alias wrong-content pages).  The cache holds at
    most ``budget_pages`` pages; those pages stay allocated in the KV
    tenant's class (owner ``CACHE_OWNER``), so the budget is charged
    against the tenant quota and admission page math stays exact.

    Victim selection delegates to an eviction policy
    (:mod:`repro_torch.alloc.eviction`) keyed by entry content.  Evicting an entry cascades to
    its descendants (longer prefixes that extend it): probes walk from page
    0, so an entry whose ancestor is gone would be unreachable garbage.

    ``trace`` records the logical (insert/probe/alias/evict) event stream,
    the same as the JAX package's cache records.
    """

    def __init__(self, page_size: int, budget_pages: int, policy=None,
                 hash_fn: Optional[Callable[[int, np.ndarray], int]] = None):
        self.page_size = int(page_size)
        self.budget = int(budget_pages)
        self.policy = policy if policy is not None else get_eviction()
        self.hash_fn = hash_fn or default_page_hash
        self._chains: dict[int, list[CacheEntry]] = {}
        self._by_pkey: dict[bytes, CacheEntry] = {}
        # pkey -> outstanding lane references (zero-copy aliases, DESIGN.md
        # §12).  A pinned entry (refs > 0) sits in a live block table and
        # must never be evicted — its page would be rewritten under a
        # running lane.
        self._aliases: dict[bytes, int] = {}
        self.hits = 0            # probed requests that reused >= 1 page
        self.misses = 0          # probed requests with no reusable prefix
        self.inserts = 0         # pages demoted into the cache
        self.evictions = 0       # pages evicted (policy picks + cascades)
        self.dup_skips = 0       # demoted pages already cached (left to FREE_ALL)
        self.aliases = 0         # pages spliced into lane tables zero-copy
        self.trace: list[tuple] = []

    @property
    def pages(self) -> int:
        """Pages currently held (== entries; one page per entry)."""
        return len(self._by_pkey)

    def blocks(self) -> np.ndarray:
        """Sorted block ids held by the cache (the I5 cache partition)."""
        return np.sort(np.asarray(
            [e.block for e in self._by_pkey.values()], np.int64))

    # -- probe ------------------------------------------------------------
    def probe(self, tokens, touch: bool = False) -> tuple[int, list[int]]:
        """Longest cached prefix of ``tokens``: ``(cached_len, blocks)``.

        ``cached_len`` is a multiple of ``page_size`` and strictly less
        than ``len(tokens)`` — at least one suffix token always prefills,
        so admission still produces the seed logits.  ``touch=True`` is the
        admission-time lookup: it bumps eviction-policy recency, the
        hit/miss counters, and the replay trace; plan-time probes peek
        without side effects (they may run several times per admission).
        """
        tokens = np.asarray(tokens, np.int32)
        ps = self.page_size
        n = len(tokens) // ps
        if n and n * ps == len(tokens):
            n -= 1
        h = 0
        blocks: list[int] = []
        for i in range(n):
            h = self.hash_fn(h, tokens[i * ps:(i + 1) * ps])
            entry = None
            want = tokens[:(i + 1) * ps]
            for e in self._chains.get(h, ()):
                if len(e.tokens) == len(want) and \
                        np.array_equal(e.tokens, want):
                    entry = e
                    break
            if entry is None:
                break
            blocks.append(entry.block)
            if touch:
                self.policy.on_hit(entry.pkey)
        if touch:
            self.trace.append(("probe", tuple(int(t) for t in tokens)))
            if blocks:
                self.hits += 1
            else:
                self.misses += 1
        return len(blocks) * ps, blocks

    # -- alias (zero-copy hit admission) ----------------------------------
    def alias(self, tokens, n_pages: int) -> None:
        """Pin the first ``n_pages`` entries of ``tokens``' cached chain: a
        lane spliced their pages into its block table (DESIGN.md §12).  The
        caller bumps the device refcounts; this records the host-side pin so
        eviction skips the entries while any lane reads them.  One call per
        admitted lane; balanced by :meth:`unalias` at lane release."""
        tokens = np.asarray(tokens, np.int32)
        ps = self.page_size
        n = int(n_pages)
        for i in range(n):
            pkey = tokens[:(i + 1) * ps].tobytes()
            self._aliases[pkey] = self._aliases.get(pkey, 0) + 1
        self.aliases += n
        self.trace.append(
            ("alias", tuple(int(t) for t in tokens[:n * ps]), n))

    def unalias(self, tokens, n_pages: int) -> None:
        """Drop one lane's pin on the first ``n_pages`` entries of
        ``tokens``' chain (the lane released or was preempted; its single
        OP_FREEs decrement the device refcounts on the same burst)."""
        tokens = np.asarray(tokens, np.int32)
        ps = self.page_size
        n = int(n_pages)
        for i in range(n):
            pkey = tokens[:(i + 1) * ps].tobytes()
            left = self._aliases.get(pkey, 0) - 1
            if left > 0:
                self._aliases[pkey] = left
            else:
                self._aliases.pop(pkey, None)
        self.trace.append(
            ("unalias", tuple(int(t) for t in tokens[:n * ps]), n))

    @property
    def pinned(self) -> int:
        """Entries currently pinned by at least one lane alias."""
        return len(self._aliases)

    # -- demote (insert) --------------------------------------------------
    def insert(self, tokens, blocks) -> tuple[list[int], list[int], list[int]]:
        """Demote a completed sequence's full pages into the cache.

        ``blocks[i]`` is the page covering tokens ``[i*ps, (i+1)*ps)``.
        Returns ``(kept, skipped, evicted)`` block lists: ``kept`` must be
        owner-retagged to :data:`CACHE_OWNER` by the caller, ``skipped``
        (already-cached duplicates and over-budget tails) stay lane-owned
        for the lane's FREE_ALL to sweep, ``evicted`` are cache-owned
        victims the caller must free with single OP_FREEs.
        """
        tokens = np.asarray(tokens, np.int32)
        ps = self.page_size
        n = min(len(tokens) // ps, len(blocks))
        keep: list[tuple[int, np.ndarray, bytes, int]] = []
        skipped: list[int] = []
        h = 0
        for i in range(n):
            h = self.hash_fn(h, tokens[i * ps:(i + 1) * ps])
            prefix = tokens[:(i + 1) * ps]
            pkey = prefix.tobytes()
            if pkey in self._by_pkey:
                skipped.append(int(blocks[i]))
                self.dup_skips += 1
                self.policy.on_hit(pkey)
            else:
                keep.append((h, prefix, pkey, int(blocks[i])))
        self.trace.append(("insert", tuple(int(t) for t in tokens), n))

        evicted: list[int] = []
        while keep and self.pages + len(keep) > self.budget and self.pages:
            batch = self._evict_one()
            if not batch:        # every resident entry is pinned
                break
            evicted.extend(batch)
        if keep and self.pages + len(keep) > self.budget:
            # budget smaller than the insertable room (pinned residents, or
            # a chain longer than the whole budget): keep only the
            # shallowest pages (prefix property needs contiguity from page
            # 0 of the chain)
            cut = max(0, self.budget - self.pages)
            skipped.extend(b for _, _, _, b in keep[cut:])
            keep = keep[:cut]
        if keep:
            # an eviction cascade may have removed this chain's cached
            # ancestor mid-insert, orphaning the whole chain — unreachable
            # entries would leak pages, so skip the insert instead
            first = keep[0][1]
            if len(first) > ps and \
                    first[:-ps].tobytes() not in self._by_pkey:
                skipped.extend(b for _, _, _, b in keep)
                keep = []
        for h, prefix, pkey, block in keep:
            entry = CacheEntry(key=h, tokens=prefix, pkey=pkey, block=block)
            self._chains.setdefault(h, []).append(entry)
            self._by_pkey[pkey] = entry
            self.policy.on_insert(pkey)
            self.inserts += 1
        kept = [b for _, _, _, b in keep]
        return kept, skipped, evicted

    # -- evict ------------------------------------------------------------
    def _drop(self, entry: CacheEntry) -> None:
        chain = self._chains.get(entry.key, [])
        if entry in chain:
            chain.remove(entry)
            if not chain:
                del self._chains[entry.key]
        del self._by_pkey[entry.pkey]

    def _evict_one(self) -> list[int]:
        """Evict the policy's next evictABLE victim plus its descendants;
        returns the freed block ids (empty when the cache is drained or
        every remaining entry is pinned).

        Pinned entries (aliased into a live lane's block table, DESIGN.md
        §12) are skipped — and so is any victim with a pinned descendant,
        because the cascade would orphan it.  Skipped victims re-enter the
        policy via ``on_insert`` in skip order, a deterministic requeue the
        trace replay reproduces exactly."""
        skipped: list[bytes] = []
        freed: list[int] = []
        for _ in range(len(self._by_pkey)):
            pkey = self.policy.victim()
            if pkey is None:
                break
            victim = self._by_pkey[pkey]
            doomed = [victim] + [
                e for e in self._by_pkey.values()
                if len(e.pkey) > len(pkey) and e.pkey.startswith(pkey)]
            if any(e.pkey in self._aliases for e in doomed):
                skipped.append(pkey)
                continue
            for e in doomed:
                self._drop(e)
                if e is not victim:
                    self.policy.on_remove(e.pkey)
            self.evictions += len(doomed)
            freed = [e.block for e in doomed]
            break
        for pk in skipped:
            self.policy.on_insert(pk)
        return freed

    def evict_pages(self, n: int) -> list[int]:
        """Evict victims until at least ``n`` pages are freed, the cache
        drains, or only pinned (aliased) entries remain.  The admission
        shortfall path: freed blocks must be OP_FREEd by the caller before
        the pages are allocatable."""
        self.trace.append(("evict", int(n)))
        freed: list[int] = []
        while len(freed) < n and self.pages:
            batch = self._evict_one()
            if not batch:        # every resident entry is pinned
                break
            freed.extend(batch)
        return freed


# --------------------------------------------------------------------------
# Completion: free everything a set of lanes owns through FREE_ALL packets.
# --------------------------------------------------------------------------

def release_packets(
    cfg: PagedKVConfig,
    state: PagedKVState,
    lane_ids: torch.Tensor,       # [K] int32 packet slots; NO_LANE = empty
    tenants: PagedTenants,
    extra_free=None,
) -> tuple[PagedKVState, BurstStats]:
    """Release lanes through FREE_ALL packets in one support-core step (one
    ticket per tenant), then clear the lanes' metadata rows.  Duplicate
    lane ids are harmless (FREE_ALL is idempotent within a step).

    ``extra_free`` rides single KV-page frees on the same burst: the prefix
    cache's eviction victims and an aliased lane's references to cached
    pages (owner ``CACHE_OWNER``, which the FREE_ALLs skip; a single free
    is owner-agnostic)."""
    lane_ids = lane_ids.to(I32)
    valid = lane_ids >= 0
    safe = lane_ids.clamp(0, cfg.max_lanes - 1)
    svc = tenants.service
    burst = svc.new_burst()
    stage_release_ops(tenants, burst, safe, valid)
    if extra_free is not None and len(extra_free):
        stage_single_frees(tenants, burst, extra_free)
    alloc, res = svc.commit(state.alloc, burst, max_blocks_per_req=1,
                            kind="release")
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


def stage_single_frees(tenants: PagedTenants, burst, blocks) -> None:
    """Stage one owner-agnostic single free per listed KV page id."""
    blocks = torch.as_tensor(np.asarray(blocks, np.int32),
                             device=tenants.service.device)
    burst.free(tenants.kv, torch.zeros_like(blocks), blocks)


def clear_released_lanes(state: PagedKVState,
                         release_mask: torch.Tensor) -> PagedKVState:
    """Clear released lanes' metadata rows (block table, seq_lens, active,
    state and scratch slots, stash row, and a split cache's window table
    and stash rows); their blocks return through FREE_ALL."""
    keep = ~release_mask
    win = state.win
    if win is not None:
        win = win._replace(
            block_tables=torch.where(release_mask[:, None], NO_BLOCK,
                                     win.block_tables),
            stash=stash_clear(win.stash, release_mask))
    return state._replace(
        block_tables=torch.where(release_mask[:, None], NO_BLOCK,
                                 state.block_tables),
        seq_lens=torch.where(keep, state.seq_lens, 0),
        active=state.active & keep,
        stash=stash_clear(state.stash, release_mask),
        scratch_slot=torch.where(keep, state.scratch_slot, NO_BLOCK),
        state_slot=torch.where(keep, state.state_slot, NO_BLOCK),
        win=win,
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


def gather_kv(cfg: PagedKVConfig, state: PagedKVState, layer: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(k, v, valid)`` of one layer, materialized through the block
    tables (the reference gather; a ``NO_BLOCK`` slot reads page 0).

    k, v: ``[max_lanes, max_pages_per_lane * page_size, kv_heads, head_dim]``;
    valid: ``[max_lanes, max_pages_per_lane * page_size]`` bool.
    """
    tbl = state.block_tables                                  # [lanes, P]
    safe = torch.where(tbl == NO_BLOCK, 0, tbl).long()
    lanes, P = tbl.shape
    ps = cfg.page_size
    k = state.k_pages[safe, layer].reshape(lanes, P * ps, cfg.kv_heads,
                                           cfg.head_dim)
    v = state.v_pages[safe, layer].reshape(lanes, P * ps, cfg.kv_heads,
                                           cfg.head_dim)
    tok = torch.arange(P * ps, dtype=I32, device=tbl.device)[None, :]
    valid = (tok < state.seq_lens[:, None]) & \
        (tbl != NO_BLOCK).repeat_interleave(ps, dim=1)
    return k, v, valid & state.active[:, None]


def gather_kv_window(cfg: PagedKVConfig, state: PagedKVState, layer: int,
                     window: int):
    """``(k, v, pos, valid)`` of one layer over only the page slots that a
    sliding window of ``window`` tokens can still see (the slots below it
    were recycled).  A helper with the JAX package's semantics; the decode
    reads through :func:`gather_kv` (on the CPU) or the paged kernel.

    k, v: ``[max_lanes, W * page_size, kv_heads, head_dim]`` with ``W =
    min(ceil(window / page_size) + 1, max_pages_per_lane)``; pos: the
    absolute token positions ``[max_lanes, W * page_size]``; valid: bool
    of the same shape.
    """
    ps = cfg.page_size
    w_slots = min(-(-window // ps) + 1, cfg.max_pages_per_lane)
    lanes = cfg.max_lanes
    dev = state.seq_lens.device
    first = torch.div(state.seq_lens - window, ps, rounding_mode="floor") \
        .clamp(0, cfg.max_pages_per_lane - w_slots)
    slot = first[:, None] + torch.arange(w_slots, dtype=I32,
                                         device=dev)[None, :]
    tbl = torch.gather(state.block_tables, 1, slot.long())
    safe = torch.where(tbl == NO_BLOCK, 0, tbl).long()
    k = state.k_pages[safe, layer].reshape(lanes, w_slots * ps,
                                           cfg.kv_heads, cfg.head_dim)
    v = state.v_pages[safe, layer].reshape(lanes, w_slots * ps,
                                           cfg.kv_heads, cfg.head_dim)
    pos = (slot[:, :, None] * ps + torch.arange(ps, dtype=I32, device=dev)
           [None, None, :]).reshape(lanes, -1)
    valid = (pos < state.seq_lens[:, None]) \
        & (tbl != NO_BLOCK).repeat_interleave(ps, dim=1) \
        & state.active[:, None]
    return k, v, pos, valid


# --------------------------------------------------------------------------
# Checks.
# --------------------------------------------------------------------------

def live_pages(state: PagedKVState, tenants: PagedTenants) -> torch.Tensor:
    """Currently allocated KV pages of the engine's KV class."""
    return state.alloc.used[tenants.kv.size_class]


def kv_pages_in_use(cfg: PagedKVConfig, state: PagedKVState) -> np.ndarray:
    """Host-side ``[num_pages]`` bool: pages referenced by a block table."""
    tbl = state.block_tables.cpu().numpy()
    in_use = np.zeros((cfg.num_pages,), bool)
    in_use[tbl[tbl != NO_BLOCK]] = True
    return in_use


def extent_stats(block_tables, lanes=None) -> tuple[int, int]:
    """Host-side ``(contiguous_extents, pages)`` over block-table rows.

    An extent is a maximal run of consecutive page ids in one lane's row
    (``NO_BLOCK`` entries are skipped), so ``pages / extents`` is the mean
    run length: 1.0 when every page is an island, more when a run-aware
    policy (buddy) granted admission contiguous runs.  ``lanes`` restricts
    the count to those rows.
    """
    tbl = block_tables.cpu().numpy() if isinstance(block_tables,
                                                   torch.Tensor) \
        else np.asarray(block_tables)
    if lanes is not None:
        tbl = tbl[np.asarray(lanes)]
    extents = pages = 0
    for row in tbl:
        held = row[row != NO_BLOCK]
        if held.size == 0:
            continue
        pages += int(held.size)
        extents += 1 + int(np.count_nonzero(np.diff(held) != 1))
    return extents, pages


def _run_score(ids) -> tuple[int, int]:
    """``(largest run, -number of runs)`` of a set of ids: bigger is more
    coalesced."""
    best = run = extents = 0
    prev = None
    for f in sorted(ids):
        if prev is None or f != prev + 1:
            extents += 1
            run = 0
        run += 1
        best = max(best, run)
        prev = f
    return best, -extents


def compact_kv(cfg: PagedKVConfig, state: PagedKVState,
               tenants: PagedTenants, max_moves: Optional[int] = None,
               ) -> tuple[PagedKVState, int]:
    """One KV compaction pass, run between burst windows (the JAX
    package's ``compact_kv``, move for move).

    Sole-owner lane pages (``refcount == 1`` and ``owner == lane``) slide
    to one end of the page id space past the pages that never move: the
    sink page ``num_pages``, aliased pages (refcount >= 2),
    ``CACHE_OWNER`` residents and stash pages (outside the block tables).
    The movable pages take the lowest (or highest) cells of the movable +
    free id set; the pass keeps the direction that scores better on
    (largest free run, fewest free runs) and is a no-op when neither beats
    the current state.  ``max_moves`` keeps the moves nearest the packing
    end.

    Planned on the host from one read of the allocator rows and block
    tables.  A move copies the page's K/V, rewrites the one block-table
    slot naming it and moves its owner and refcount; moves may chain (a
    vacated cell is another move's destination), so every source page is
    gathered before any is written -- the pools are updated in place.
    ``free_top``, ``used`` and the counters are unchanged, and the free
    stack is rebuilt ascending.  The owner and refcount rows change through
    ``retag_blocks`` and ``bump_refcounts``, so an allocator-op trace
    carries the pass; the stack rebuild it does not carry, so a replay
    matches the run after the pass only under the bitmap and buddy
    policies (which rebuild the stack from the bitmap every burst), and
    ``loadgen.trace.certify_complete`` refuses a trace of a run that
    compacted under the free list.
    Returns ``(new_state, pages_moved)``.
    """
    cls = tenants.kv.size_class
    alloc = state.alloc
    owner = alloc.owner[cls].cpu().numpy()
    refc = alloc.refcount[cls].cpu().numpy()
    top = int(alloc.free_top[cls])
    stack = alloc.free_stack[cls].cpu().numpy()
    tbl = state.block_tables.cpu().numpy()
    free_ids = sorted(int(b) for b in stack[:top])
    if not free_ids:
        return state, 0

    movable: dict[int, tuple[int, int]] = {}       # id -> (lane, slot)
    for lane in range(tbl.shape[0]):
        for slot, b in enumerate(tbl[lane]):
            b = int(b)
            if b != NO_BLOCK and owner[b] == lane and refc[b] == 1:
                movable[b] = (lane, slot)
    if not movable:
        return state, 0

    movable_ids = sorted(movable)
    cells = sorted(set(movable_ids) | set(free_ids))
    M = len(movable_ids)
    cap = M if max_moves is None else min(max_moves, M)

    def plan(direction: str):
        targets = cells[:M] if direction == "low" else cells[-M:]
        pairs = [(s, d) for s, d in zip(movable_ids, targets) if s != d]
        if direction == "high":
            pairs.reverse()            # keep the moves nearest the top end
        pairs = pairs[:cap]
        after = (set(free_ids) | {s for s, _ in pairs}) \
            - {d for _, d in pairs}
        return pairs, _run_score(after), after

    lo, hi = plan("low"), plan("high")
    pairs, score, free_after = lo if lo[1] >= hi[1] else hi
    if score <= _run_score(free_ids) or not pairs:
        return state, 0

    src_np = np.asarray([s for s, _ in pairs], np.int64)
    dst_np = np.asarray([d for _, d in pairs], np.int64)
    dev = state.k_pages.device
    src = torch.as_tensor(src_np, device=dev)
    dst = torch.as_tensor(dst_np, device=dev)
    for pool in (state.k_pages, state.v_pages):
        pool[dst] = pool[src]          # the gather copies before the write

    lanes_np = np.asarray([movable[s][0] for s, _ in pairs])
    slots_np = np.asarray([movable[s][1] for s, _ in pairs])
    tbl[lanes_np, slots_np] = dst_np

    # dst inherits the page's identity from the pre-pass rows; only cells
    # vacated and not refilled become free
    own2, ref2 = owner.copy(), refc.copy()
    own2[dst_np] = owner[src_np]
    ref2[dst_np] = refc[src_np]
    vacated = np.asarray(sorted(set(src_np.tolist()) - set(dst_np.tolist())),
                         np.int64)
    own2[vacated] = -1
    ref2[vacated] = 0
    # the owner and refcount rows change through the service's retag and
    # refcount ops, so a trace recorder sees the pass as those events
    svc, kv = tenants.service, tenants.kv
    cells = np.flatnonzero(own2 != owner)
    for new_owner in np.unique(own2[cells]):
        alloc = svc.retag_blocks(alloc, kv, cells[own2[cells] == new_owner],
                                 int(new_owner))
    cells = np.flatnonzero(ref2 != refc)
    delta = ref2[cells].astype(np.int64) - refc[cells]
    for d in np.unique(delta):
        alloc = svc.bump_refcounts(alloc, kv, cells[delta == d], int(d))
    free_sorted = sorted(free_after)
    stack[: len(free_sorted)] = np.asarray(free_sorted, np.int32)
    free_stack = alloc.free_stack.clone()
    free_stack[cls] = torch.as_tensor(stack, device=free_stack.device)
    alloc = alloc._replace(free_stack=free_stack)
    return state._replace(alloc=alloc, block_tables=torch.as_tensor(
        tbl, device=state.block_tables.device)), len(pairs)


def validate_paged_kv(cfg: PagedKVConfig, state: PagedKVState,
                      tenants: PagedTenants,
                      cache: Optional[PrefixCache] = None) -> None:
    """Host-side I1–I6 check of the whole paged-KV allocator state: every
    KV page is exactly one of {central stack, lane stash, block-table
    referenced, prefix cache}, and its refcount equals its block-table
    in-degree (an aliased page once per lane) plus its cache and stash
    membership.  On a shared multi-engine state I1–I4 cover every shard's
    classes and I5/I6 this shard's KV class.  A split cache's window
    tenant gets I5/I6 over its own tables and stash (no prefix cache)."""
    if state.win is not None:
        _validate_tenant(state, tenants, tenants.window,
                         state.win.block_tables, state.win.stash)
    expected = np.zeros((state.alloc.max_capacity,), np.int64)
    tbl = state.block_tables.cpu().numpy()
    np.add.at(expected, tbl[tbl != NO_BLOCK], 1)
    sp = state.stash.pages.cpu().numpy()
    sd = state.stash.depth.cpu().numpy()
    for lane in range(sp.shape[0]):
        np.add.at(expected, sp[lane, :int(sd[lane])], 1)
    if cache is not None:
        np.add.at(expected, cache.blocks(), 1)
    validate_freelist(
        state.alloc,
        stash_pages=sp,
        stash_depth=sd,
        in_use=kv_pages_in_use(cfg, state),
        stash_class=tenants.kv.size_class,
        tenant_names=tenants.service.tenant_names(),
        refcount_expected=expected,
        cache_pages=cache.blocks() if cache is not None else None,
        cache_owner=CACHE_OWNER if cache is not None else None,
    )


def _validate_tenant(state: PagedKVState, tenants: PagedTenants,
                     handle: TenantHandle, block_tables: torch.Tensor,
                     stash: LaneStashState) -> None:
    """I1–I6 with one KV tenant's tables and stash as the I5 partition."""
    tbl = block_tables.cpu().numpy()
    sp = stash.pages.cpu().numpy()
    sd = stash.depth.cpu().numpy()
    expected = np.zeros((state.alloc.max_capacity,), np.int64)
    np.add.at(expected, tbl[tbl != NO_BLOCK], 1)
    for lane in range(sp.shape[0]):
        np.add.at(expected, sp[lane, :int(sd[lane])], 1)
    in_use = np.zeros((handle.capacity,), bool)
    in_use[tbl[tbl != NO_BLOCK]] = True
    validate_freelist(state.alloc, stash_pages=sp, stash_depth=sd,
                      in_use=in_use, stash_class=handle.size_class,
                      tenant_names=tenants.service.tenant_names(),
                      refcount_expected=expected)
