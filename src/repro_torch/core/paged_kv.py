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
the next one.  On a service shared by N engine shards each shard registers
its own namespaced pair (:func:`register_paged_tenants`), and every
function here indexes metadata through the tenant handles.

Deferred refills (``decode_append(defer_refill=True)``) return the step's
refill traffic as :class:`PendingDecodeOps` for the multi-engine burst
window.  The prefix cache (:class:`PrefixCache`, host-side) keeps
completed lanes' full pages under :data:`CACHE_OWNER`; a hit either copies
the cached K/V into fresh pages or splices the cached page ids into the
lane's block table with a refcount bump
(``admit_prefill_many(prefix_blocks=)``).  This slice serves the dense
family; the recurrent-state tenant, sliding-window recycling (and with it
the overflow flushes that ``PendingDecodeOps`` carries) and compaction
wait for later slices (ROADMAP.md, Queue 1).
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
                         stash_clear, stash_pop, stash_push_batch,
                         stash_set_rows, validate_stash_params)
from .packets import NO_BLOCK
from .scatter import add_drop, set_drop
from .support_core import StepStats

I32 = torch.int32

KV_TENANT = "kv_pages"
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


def register_paged_tenants(svc: AllocService, cfg: PagedKVConfig,
                           namespace: str = "") -> PagedTenants:
    """Register this config's tenant set on ``svc`` in class order
    (``kv_pages``, then ``scratch``), optionally namespaced: each shard of
    a multi-engine deployment calls this once on the one shared service
    before ``init_state``."""
    spec = [(KV_TENANT, cfg.num_pages)]
    if cfg.scratch_slots:
        spec.append((SCRATCH_TENANT, cfg.scratch_slots))
    by_base = {t.base_name: t
               for t in svc.register_tenants(spec, namespace=namespace)}
    return PagedTenants(service=svc, kv=by_base[KV_TENANT],
                        scratch=by_base.get(SCRATCH_TENANT))


def paged_tenants(cfg: PagedKVConfig, device: DeviceLike = None
                  ) -> PagedTenants:
    """A fresh service on ``device`` with this config's tenants registered
    in class order: ``kv_pages`` (class 0), then ``scratch``."""
    return register_paged_tenants(AllocService(device=device), cfg)


def init_paged_kv(cfg: PagedKVConfig, tenants: PagedTenants,
                  alloc: Optional[FreeListState] = None) -> PagedKVState:
    """Fresh paged-KV state on the tenants' device.  ``alloc`` installs an
    existing allocator state (the one state a multi-engine deployment
    shares across its shards) instead of a fresh one."""
    dev = tenants.service.device
    shape = (cfg.num_pages + 1, cfg.num_kv_layers, cfg.page_size,
             cfg.kv_heads, cfg.head_dim)
    L = cfg.max_lanes
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

    The burst carries one KV-page malloc per lane, one scratch malloc when
    the config has that tenant, and -- with the stash on -- one pre-charge
    refill per lane.  A sequence whose pages overflow its block-table row
    gets overwide packets, so all of them fail.  The KV of admitted lanes
    is written into their pages in place.

    Alias splice: with ``prefix_blocks`` / ``prefix_lens`` (page-aligned,
    padded with ``NO_BLOCK``), ``k`` / ``v`` / ``lengths`` describe the
    suffix only.  Each admitted lane's row becomes ``[its cached prefix
    pages | fresh suffix pages]``, the prefix pages' refcounts rise by one
    per lane (no burst, no K/V moved) and ``seq_lens`` covers both.
    """
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
    seq_lens[lanes_l] = torch.where(got, prefix_lens + lengths.to(I32), 0)
    active = state.active.clone()
    active[lanes_l] = got
    new = state._replace(alloc=alloc, block_tables=block_tables,
                         seq_lens=seq_lens, active=active, stash=stash,
                         scratch_slot=scratch)
    return new, stats


# --------------------------------------------------------------------------
# Decode: append one token per active lane; allocate pages at boundaries.
# --------------------------------------------------------------------------

class PendingDecodeOps(NamedTuple):
    """Deferrable allocator traffic of one decode step (``defer_refill``
    mode): the multi-engine burst window gathers these over a quantum for
    every shard and serves them with ONE merged commit.  Only sliding-window
    recycling produces flushes, and no ported configuration recycles, so
    ``flush_mask`` is all False here; the fields match the JAX package's."""

    below: torch.Tensor           # [L] bool: lanes wanting a stash refill
    flush_mask: torch.Tensor      # [L] bool: recycled pages that overflowed
    flush_blocks: torch.Tensor    # [L] int32: their ids (NO_BLOCK else)


def decode_append(
    cfg: PagedKVConfig,
    state: PagedKVState,
    new_k: torch.Tensor,          # [max_lanes, L, kv_heads, head_dim]
    new_v: torch.Tensor,
    tenants: PagedTenants,
    defer_refill: bool = False,
):
    """Append one token per active lane through the two-tier allocator.

    Boundary lanes pop their page from the stash; ONE gated burst carries
    emergency 1-page mallocs for stash misses and refills for every
    below-watermark lane, and skips all metadata work when no packet is
    live.  The new token's K/V is written into each lane's page in place.

    ``defer_refill=True`` keeps only the emergency mallocs in the step's
    burst (response width 1) and returns the refills as a third value,
    :class:`PendingDecodeOps`, for the caller's burst window.  Returns
    ``(state, DecodeStats)``, plus the pending ops in that mode.
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
    refill = S and not defer_refill
    below = below_watermark(stash, state.active, cfg.stash_watermark) if S \
        else torch.zeros((L,), dtype=torch.bool, device=dev)
    if refill:
        t_refill = burst.refill(kv, lane_ids, cfg.stash_refill, where=below)
    alloc, res = svc.commit(state.alloc, burst,
                            max_blocks_per_req=max(
                                1, cfg.stash_refill if refill else 1),
                            gated=True)

    new_blocks = res.blocks_for(t_malloc)[:, 0]
    e_got = res.ok_for(t_malloc) & missed
    got = got_stash | e_got
    page_for_lane = torch.where(got_stash, popped, new_blocks)
    tbl_idx = (pos // ps).clamp(0, cfg.max_pages_per_lane - 1)
    block_tables = set_drop(state.block_tables,
                            (torch.where(got, lane_ids, L), tbl_idx),
                            torch.where(got, page_for_lane, NO_BLOCK))

    if refill:
        r_got = res.ok_for(t_refill) & below
        stash = stash_push_batch(
            stash, res.blocks_for(t_refill)[:, :cfg.stash_refill],
            cfg.stash_refill, r_got)
        refill_failed = (below & ~r_got).sum(dtype=I32)
    else:
        # deferred refills fail (benignly) at the window commit, not here
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
    if not defer_refill:
        return new, dstats
    return new, dstats, PendingDecodeOps(
        below=below, flush_mask=torch.zeros_like(below),
        flush_blocks=torch.full((L,), NO_BLOCK, dtype=I32, device=dev))


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


def stage_single_frees(tenants: PagedTenants, burst, blocks) -> None:
    """Stage one owner-agnostic single free per listed KV page id."""
    blocks = torch.as_tensor(np.asarray(blocks, np.int32),
                             device=tenants.service.device)
    burst.free(tenants.kv, torch.zeros_like(blocks), blocks)


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


def validate_paged_kv(cfg: PagedKVConfig, state: PagedKVState,
                      tenants: PagedTenants,
                      cache: Optional[PrefixCache] = None) -> None:
    """Host-side I1–I6 check of the whole paged-KV allocator state: every
    KV page is exactly one of {central stack, lane stash, block-table
    referenced, prefix cache}, and its refcount equals its block-table
    in-degree (an aliased page once per lane) plus its cache and stash
    membership.  On a shared multi-engine state I1–I4 cover every shard's
    classes and I5/I6 this shard's KV class."""
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
