"""Serving engine: scheduler-driven continuous batching on the paged KV
(port of :mod:`repro.serve.engine`, dense family).

Admission is batched: one prefill per (prompt bucket, cached prefix)
group, then ONE support-core burst (``paged_kv.admit_prefill_many``) for
the whole batch.  Each decode step ends in one gated burst, and completion
releases lanes through FREE_ALL packets -- admit, append and release all
speak the packet protocol.  On the card every one of those bursts is one
launch of the support-core CUDA kernel.

An engine can be one shard of a multi-engine deployment
(:mod:`repro_torch.serve.multi_engine`): it then runs on a namespaced
tenant set of a shared service (``tenants=``, ``alloc_state=``) and
with ``defer_refill`` hands its refills to the burst window
(``pending_ops``).

The prefix cache (``prefix_cache=True``) keeps completed lanes' full
pages; an admission whose prompt opens with a cached prefix prefills only
the rest, over the cached K/V.  ``prefix_alias="copy"`` writes the cached
K/V into fresh lane pages, ``"alias"`` splices the cached page ids into
the lane's block table with a refcount bump (full attention only: a
windowed architecture falls back to copy, as in the JAX package).

Left for later slices (ROADMAP.md, Queue 1): compaction and the
contiguity telemetry that goes with it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..alloc.eviction import get_eviction
from ..core import paged_kv as pkv
from ..core.paged_kv import PagedKVConfig
from ..device import DeviceLike, resolve_device
from ..models.transformer import DenseLM
from .scheduler import (SchedulerConfig, make_scheduler_config, pick_bucket,
                        release_packet_array)
from .serve_step import (ServeState, make_decode_step, make_family_prefill)

I32 = torch.int32


@dataclasses.dataclass
class EngineStats:
    admitted: int = 0
    completed: int = 0
    decode_steps: int = 0
    preemptions: int = 0           # running lanes evicted by the scheduler
    alloc_failures: int = 0        # failed malloc packets
    hmq_admit_bursts: int = 0      # support-core steps issued for admission
    prefill_passes: int = 0        # prefill forward passes (one per bucket)
    hmq_release_bursts: int = 0    # release/eviction bursts issued
    # --- stash front-end telemetry ---
    decode_bursts: int = 0         # decode steps whose burst had a live packet
    stash_hits: int = 0            # boundary pages served by the lane stash
    stash_misses: int = 0          # boundary pages that needed a central malloc
    stash_depth_hist: list = dataclasses.field(default_factory=list)
    # --- multi-tenant telemetry ---
    tenants: dict = dataclasses.field(default_factory=dict)
    burst_slots_live: int = 0      # non-NOP slots across all issued bursts
    burst_slots_capacity: int = 0  # total slots across all issued bursts
    # --- prefix-cache telemetry ---
    cache_hits: int = 0            # admissions that reused >= 1 cached page
    cache_misses: int = 0          # probed admissions with no cached prefix
    cache_inserts: int = 0         # pages demoted into the cache
    cache_evictions: int = 0       # pages evicted from the cache
    cache_pages: int = 0           # pages the cache holds right now
    prefill_tokens_saved: int = 0  # prompt tokens skipped via cached pages
    aliased_pages: int = 0         # cache pages spliced into lane tables
    cache_hit_copy_bytes: int = 0  # prefix K/V bytes copied at hit admission
    cache_hit_admits: int = 0      # admission batches with >= 1 hit
    cache_hit_admit_us: float = 0.0  # wall time of those batches

    @property
    def hit_admit_us(self) -> float:
        """Mean wall microseconds of an admission batch with a hit."""
        if not self.cache_hit_admits:
            return 0.0
        return self.cache_hit_admit_us / self.cache_hit_admits

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    @property
    def commits(self) -> int:
        """Support-core commits this engine made (each one kernel launch
        on the card; a decode step commits even when its gate skips).  A
        multi-engine shard's deferred traffic rides the window's merged
        commit, which the deployment counts."""
        return (self.hmq_admit_bursts + self.decode_steps
                + self.hmq_release_bursts)

    @property
    def stash_hit_rate(self) -> float:
        total = self.stash_hits + self.stash_misses
        return self.stash_hits / total if total else 0.0

    @property
    def hmq_bursts_per_1k_decode_steps(self) -> float:
        if not self.decode_steps:
            return 0.0
        return 1000.0 * self.decode_bursts / self.decode_steps

    @property
    def burst_occupancy(self) -> float:
        if not self.burst_slots_capacity:
            return 0.0
        return self.burst_slots_live / self.burst_slots_capacity


class AdmissionItem(NamedTuple):
    """One sequence the scheduler asks the engine to install."""

    lane: int
    tokens: np.ndarray                    # [T] int32
    cached_len: int = 0                   # prefix tokens served by the cache


def run_admission(eng: "ServingEngine", sched, preemption: bool = False,
                  after_op=None) -> bool:
    """One admission pass: plan under the page budget, admit the batch,
    record the admission-seeded first tokens, and retire requests the seed
    finished.  Returns whether anything was admitted.

    When admission is stuck, cold cached pages go first (the prefix
    cache's shortfall eviction), then, with ``preemption``, a
    lower-priority running lane.  With the cache on, planning probes it so
    each request is bucketed by its uncached suffix.  ``after_op`` runs
    after every engine-side allocator op (the multi-engine loop passes its
    shared-state pull)."""
    sync = after_op if after_op is not None else (lambda: None)
    probe = eng.cache_probe if eng.cache is not None else None
    alias = eng.alias_enabled
    plan = sched.plan_admission(eng.free_pages, probe=probe, alias=alias)
    if not plan.size and eng.cache is not None and eng.cache.pages:
        short = sched.head_shortfall(eng.free_pages)
        if short is not None and eng.cache_release(short):
            sync()
            # the eviction may have shortened the head's cached prefix
            plan = sched.plan_admission(eng.free_pages, probe=probe,
                                        alias=alias)
    if not plan.size and preemption:
        lane = sched.preempt_victim(free_pages=eng.free_pages)
        if lane is not None:
            eng.preempt([lane])
            sync()
            sched.preempt(lane)
            plan = sched.plan_admission(eng.free_pages, probe=probe,
                                        alias=alias)
    if not plan.size:
        return False
    items = [AdmissionItem(lane, r.tokens, r.cached_len)
             for b in plan.batches for lane, r in b.items]
    failed = eng.admit_many(items)
    sync()
    sched.commit_admission(plan)
    if failed:
        sched.fail_admission(failed)
        print(f"WARNING: allocator rejected admission of "
              f"{len(failed)} request(s) (pool exhausted)")
    done0 = sched.note_admission(eng.admitted_tokens)
    if done0:
        kv_toks = {lane: sched.kv_token_prefix(lane) for lane in done0} \
            if eng.cache is not None else None
        eng.release(done0, kv_tokens=kv_toks)
        sync()
        sched.complete(done0)
    return True


class ServingEngine:
    """Continuous-batching engine; lanes are slots in the running batch.

    ``device`` defaults to ``cuda`` (raising on a host without a card);
    ``params`` must live on the same device.  ``tenants`` installs a
    namespaced tenant set of a shared service and ``alloc_state`` that
    service's one allocator state (a multi-engine shard).
    ``eviction`` names the prefix cache's policy and ``prefix_alias`` its
    hit admission mode (the JAX package's defaults: ``lru``, ``copy``).
    """

    def __init__(self, cfg: ArchConfig, kvcfg: PagedKVConfig,
                 params: DenseLM,
                 sched_cfg: Optional[SchedulerConfig] = None,
                 device: DeviceLike = None,
                 tenants: Optional[pkv.PagedTenants] = None,
                 alloc_state=None,
                 defer_refill: bool = False,
                 prefix_cache: bool = False,
                 eviction: str = "lru",
                 cache_pages: Optional[int] = None,
                 prefix_alias: str = "copy"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.kvcfg = kvcfg
        self.params = params
        self.sched_cfg = sched_cfg or make_scheduler_config(cfg, kvcfg)
        self.tenants = tenants if tenants is not None \
            else pkv.paged_tenants(kvcfg, self.device)
        self.service = self.tenants.service
        if self.service.device != self.device:
            raise ValueError(f"tenants live on {self.service.device}, the "
                             f"engine on {self.device}")
        self.defer_refill = defer_refill
        self.pending_ops: list = []
        self.cache: Optional[pkv.PrefixCache] = None
        if prefix_cache:
            budget = cache_pages if cache_pages is not None \
                else kvcfg.num_pages // 2
            self.cache = pkv.PrefixCache(kvcfg.page_size, budget,
                                         policy=get_eviction(eviction))
        if prefix_alias not in ("copy", "alias"):
            raise ValueError(
                f"prefix_alias must be 'copy' or 'alias', got {prefix_alias!r}")
        self.prefix_alias = prefix_alias
        # lane -> (pinned token prefix, shared block ids) for lanes whose
        # block tables reference cache-owned pages
        self._aliased: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self.admitted_tokens: dict[int, int] = {}
        self.state = ServeState(
            paged=pkv.init_paged_kv(kvcfg, self.tenants, alloc=alloc_state),
            tokens=torch.zeros((kvcfg.max_lanes,), dtype=I32,
                               device=self.device))
        self._decode = make_decode_step(cfg, kvcfg, self.tenants,
                                        defer_refill=defer_refill)
        self._prefill = make_family_prefill(cfg)
        self.stats = EngineStats()

    # ---------------- multi-tenant telemetry ----------------

    def _note_burst(self, per_tenant, queue_live=None, queue_capacity=None,
                    issued: bool = True) -> None:
        """Fold one burst's per-tenant breakdown (and its slot occupancy,
        when the burst was issued) into EngineStats: one device-to-host
        copy for all of it."""
        fields = torch.stack([*per_tenant]).cpu().tolist()
        pt = dict(zip(per_tenant._fields, fields))
        for t in self.tenants.handles:
            d = self.stats.tenants.setdefault(t.name, {
                "mallocs": 0, "failed": 0, "blocks_allocated": 0,
                "blocks_freed": 0, "used": 0, "quota": t.quota,
            })
            c = t.size_class
            for k in ("mallocs", "failed", "blocks_allocated", "blocks_freed"):
                d[k] += pt[k][c]
            d["used"] = pt["used"][c]
        if issued and queue_live is not None:
            self.stats.burst_slots_live += int(queue_live)
            self.stats.burst_slots_capacity += int(queue_capacity)

    def tenant_report(self) -> dict[str, dict]:
        """Per-tenant occupancy/quota/counters of the live allocator state,
        for this engine's tenants only."""
        return self.service.tenant_report(self.state.paged.alloc,
                                          tenants=self.tenants.handles)

    # ---------------- prefix cache ----------------

    @property
    def alias_enabled(self) -> bool:
        """Zero-copy hit admission is live: alias mode, the cache on, and
        full attention (a windowed architecture falls back to copy)."""
        return (self.prefix_alias == "alias" and self.cache is not None
                and self.cfg.attn_pattern == "full")

    def _unalias_lanes(self, lanes: Sequence[int]) -> list[int]:
        """Drop released lanes' references to cached pages: unpin the
        entries and return the page ids, which the caller MUST ride as
        single frees (a lane's FREE_ALL skips CACHE_OWNER pages)."""
        blocks: list[int] = []
        for lane in lanes:
            rec = self._aliased.pop(int(lane), None)
            if rec is None:
                continue
            toks, blks = rec
            self.cache.unalias(toks, len(blks))
            blocks.extend(int(b) for b in blks)
        return blocks

    def _sync_cache_stats(self) -> None:
        """Mirror the cache's cumulative counters into EngineStats."""
        if self.cache is None:
            return
        self.stats.cache_hits = self.cache.hits
        self.stats.cache_misses = self.cache.misses
        self.stats.cache_inserts = self.cache.inserts
        self.stats.cache_evictions = self.cache.evictions
        self.stats.cache_pages = self.cache.pages

    def cache_probe(self, req) -> int:
        """Plan-time peek: the longest cached prefix (tokens) of the
        request's prompt, with no side effects."""
        if self.cache is None:
            return 0
        n, _ = self.cache.probe(np.asarray(req.tokens, np.int32))
        return n

    def cache_release(self, n_pages: int) -> int:
        """Evict at least ``n_pages`` from the cache and free them now (one
        burst of single frees); returns how many pages were freed."""
        blocks = self.cache.evict_pages(n_pages)
        if blocks:
            pkts = release_packet_array([], self.kvcfg.max_lanes)
            paged, stats = pkv.release_packets(
                self.kvcfg, self.state.paged,
                torch.as_tensor(pkts, device=self.device), self.tenants,
                extra_free=blocks)
            self.stats.hmq_release_bursts += 1
            self._note_burst(stats.per_tenant, stats.queue_live,
                             stats.queue_capacity)
            self.state = self.state._replace(paged=paged)
            self._sync_cache_stats()
        return len(blocks)

    def _demote_lanes(self, kv_tokens: dict) -> list[int]:
        """Demote completing lanes' full pages into the cache (before their
        release): kept pages are retagged to ``CACHE_OWNER`` so the lanes'
        FREE_ALLs leave them resident, duplicates stay lane-owned for that
        sweep, and the policy's victims are returned for the caller to
        ride as single frees."""
        ps = self.kvcfg.page_size
        tbl = self.state.paged.block_tables.cpu().numpy()
        retag: list[int] = []
        evicted: list[int] = []
        for lane, toks in kv_tokens.items():
            toks = np.asarray(toks, np.int32)
            n = len(toks) // ps
            if not n:
                continue
            blocks = tbl[lane, :n]
            if (blocks < 0).any():       # hole in the table: don't demote
                continue
            kept, _skipped, ev = self.cache.insert(toks[: n * ps], blocks)
            retag.extend(kept)
            evicted.extend(ev)
        if retag:
            alloc = self.service.retag_blocks(
                self.state.paged.alloc, self.tenants.kv,
                np.asarray(retag, np.int64), pkv.CACHE_OWNER)
            self.state = self.state._replace(
                paged=self.state.paged._replace(alloc=alloc))
        return evicted

    # ---------------- admission ----------------

    def admit_many(self, items: Sequence[AdmissionItem]) -> list[int]:
        """Prefill and install a batch of sequences with ONE support-core
        burst; lanes must be distinct.  Returns the lanes whose admission
        FAILED (already reclaimed).  ``self.admitted_tokens`` maps each
        admitted lane to its admission-seeded first generated token.

        An item with ``cached_len`` prefills only its uncached suffix, over
        the cached pages' K/V; copy mode writes the prefix K/V into the
        lane's own pages, alias mode splices the cached pages."""
        if not items:
            return []
        t_admit0 = time.perf_counter()
        items = [it if isinstance(it, AdmissionItem) else AdmissionItem(*it)
                 for it in items]
        W = self.sched_cfg.admit_width
        ps = self.kvcfg.page_size
        dev = self.device
        alias = self.alias_enabled
        # lane -> (cache block ids, full prompt) for alias-mode hits
        lane_prefix: dict[int, tuple[np.ndarray, np.ndarray]] = {}

        groups: dict[tuple[int, int], list[AdmissionItem]] = {}
        for it in items:
            bucket = pick_bucket(len(it.tokens) - it.cached_len,
                                 self.sched_cfg)
            groups.setdefault((bucket, it.cached_len), []).append(it)

        all_lanes: list[int] = []
        all_len: list[int] = []
        all_next: list[torch.Tensor] = []
        kv_chunks: list[tuple[torch.Tensor, torch.Tensor]] = []
        lane_cached: dict[int, int] = {}
        for (bucket, cached_len), group in sorted(groups.items()):
            k = len(group)
            width = max(W, k)
            toks = np.zeros((width, bucket), np.int32)
            lengths = np.ones((width,), np.int32)   # dummy rows: benign index
            for i, it in enumerate(group):
                suf = it.tokens[cached_len:]       # only the uncached suffix
                toks[i, : len(suf)] = suf
                lengths[i] = len(suf)
            batch = {"tokens": torch.as_tensor(toks, device=dev),
                     "lengths": torch.as_tensor(lengths, device=dev)}
            prefix_kv = None
            if cached_len:
                # re-probe at admit time (recency and hit counters); no
                # cache mutation happens between the plan and here
                src = np.zeros((width, cached_len // ps), np.int64)
                for i, it in enumerate(group):
                    cl, blks = self.cache.probe(it.tokens, touch=True)
                    assert cl == cached_len, \
                        f"cache changed between plan and admit: {cl} != " \
                        f"{cached_len}"
                    src[i] = blks
                    if alias:
                        lane_prefix[int(it.lane)] = (
                            src[i].astype(np.int32),
                            np.asarray(it.tokens, np.int32))
                idx = torch.as_tensor(src, device=dev)

                def flat(pool):
                    # [width, P, L, ps, kv, hd] -> [width, L, P * ps, kv, hd]
                    g = pool[idx].transpose(1, 2)
                    return g.reshape(g.shape[0], g.shape[1], cached_len,
                                     *g.shape[4:])
                prefix_kv = (flat(self.state.paged.k_pages),
                             flat(self.state.paged.v_pages))
                batch["prefix_k"], batch["prefix_v"] = prefix_kv
            elif self.cache is not None:
                for it in group:                   # record the miss
                    self.cache.probe(it.tokens, touch=True)
            res = self._prefill(self.params, batch)
            self.stats.prefill_passes += 1
            all_next.append(res.last_logits[:k].argmax(dim=-1).to(I32))
            all_lanes.extend(int(it.lane) for it in group)
            # alias mode installs the suffix alone; the cached prefix rides
            # as prefix_lens
            inst_cached = 0 if alias else cached_len
            all_len.extend(inst_cached + int(n) for n in lengths[:k])
            for it in group:
                lane_cached[int(it.lane)] = cached_len
            ks, vs = res.kv                      # [width, L, T, kv, hd]
            ks, vs = ks[:k], vs[:k]
            if prefix_kv is not None and not alias:
                # copy install: the lane gets its own pages for the whole
                # sequence, the cached prefix first
                pk, pv = prefix_kv
                ks = torch.cat([pk[:k].to(ks.dtype), ks], dim=2)
                vs = torch.cat([pv[:k].to(vs.dtype), vs], dim=2)
                self.stats.cache_hit_copy_bytes += (
                    2 * k * pk[0].numel() * ks.element_size())
            kv_chunks.append((ks, vs))

        order = np.argsort(np.asarray(all_lanes, np.int32), kind="stable")
        lanes_np = np.asarray(all_lanes, np.int32)[order]
        perm = torch.as_tensor(order, device=dev)
        lanes_arr = torch.as_tensor(lanes_np, device=dev)
        next_tokens = torch.cat(all_next)[perm]
        # pad every group's KV to the widest time extent, then ONE burst
        t_max = max(c[0].shape[2] for c in kv_chunks)

        def padded(i):
            return torch.cat([torch.nn.functional.pad(
                c[i], (0, 0, 0, 0, 0, t_max - c[i].shape[2]))
                for c in kv_chunks])

        kv_lens = torch.as_tensor(np.asarray(all_len, np.int32)[order],
                                  device=dev)
        pb = pl = None
        if lane_prefix:
            # burst-order [B, P] cached pages and [B] aliased token counts;
            # rows without a hit carry zeros (masked by their length 0)
            P = max(len(b) for b, _ in lane_prefix.values())
            pb_np = np.zeros((len(lanes_np), P), np.int32)
            pl_np = np.zeros((len(lanes_np),), np.int32)
            for r, lane in enumerate(lanes_np):
                rec = lane_prefix.get(int(lane))
                if rec is not None:
                    pb_np[r, : len(rec[0])] = rec[0]
                    pl_np[r] = len(rec[0]) * ps
            pb = torch.as_tensor(pb_np, device=dev)
            pl = torch.as_tensor(pl_np, device=dev)
        paged, stats = pkv.admit_prefill_many(
            self.kvcfg, self.state.paged, lanes_arr, padded(0)[perm],
            padded(1)[perm], kv_lens, self.tenants, prefix_blocks=pb,
            prefix_lens=pl)
        self.stats.hmq_admit_bursts += 1
        self.stats.alloc_failures += int(stats.failed)
        self._note_burst(stats.per_tenant, stats.queue_live,
                         stats.queue_capacity)
        self.state = self.state._replace(
            paged=paged,
            tokens=self.state.tokens.index_put((lanes_arr.long(),),
                                               next_tokens))
        lanes_host = lanes_np.tolist()
        ok = paged.active[lanes_arr.long()].cpu().tolist()
        failed = [lane for lane, o in zip(lanes_host, ok) if not o]
        for lane, o in zip(lanes_host, ok):
            # pin the spliced entries of every lane that admitted (the
            # refcount bump was gated on the same success)
            rec = lane_prefix.get(lane)
            if rec is None or not o:
                continue
            blks, toks = rec
            self.cache.alias(toks, len(blks))
            self._aliased[lane] = (toks[: len(blks) * ps], blks)
            self.stats.aliased_pages += len(blks)
        self.stats.admitted += len(items) - len(failed)
        self.stats.prefill_tokens_saved += sum(
            lane_cached.get(lane, 0) for lane, o in zip(lanes_host, ok) if o)
        self._sync_cache_stats()
        toks = next_tokens.cpu().tolist()
        self.admitted_tokens = {lane: t for lane, t, o
                                in zip(lanes_host, toks, ok) if o}
        if failed:
            # reclaim orphaned partial grants so failure never leaks the pool
            self.release(failed, completed=False)
        if any(it.cached_len for it in items):
            # the host copies above already waited for the device
            self.stats.cache_hit_admits += 1
            self.stats.cache_hit_admit_us += \
                (time.perf_counter() - t_admit0) * 1e6
        return failed

    def admit(self, lane: int, tokens: np.ndarray) -> bool:
        """Prefill one sequence into ``lane``; False when the allocator
        rejected it (the lane is left inactive and clean)."""
        return not self.admit_many([AdmissionItem(
            lane, np.asarray(tokens, np.int32))])

    # ---------------- decode ----------------

    def step(self) -> np.ndarray:
        """One decode step for all active lanes; returns next tokens.  With
        ``defer_refill`` the step's refills go to ``pending_ops`` for the
        multi-engine burst window."""
        if self.defer_refill:
            self.state, _logits, stats, pending = self._decode(
                self.params, self.state)
            self.pending_ops.append(pending)
        else:
            self.state, _logits, stats = self._decode(
                self.params, self.state)
        self.stats.decode_steps += 1
        scalars = torch.stack([stats.failed, stats.bursts, stats.stash_hits,
                               stats.stash_misses]).cpu().tolist()
        failed, bursts, hits, misses = scalars
        self.stats.alloc_failures += failed
        self.stats.decode_bursts += bursts
        self.stats.stash_hits += hits
        self.stats.stash_misses += misses
        self._note_burst(stats.tenant, stats.queue_live, stats.queue_capacity,
                         issued=bool(bursts))
        hist = stats.stash_depth_hist.cpu().tolist()
        if not self.stats.stash_depth_hist:
            self.stats.stash_depth_hist = [0] * len(hist)
        self.stats.stash_depth_hist = [
            a + b for a, b in zip(self.stats.stash_depth_hist, hist)]
        return self.state.tokens.cpu().numpy()

    # ---------------- completion ----------------

    def release(self, lanes: Sequence[int], completed: bool = True,
                kv_tokens: Optional[dict] = None) -> None:
        """Free everything the lanes own through FREE_ALL packets (one
        burst).  ``completed=False`` reclaims lanes without counting them
        as served.

        With the cache on, ``kv_tokens`` maps lanes to the tokens whose K/V
        they hold (``Scheduler.kv_token_prefix``): their full pages are
        demoted first, and the cache's victims ride this burst as single
        frees, as do aliased lanes' references to cached pages."""
        extra = None
        if completed and self.cache is not None and kv_tokens:
            # demote before unalias: the pins keep this insert's evictions
            # away from prefix pages other live lanes still read
            extra = self._demote_lanes(
                {lane: kv_tokens[lane] for lane in lanes if lane in kv_tokens})
        if self._aliased:
            shared = self._unalias_lanes(lanes)
            if shared:
                extra = (extra or []) + shared
        pkts = release_packet_array(list(lanes), self.kvcfg.max_lanes)
        paged, stats = pkv.release_packets(
            self.kvcfg, self.state.paged,
            torch.as_tensor(pkts, device=self.device), self.tenants,
            extra_free=extra)
        self.stats.hmq_release_bursts += 1
        self._note_burst(stats.per_tenant, stats.queue_live,
                         stats.queue_capacity)
        self.state = self.state._replace(paged=paged)
        self._sync_cache_stats()
        if completed:
            self.stats.completed += len(lanes)

    def preempt(self, lanes: Sequence[int]) -> None:
        """Evict running lanes (FREE_ALL everything they own); nothing is
        counted as completed."""
        self.release(lanes, completed=False)
        self.stats.preemptions += len(lanes)

    @property
    def live_pages(self) -> int:
        return int(pkv.live_pages(self.state.paged, self.tenants))

    @property
    def free_pages(self) -> int:
        """Allocatable KV pages right now (admission-policy input)."""
        return int(self.state.paged.alloc.free_top[self.tenants.kv.size_class])
