"""Serving engine: scheduler-driven continuous batching on the paged KV
(port of :mod:`repro.serve.engine`, every family the port serves).

Admission is batched: one prefill per (prompt bucket, cached prefix)
group, then ONE support-core burst (``paged_kv.admit_prefill_many``) for
the whole batch.  Each decode step ends in one gated burst, and completion
releases lanes through FREE_ALL packets -- admit, append and release all
speak the packet protocol.  On the card every one of those bursts is one
launch of the support-core CUDA kernel.

A split cache (``PagedKVConfig.split_window``, mellum2) admits, steps and
releases both of its KV tenants on the same bursts; it has no prefix
cache.

An engine can be one shard of a multi-engine deployment
(:mod:`repro_torch.serve.multi_engine`): it then runs on a namespaced
tenant set of a shared service (``tenants=``, ``alloc_state=``) and
with ``defer_refill`` hands its refills (and, under sliding-window
attention, the flushes of recycled pages: ``self.window``) to the burst
window (``pending_ops``).

The prefix cache (``prefix_cache=True``) keeps completed lanes' full
pages; an admission whose prompt opens with a cached prefix prefills only
the rest, over the cached K/V.  ``prefix_alias="copy"`` writes the cached
K/V into fresh lane pages, ``"alias"`` splices the cached page ids into
the lane's block table with a refcount bump (full attention only: a
windowed architecture falls back to copy, as in the JAX package).

``alloc_policy`` names the central allocator design (``freelist``,
``bitmap``, ``buddy`` or a registered one).  Admission asks for its KV
pages as runs (``malloc_run``), which the buddy policy places contiguously;
``EngineStats.mean_run_len`` reads how well it did, and :meth:`compact`
repacks sole-owner pages between burst windows so the free space
coalesces again.

The hybrid family (zamba2) adds a recurrent state per lane: admission
prefills exact-length prompts, installs each lane's per-layer states
(:meth:`_install_states`) and mallocs a ``state_slots`` slot in the same
burst.  As in the JAX package, its decode is seeded with the LAST PROMPT
token, which the prefill has already folded into the state: the first
decode step folds it a second time and writes its K/V at position
``len(prompt)``.  The port keeps this for parity (ROADMAP.md, Queue 3).
A recurrent family never rides the prefix cache (:meth:`cache_probe` is
0).

The ssm family (rwkv6) is recurrent in the same way and has no K/V at
all: its admission prefills and installs the lanes' states, sets their
``seq_lens`` and activates them, and issues no burst (its ``state_slots``
tenant is never granted, as in the JAX engine: ROADMAP.md, Queue 3); its
decode steps commit nothing; its release is the usual FREE_ALL burst.

The audio family (whisper) admits a request's frame embeddings (``frames
[F, d]``, the stub frontend's output): the prefill runs the encoder over
them once and the engine keeps the output in ``ServeState.enc_out`` at the
lane, which every decode step's cross-attention reads.  Such a request
never rides the prefix cache, and its lane is never demoted: its K/V from
the second layer on depends on the audio.

The vlm family (phi-3-vision) admits a request's patch embeddings ahead of
its prompt: they take positions ``[0, P)`` of the lane's K/V, so the lane
holds ``P + len(prompt)`` tokens after admission, its first decode token
sits at position ``P + len(prompt)``, and a preempted request prefills its
patches again with prompt + output.  Such a request never rides the
prefix cache.
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
from ..distributed.hints import ShardingHints
from ..distributed.sharding import (distribute_batch, distribute_state,
                                    local_tree)
from ..models.decode import RecurrentState, init_recurrent_state
from ..models.moe import dropless, spec_of
from ..tracing import span, timed
from .decode_graph import DecodeGraph, graph_engages
from .scheduler import (SchedulerConfig, make_scheduler_config, pick_bucket,
                        release_packet_array)
from .serve_step import (ServeState, init_enc_out, make_decode_step,
                         make_family_prefill, recycle_window)

I32 = torch.int32


@dataclasses.dataclass
class EngineStats:
    admitted: int = 0
    completed: int = 0
    decode_steps: int = 0
    preemptions: int = 0           # running lanes evicted by the scheduler
    alloc_failures: int = 0        # failed malloc packets
    hmq_admit_bursts: int = 0      # support-core steps issued for admission
    decode_commits: int = 0        # decode steps that committed a burst
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
    # --- contiguity telemetry, over just-admitted lanes' block-table rows:
    # an extent is a maximal run of consecutive page ids ---
    contiguous_extents: int = 0    # maximal consecutive-id runs admitted
    extent_pages: int = 0          # pages covered by those runs
    compactions: int = 0           # compaction passes run
    compaction_moves: int = 0      # pages moved by those passes
    # --- decode graph (the step captured once, replayed on the card) ---
    decode_graph_captures: int = 0  # decode steps captured as a graph
    decode_graph_replays: int = 0   # decode steps run as a graph replay
    decode_graph_copies: int = 0    # state leaves copied in before replays

    @property
    def mean_run_len(self) -> float:
        """Mean run length of admitted KV pages (pages per extent; 1.0 ==
        every page an island)."""
        if not self.contiguous_extents:
            return 0.0
        return self.extent_pages / self.contiguous_extents

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
        on the card; a decode step commits even when its gate skips, an
        attention-free one never).  A multi-engine shard's deferred traffic
        rides the window's merged commit, which the deployment counts."""
        return (self.hmq_admit_bursts + self.decode_commits
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
    frames: Optional[np.ndarray] = None   # [F, d] (audio)
    patches: Optional[np.ndarray] = None  # [P, d] (vlm)
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
    shared-state pull).  The pass is one ``window.admission`` span (attrs
    ``shard`` and the admitted requests' ``rids``)."""
    with span("window.admission", shard=eng.shard) as sp:
        return _run_admission(eng, sched, preemption, after_op, sp)


def _run_admission(eng: "ServingEngine", sched, preemption: bool, after_op,
                   sp) -> bool:
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
    items = [AdmissionItem(lane, r.tokens, r.frames, r.patches, r.cached_len)
             for b in plan.batches for lane, r in b.items]
    sp.note(rids=[r.rid for b in plan.batches for _, r in b.items])
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


def _clone_pending(p: pkv.PendingDecodeOps) -> pkv.PendingDecodeOps:
    """A copy of a replay's deferred ops (the next replay overwrites the
    graph's), a split cache's window tenant's included."""
    return pkv.PendingDecodeOps(
        p.below.clone(), p.flush_mask.clone(), p.flush_blocks.clone(),
        None if p.window is None else _clone_pending(p.window))


def _on_mesh(cfg: ArchConfig, mesh, decode, prefill):
    """The engine's decode and prefill on a one-rank mesh: the state and
    batch are placed on every call (no copy: each shard is whole) and the
    outputs come back as local tensors."""
    if mesh.size() != 1:
        raise NotImplementedError(
            f"a ServingEngine runs on a one-rank mesh (its admission and "
            f"release act on whole tensors); {mesh} has {mesh.size()}")

    def on_decode(params, state):
        return local_tree(decode(params, distribute_state(cfg, mesh, state)))

    def on_prefill(params, batch):
        return local_tree(prefill(params, distribute_batch(cfg, mesh, batch)))
    return on_decode, on_prefill


class ServingEngine:
    """Continuous-batching engine; lanes are slots in the running batch.

    ``device`` defaults to ``cuda`` (raising on a host without a card);
    ``params`` must live on the same device.  ``tenants`` installs a
    namespaced tenant set of a shared service and ``alloc_state`` that
    service's one allocator state (a multi-engine shard).
    ``eviction`` names the prefix cache's policy and ``prefix_alias`` its
    hit admission mode (the JAX package's defaults: ``lru``, ``copy``).
    ``alloc_policy`` names the allocator policy of the engine's own
    service; a shard installed with ``tenants`` runs its service's.

    ``shard`` is the engine's index in a multi-engine deployment, the
    ``shard`` attribute of its spans.

    ``hints`` (:class:`~repro_torch.distributed.hints.ShardingHints` over
    a mesh) runs the decode and prefill steps on that mesh: the caller
    places ``params`` with :func:`~repro_torch.distributed.sharding
    .distribute_params`, and each step places the engine's state and batch
    (:func:`~repro_torch.distributed.sharding.distribute_state`) and
    takes the local shards back.  The engine's own admission, release and
    checks act on whole tensors, so the mesh must have one rank.
    """

    def __init__(self, cfg: ArchConfig, kvcfg: PagedKVConfig,
                 params,
                 sched_cfg: Optional[SchedulerConfig] = None,
                 device: DeviceLike = None,
                 tenants: Optional[pkv.PagedTenants] = None,
                 alloc_state=None,
                 defer_refill: bool = False,
                 prefix_cache: bool = False,
                 eviction: str = "lru",
                 cache_pages: Optional[int] = None,
                 prefix_alias: str = "copy",
                 alloc_policy: str = "freelist",
                 hints: Optional[ShardingHints] = None,
                 shard: int = 0):
        self.device = resolve_device(device)
        self.shard = shard
        self.cfg = cfg
        self.kvcfg = kvcfg
        self.params = params
        self.sched_cfg = sched_cfg or make_scheduler_config(cfg, kvcfg)
        self.tenants = tenants if tenants is not None \
            else pkv.paged_tenants(kvcfg, self.device, policy=alloc_policy)
        self.service = self.tenants.service
        if self.service.device != self.device:
            raise ValueError(f"tenants live on {self.service.device}, the "
                             f"engine on {self.device}")
        if self.service.policy.name != alloc_policy:
            raise ValueError(
                f"the tenants' service runs policy "
                f"{self.service.policy.name!r}, not {alloc_policy!r}")
        self.alloc_policy = alloc_policy
        self.defer_refill = defer_refill
        self.pending_ops: list = []
        self.cache: Optional[pkv.PrefixCache] = None
        if prefix_cache and kvcfg.split_window:
            raise NotImplementedError(
                "a split cache (kvcfg.split_window) has no prefix cache: "
                "its windowed layers keep only the window's pages")
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
        # lanes whose K/V depends on more than their tokens (a vlm patch
        # prefix, whisper's audio): never demoted
        self._no_demote: set[int] = set()
        self.admitted_tokens: dict[int, int] = {}
        self.recurrent = cfg.family in ("ssm", "hybrid")
        self.state = ServeState(
            paged=pkv.init_paged_kv(kvcfg, self.tenants, alloc=alloc_state),
            tokens=torch.zeros((kvcfg.max_lanes,), dtype=I32,
                               device=self.device),
            rec=init_recurrent_state(cfg, kvcfg.max_lanes, params.embed.dtype,
                                     self.device),
            enc_out=init_enc_out(cfg, kvcfg.max_lanes, params.embed.dtype,
                                 self.device))
        self._decode = make_decode_step(cfg, kvcfg, self.tenants,
                                        defer_refill=defer_refill,
                                        hints=hints)
        self._prefill = make_family_prefill(cfg, hints=hints)
        self._mesh = hints.mesh if hints is not None else None
        if self._mesh is not None:
            self._decode, self._prefill = _on_mesh(
                cfg, self._mesh, self._decode, self._prefill)
        #: the decode step as a CUDA graph, captured at the first step
        #: that engages it (:meth:`_graph_engages`)
        self._graph: Optional[DecodeGraph] = None
        # the page-recycling window (swa), which the decode step's burst
        # and the multi-engine window's flushes follow
        self.window = recycle_window(cfg)
        # a prefill pass pads its group to the scheduler's admit_width
        # only where a capacity router couples its rows (a MoE that can
        # drop tokens): there the padding rows take their share of the
        # capacity, as in the JAX engine; elsewhere they are work that
        # changes no real row, and the pass holds its prompts alone
        self._pad_prefill = cfg.family == "moe" \
            and not dropless(spec_of(cfg))
        self.stats = EngineStats()
        #: the last decode step's ``decode.step`` span (its wall time)
        self.last_step = None

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

    def fragmentation_report(self) -> dict[str, dict]:
        """Per-tenant external-fragmentation snapshot of the live allocator
        state, for this engine's tenants only."""
        return self.service.fragmentation_report(
            self.state.paged.alloc, tenants=self.tenants.handles)

    def compact(self, max_moves: Optional[int] = None) -> int:
        """One KV compaction pass (:func:`~repro_torch.core.paged_kv
        .compact_kv`): sole-owner lane pages slide into lower (or higher)
        free holes so the free space coalesces; aliased prefix pages, cache
        residents and stash pages never move.  Call it between burst
        windows.  Returns the pages moved."""
        paged, moved = pkv.compact_kv(self.kvcfg, self.state.paged,
                                      self.tenants, max_moves=max_moves)
        if moved:
            self.state = self.state._replace(paged=paged)
        self.stats.compactions += 1
        self.stats.compaction_moves += moved
        return moved

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
        request's prompt, with no side effects; 0 for a recurrent family,
        whose state a cached prefix cannot restore, for a request with
        patches, whose K/V opens with the patch rows, and for one with
        frames, whose K/V depends on them."""
        if self.cache is None or self.recurrent or req.patches is not None \
                or req.frames is not None:
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
        ride as single frees.  A lane admitted behind patches or with
        frames is not demoted: its pages hold patch rows, or K/V that
        depends on the audio, not the K/V of the tokens alone that the
        cache would key them by.  (The JAX engine demotes both; a text-only
        request opening with the same tokens could then read them.)"""
        ps = self.kvcfg.page_size
        tbl = self.state.paged.block_tables.cpu().numpy()
        retag: list[int] = []
        evicted: list[int] = []
        for lane, toks in kv_tokens.items():
            if lane in self._no_demote:
                continue
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
        admitted lane to its admission-seeded first generated token; a
        recurrent family seeds with the last prompt token, which is no
        output, and publishes an empty mapping.

        Each (bucket, patch rows, cached length) group is one prefill pass
        over its prompts, padded to ``admit_width`` rows only where a
        capacity router couples the rows (``self._pad_prefill``).

        An item with ``cached_len`` prefills only its uncached suffix, over
        the cached pages' K/V; copy mode writes the prefix K/V into the
        lane's own pages, alias mode splices the cached pages.  An item
        with ``patches [P, d]`` (vlm) prefills them ahead of its tokens:
        items group by ``(bucket, P, cached_len)`` and the lane's K/V
        holds ``P + len(tokens)`` rows.  An item with ``frames [F, d]``
        (audio) prefills over them; the encoder's output lands in
        ``ServeState.enc_out`` at its lane.  A family without K/V (rwkv6)
        issues no burst: its lanes are activated directly."""
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

        groups: dict[tuple[int, int, int], list[AdmissionItem]] = {}
        for it in items:
            bucket = pick_bucket(len(it.tokens) - it.cached_len,
                                 self.sched_cfg)
            n_prefix = 0 if it.patches is None else it.patches.shape[0]
            groups.setdefault((bucket, n_prefix, it.cached_len), []
                              ).append(it)

        all_lanes: list[int] = []
        all_len: list[int] = []
        all_next: list[torch.Tensor] = []
        kv_chunks: list[tuple[torch.Tensor, torch.Tensor]] = []
        lane_cached: dict[int, int] = {}
        for (bucket, n_prefix, cached_len), group in sorted(groups.items()):
            k = len(group)
            width = max(W, k) if self._pad_prefill else k
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
            elif self.cache is not None and not self.recurrent \
                    and not n_prefix and self.cfg.family != "audio":
                for it in group:                   # record the miss
                    self.cache.probe(it.tokens, touch=True)
            if self.cfg.family == "audio":
                fr = np.zeros((width, self.cfg.encoder_seq_len,
                               self.cfg.d_model), np.float32)
                for i, it in enumerate(group):
                    fr[i] = it.frames
                batch["frames"] = torch.as_tensor(
                    fr, dtype=self.params.embed.dtype, device=dev)
            if n_prefix:
                pe = np.zeros((width, n_prefix, self.cfg.d_model), np.float32)
                for i, it in enumerate(group):
                    pe[i] = it.patches
                batch["patches"] = torch.as_tensor(
                    pe, dtype=self.params.embed.dtype, device=dev)
            with span("admit.prefill"):
                res = self._prefill(self.params, batch)
            self.stats.prefill_passes += 1
            if self.recurrent:
                # seeded with the last prompt token (folded twice)
                all_next.append(torch.as_tensor(
                    [int(it.tokens[-1]) for it in group], dtype=I32,
                    device=dev))
                self._install_states(res.states, k,
                                     [int(it.lane) for it in group])
            else:
                all_next.append(res.last_logits[:k].argmax(dim=-1).to(I32))
            if res.enc_out is not None:
                self.state.enc_out[torch.as_tensor(
                    [int(it.lane) for it in group], device=dev)] = \
                    res.enc_out[:k].to(self.state.enc_out.dtype)
            all_lanes.extend(int(it.lane) for it in group)
            # alias mode installs the suffix alone; the cached prefix rides
            # as prefix_lens
            inst_cached = 0 if alias else cached_len
            all_len.extend(inst_cached + n_prefix + int(n)
                           for n in lengths[:k])
            for it in group:
                lane_cached[int(it.lane)] = cached_len
                if n_prefix or it.frames is not None:
                    self._no_demote.add(int(it.lane))
            if res.kv is None:                   # rwkv6: no K/V
                continue
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
        kv_lens = torch.as_tensor(np.asarray(all_len, np.int32)[order],
                                  device=dev)
        if kv_chunks:
            paged = self._admission_burst(kv_chunks, perm, lanes_arr, lanes_np,
                                          kv_lens, lane_prefix)
        else:
            # attention-free (rwkv6): no pages to allocate; activate lanes
            paged = self.state.paged
            idx = lanes_arr.long()
            seq_lens, active = paged.seq_lens.clone(), paged.active.clone()
            seq_lens[idx] = kv_lens
            active[idx] = True
            paged = paged._replace(seq_lens=seq_lens, active=active)
        self.state = self.state._replace(
            paged=paged,
            tokens=self.state.tokens.index_put((lanes_arr.long(),),
                                               next_tokens))
        lanes_host = lanes_np.tolist()
        with span("admit.readback"):
            ok = paged.active[lanes_arr.long()].cpu().tolist()
            ok_lanes = [lane for lane, o in zip(lanes_host, ok) if o]
            if ok_lanes and kv_chunks:
                # how well the policy served admission's run grants
                ext, pgs = pkv.extent_stats(paged.block_tables, ok_lanes)
                self.stats.contiguous_extents += ext
                self.stats.extent_pages += pgs
            firsts = [] if self.recurrent else next_tokens.cpu().tolist()
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
        if self.recurrent:
            self.admitted_tokens = {}          # the seed is no output
        else:
            self.admitted_tokens = {lane: t for lane, t, o
                                    in zip(lanes_host, firsts, ok) if o}
        if failed:
            # reclaim orphaned partial grants (KV pages granted while the
            # lane's state-slot or scratch packet failed) so failure never
            # leaks the pool
            self.release(failed, completed=False)
        if any(it.cached_len for it in items):
            # the host copies above already waited for the device
            self.stats.cache_hit_admits += 1
            self.stats.cache_hit_admit_us += \
                (time.perf_counter() - t_admit0) * 1e6
        return failed

    def _admission_burst(self, kv_chunks, perm, lanes_arr, lanes_np,
                         kv_lens, lane_prefix) -> pkv.PagedKVState:
        """Every group's K/V padded to the widest time extent, then ONE
        admission burst for the batch (burst order: ``perm``)."""
        ps = self.kvcfg.page_size
        dev = self.device
        t_max = max(c[0].shape[2] for c in kv_chunks)

        def padded(i):
            return torch.cat([torch.nn.functional.pad(
                c[i], (0, 0, 0, 0, 0, t_max - c[i].shape[2]))
                for c in kv_chunks])

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
        with span("admit.readback"):
            self.stats.alloc_failures += int(stats.failed)
            self._note_burst(stats.per_tenant, stats.queue_live,
                             stats.queue_capacity)
        return paged

    def _install_states(self, states: RecurrentState, k: int,
                        lanes: list[int]) -> None:
        """Scatter the first ``k`` prefill rows' per-layer recurrent states
        into the lanes' slots (every part but the f32 ``ssm`` cast to the
        state's dtype)."""
        idx = torch.as_tensor(lanes, device=self.device)
        parts = {}
        for name, have in self.state.rec._asdict().items():
            if have is None:
                continue
            have = have.clone()
            have[:, idx] = getattr(states, name)[:, :k].to(have.dtype)
            parts[name] = have
        self.state = self.state._replace(rec=RecurrentState(**parts))

    def admit(self, lane: int, tokens: np.ndarray,
              frames: Optional[np.ndarray] = None,
              patches: Optional[np.ndarray] = None) -> bool:
        """Prefill one sequence (over its ``frames``, audio; behind its
        ``patches``, vlm) into ``lane``; False when the allocator rejected
        it (the lane is left inactive and clean)."""
        return not self.admit_many([AdmissionItem(
            lane, np.asarray(tokens, np.int32), frames, patches)])

    # ---------------- decode ----------------

    def step(self) -> np.ndarray:
        """One decode step for all active lanes; returns next tokens.  With
        ``defer_refill`` the step's refills go to ``pending_ops`` for the
        multi-engine burst window.  The step is one ``decode.step`` span
        (``self.last_step``), which holds the decode step's
        ``decode.forward`` and ``decode.alloc`` and the ``decode.readback``
        of its host copies.

        On the card the step is captured as a CUDA graph at the first
        step and replayed by every later one (:mod:`.decode_graph`; a
        ``decode.replay`` span, in place of ``decode.forward`` and
        ``decode.alloc``), unless :meth:`_graph_engages` says no."""
        with timed("decode.step", shard=self.shard) as self.last_step:
            if self._graph_engages():
                out = self._replay()
            else:
                out = self._decode(self.params, self.state)
            if self.defer_refill:
                self.state, _logits, stats, pending = out
                self.pending_ops.append(pending)
            else:
                self.state, _logits, stats = out
            self.stats.decode_steps += 1
            self.stats.decode_commits += self.cfg.family != "ssm"
            with span("decode.readback"):
                return self._read_step(stats)

    def _graph_engages(self) -> bool:
        return graph_engages(self.device, self._mesh, self.service.recorder)

    def _replay(self) -> tuple:
        """The decode step as a graph replay, captured first if it is not
        yet: whatever ``self._decode`` is at that moment.  The deferred
        refills are cloned, since the next replay overwrites them."""
        if self._graph is None:
            self._graph = DecodeGraph(self._decode, self.params, self.state)
            self.stats.decode_graph_captures += 1
        with span("decode.replay"):
            out, copied = self._graph(self.state)
        self.stats.decode_graph_replays += 1
        self.stats.decode_graph_copies += copied
        if self.defer_refill:
            out = (*out[:-1], _clone_pending(out[-1]))
        return out

    def _read_step(self, stats) -> np.ndarray:
        """The decode step's device-to-host copies: its stats, its burst's
        tenant breakdown, the stash histogram and the next tokens."""
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
        self._no_demote.difference_update(int(lane) for lane in lanes)
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
