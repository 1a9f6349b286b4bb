"""Multi-engine sharded serving on ONE shared AllocService (port of
:mod:`repro.serve.multi_engine`, DESIGN.md §10).

The paper's central claim at the serving layer: one support core serves
many client engines with no cross-engine metadata synchronisation.

* **N engine shards, one service.**  Each
  :class:`~repro_torch.serve.engine.ServingEngine` registers its tenant set
  (``kv_pages`` [+ ``kv_window_pages``] [+ ``state_slots``] [+
  ``scratch``]) under its own
  namespace (``"e0/kv_pages"`` ...) on one
  :class:`~repro_torch.alloc.AllocService`, whose single
  :class:`~repro_torch.core.freelist.FreeListState` carries every shard's
  classes.  Quota isolation between shards is the per-class isolation
  tenants already have; no shard sees another's metadata.
* **Burst windows.**  Within a quantum of decode steps each shard's
  refills (and, under sliding-window attention, its flushes of recycled
  pages) accumulate as :class:`~repro_torch.core.paged_kv.PendingDecodeOps`
  instead of committing per step; the window then drains them, every
  completed lane's FREE_ALLs and the prefix caches' eviction frees in ONE
  merged commit.  Only a lane whose stash missed at a page boundary
  mallocs inside its step (a gated burst of response width 1).
* **Preemption.**  When a shard's pool runs dry and a higher-priority
  request waits, the scheduler evicts the lowest-priority running lane;
  the request re-queues with its generated prefix and resumes exactly.
* **Per-shard prefix caches.**  Each shard demotes into and probes only
  its own namespaced KV class, so the caches need no coordination.

The one authoritative allocator state threads through the shards:
:meth:`MultiEngine._sync` installs it into a shard before the shard's op
and :meth:`MultiEngine._pull` adopts the shard's result after it; a shard
that committed against a stale state would silently drop another shard's
grants.  On the card each commit (a shard's admission, decode step,
release or cache eviction, and each window's merged commit) is one launch
of the support-core kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..alloc.service import AllocService
from ..configs.base import ArchConfig
from ..core import paged_kv as pkv
from ..core.lane_stash import stash_push_batch
from ..core.paged_kv import PagedKVConfig
from ..device import DeviceLike, resolve_device
from ..tracing import span
from .engine import ServingEngine, run_admission
from .router import Router, shard_load
from .scheduler import (Request, Scheduler, SchedulerConfig,
                        make_scheduler_config)

I32 = torch.int32


@dataclasses.dataclass
class MultiEngineStats:
    """Cross-shard telemetry of the serving loop."""

    windows: int = 0               # burst windows driven
    window_bursts: int = 0         # merged commits made (one launch each)
    window_commits: int = 0        # ... of which carried a live packet
    window_slots_live: int = 0     # non-NOP slots across live merged commits
    window_slots_capacity: int = 0  # total slots across live merged commits
    preemptions: int = 0           # lanes evicted across all shards
    decode_steps: int = 0          # engine-steps summed over shards

    @property
    def cross_engine_burst_occupancy(self) -> float:
        """Mean fraction of the live merged commits' slots that carry a
        packet: how well N shards' deferred traffic packs one burst."""
        if not self.window_slots_capacity:
            return 0.0
        return self.window_slots_live / self.window_slots_capacity


class MultiEngine:
    """N continuous-batching engine shards multiplexed onto one support core.

    ``quantum`` is the burst-window length in decode steps; ``quantum=1``
    gives the per-step commit cadence.  All shards share ``params`` (one
    model on the device); each builds its own decode step.  ``eviction``
    and ``prefix_alias`` default to the JAX package's ``lru`` and
    ``copy``; ``alloc_policy`` names the shared service's policy.
    """

    def __init__(self, cfg: ArchConfig, kvcfg: PagedKVConfig,
                 params, n_engines: int = 2,
                 sched_cfg: Optional[SchedulerConfig] = None,
                 quantum: int = 4, preemption: bool = True,
                 router: str = "round_robin",
                 prefix_cache: bool = False,
                 eviction: str = "lru",
                 cache_pages: Optional[int] = None,
                 prefix_alias: str = "copy",
                 device: DeviceLike = None,
                 alloc_policy: str = "freelist"):
        if n_engines < 1:
            raise ValueError("n_engines must be >= 1")
        if quantum < 1:
            raise ValueError("quantum must be >= 1")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.kvcfg = kvcfg
        self.n_engines = n_engines
        self.quantum = quantum
        self.preemption = preemption

        # one service, N namespaced tenant sets (all registered before the
        # state exists), one allocator state covering every shard's classes
        self.alloc_policy = alloc_policy
        self.service = AllocService(policy=alloc_policy, device=self.device)
        tenant_sets = [pkv.register_paged_tenants(self.service, kvcfg,
                                                  namespace=f"e{i}")
                       for i in range(n_engines)]
        self.alloc = self.service.init_state()
        scfg = sched_cfg or make_scheduler_config(cfg, kvcfg)
        self.engines = [
            ServingEngine(cfg, kvcfg, params, sched_cfg=scfg,
                          device=self.device, tenants=ts,
                          alloc_state=self.alloc, defer_refill=True,
                          prefix_cache=prefix_cache, eviction=eviction,
                          cache_pages=cache_pages,
                          prefix_alias=prefix_alias,
                          alloc_policy=alloc_policy, shard=i)
            for i, ts in enumerate(tenant_sets)]
        self.scheds = [Scheduler(scfg) for _ in range(n_engines)]
        self.router = Router(router)
        self.stats = MultiEngineStats()

    # ---------------- shared-allocator threading ----------------

    def _sync(self, i: int) -> ServingEngine:
        """Install the authoritative allocator state into shard i."""
        eng = self.engines[i]
        if eng.state.paged.alloc is not self.alloc:
            eng.state = eng.state._replace(
                paged=eng.state.paged._replace(alloc=self.alloc))
        return eng

    def _pull(self, i: int) -> None:
        """Adopt shard i's post-op allocator state as the authoritative
        one."""
        self.alloc = self.engines[i].state.paged.alloc

    # ---------------- intake ----------------

    def submit(self, requests: Sequence[Request],
               max_new_tokens: Optional[int] = None) -> list[int]:
        """Route requests onto shards; returns the shard of each."""
        shards = []
        for req in requests:
            if max_new_tokens is not None:
                req.max_new_tokens = max_new_tokens
            shard = self.router.route([shard_load(s) for s in self.scheds])
            self.scheds[shard].submit(req)
            shards.append(shard)
        return shards

    @property
    def has_work(self) -> bool:
        return any(s.has_work for s in self.scheds)

    # ---------------- the serving loop ----------------

    def serve(self, requests: Sequence[Request], max_new_tokens: int = 16,
              validate: bool = False, verbose: bool = False,
              step_times_us: Optional[list] = None) -> int:
        """Drive every request to completion; returns the burst windows.
        ``validate`` checks I1–I6 over the shared state after every
        window."""
        self.submit(requests, max_new_tokens=max_new_tokens)
        windows = 0
        while self.has_work:
            progressed = self.step_window(validate=validate,
                                          step_times_us=step_times_us)
            windows += 1
            if verbose:
                done = sum(len(s.finished) for s in self.scheds)
                print(f"window {windows}: done={done}/{len(requests)} "
                      f"commits={self.stats.window_commits} "
                      f"preemptions={self.stats.preemptions}")
            if not progressed:
                stranded = sum(len(s.waiting) for s in self.scheds)
                print(f"WARNING: multi-engine admission starved — "
                      f"{stranded} request(s) not served")
                break
        return windows

    def step_window(self, validate: bool = False,
                    step_times_us: Optional[list] = None) -> bool:
        """One burst window: admission (with preemption), a quantum of
        round-robin decode steps on every shard, then ONE merged commit.
        Returns whether any shard admitted or decoded.  ``step_times_us``
        collects each decode step's wall time, read from its
        ``decode.step`` span."""
        with span("window"):
            return self._step_window(validate, step_times_us)

    def _step_window(self, validate: bool,
                     step_times_us: Optional[list]) -> bool:
        progressed = False
        for i, sched in enumerate(self.scheds):
            eng = self._sync(i)
            if not sched.waiting:
                continue
            if run_admission(eng, sched, preemption=self.preemption,
                             after_op=lambda i=i: self._pull(i)):
                progressed = True
        self.stats.preemptions = sum(e.stats.preemptions
                                     for e in self.engines)

        # decode quantum: refills pile up in each shard's pending_ops,
        # completions in `released`, cache victims in `evicted`, all freed
        # by the window's commit
        released: list[list[int]] = [[] for _ in self.engines]
        evicted: list[list[int]] = [[] for _ in self.engines]
        for _ in range(self.quantum):
            for i, sched in enumerate(self.scheds):
                if not sched.running:
                    continue
                eng = self._sync(i)
                tokens = eng.step()
                if step_times_us is not None:
                    step_times_us.append(eng.last_step.duration_us)
                self._pull(i)
                self.stats.decode_steps += 1
                progressed = True
                finished = sched.note_decode_step(tokens)
                if not finished:
                    continue
                if eng.cache is not None:
                    # demote before the table rows clear and before the
                    # window's FREE_ALLs: kept pages retag on the shared
                    # state (pull it), victims ride the window commit
                    evicted[i].extend(eng._demote_lanes(
                        {lane: sched.kv_token_prefix(lane)
                         for lane in finished}))
                    self._pull(i)
                    # alias mode: drop the lanes' pins after the demotion
                    # (the pins shield its evictions); their references
                    # ride the window commit as single frees
                    evicted[i].extend(eng._unalias_lanes(finished))
                    eng._sync_cache_stats()
                eng._no_demote.difference_update(finished)
                mask = np.zeros((self.kvcfg.max_lanes,), bool)
                mask[finished] = True
                eng.state = eng.state._replace(
                    paged=pkv.clear_released_lanes(
                        eng.state.paged,
                        torch.as_tensor(mask, device=self.device)))
                eng.stats.completed += len(finished)
                released[i].extend(finished)
                sched.complete(finished)

        with span("window.commit"):
            self._flush_window(released, evicted)
        if self.service.recorder is not None:
            # window boundary in the allocator-op trace
            self.service.recorder.mark_window()
        self.stats.windows += 1
        if validate:
            self.validate()
        return progressed

    def _flush_window(self, released: list[list[int]],
                      evicted: list[list[int]]) -> None:
        """ONE merged gated commit of every shard's window traffic: stash
        refills (the OR of the steps' ``below`` masks, masked by ``active``
        and by room for the whole refill), the flushes of recycled pages
        (single frees, staged only for a windowed shard, so that a
        windowless one adds no NOP slots to the burst), completed lanes'
        FREE_ALLs, and cache victims and alias references as single frees
        (the FREE_ALLs skip ``CACHE_OWNER`` pages); then the refill grants
        go into each shard's stash.  A split cache's window tenant adds its
        own refills and flushes after the KV tenant's.  A flushed page of
        a lane released in
        the same window is named by its free and its lane's FREE_ALL: the
        burst returns it once."""
        L = self.kvcfg.max_lanes
        S = self.kvcfg.stash_size
        R = self.kvcfg.stash_refill
        lane_ids = torch.arange(L, dtype=I32, device=self.device)
        burst = self.service.new_burst()
        installs = []              # (shard, ticket, below mask, window?)
        for i, eng in enumerate(self.engines):
            pend, eng.pending_ops = eng.pending_ops, []
            paged = eng.state.paged
            # (tenant, its stash, its steps' ops, whether it recycles)
            tenants = [(eng.tenants.kv, paged.stash, pend,
                        eng.window is not None)]
            if paged.win is not None:
                tenants.append((eng.tenants.window, paged.win.stash,
                                [p.window for p in pend], True))
            for handle, stash, ops, recycles in tenants:
                if ops and S:
                    below = ops[0].below
                    for p in ops[1:]:
                        below = below | p.below
                    # released lanes get no pages pushed into their cleared
                    # rows; a stash that refilled from its own pops since
                    # it dipped must still have room for the whole batch
                    below = below & paged.active & (stash.depth <= S - R)
                    installs.append((i, burst.refill(handle, lane_ids, R,
                                                     where=below), below,
                                     handle is eng.tenants.window))
                if recycles:
                    for p in ops:            # NO_BLOCK entries become NOPs
                        burst.free(handle, lane_ids, p.flush_blocks,
                                   where=p.flush_mask)
            if released[i]:
                valid = np.zeros((L,), bool)
                valid[released[i]] = True
                pkv.stage_release_ops(
                    eng.tenants, burst, lane_ids,
                    torch.as_tensor(valid, device=self.device))
            if evicted[i]:
                pkv.stage_single_frees(eng.tenants, burst, evicted[i])
        if not burst.size:
            return
        self.alloc, res = self.service.commit(
            self.alloc, burst, max_blocks_per_req=max(1, R if S else 1),
            gated=True, kind="window")
        self.stats.window_bursts += 1
        for i, t, below, window in installs:
            eng = self._sync(i)
            got = res.ok_for(t) & below
            paged = eng.state.paged
            if window:
                stash = stash_push_batch(paged.win.stash,
                                         res.blocks_for(t)[:, :R], R, got)
                paged = paged._replace(win=paged.win._replace(stash=stash))
            else:
                stash = stash_push_batch(paged.stash,
                                         res.blocks_for(t)[:, :R], R, got)
                paged = paged._replace(stash=stash)
            eng.state = eng.state._replace(paged=paged)
        live, queue_live, queue_cap = torch.stack(
            [res.live, res.stats.queue_live,
             res.stats.queue_capacity]).cpu().tolist()
        self.stats.window_commits += live
        if live:
            self.stats.window_slots_live += queue_live
            self.stats.window_slots_capacity += queue_cap
        for eng in self.engines:
            eng._note_burst(res.stats.per_tenant, issued=False)

    def compact(self, max_moves: Optional[int] = None) -> list[int]:
        """One KV compaction pass on every shard against the shared
        allocator state (:meth:`ServingEngine.compact`); call it between
        windows.  Returns each shard's pages moved."""
        moved = []
        for i, eng in enumerate(self.engines):
            self._sync(i)
            moved.append(eng.compact(max_moves=max_moves))
            self._pull(i)
        return moved

    # ---------------- reporting / validation ----------------

    def validate(self) -> None:
        """I1–I4 over every shard's classes of the shared state, and each
        shard's I5 partition and I6 refcounts against its own KV class and
        cache (raises ``FreelistInvariantError``)."""
        for i, eng in enumerate(self.engines):
            self._sync(i)
            pkv.validate_paged_kv(self.kvcfg, eng.state.paged, eng.tenants,
                                  cache=eng.cache)

    @property
    def finished(self) -> list[Request]:
        return [r for s in self.scheds for r in s.finished]

    @property
    def failed(self) -> list[Request]:
        return [r for s in self.scheds for r in s.failed]

    def tenant_rollup(self) -> dict[str, dict]:
        """Cross-engine per-tenant rollup of the shared allocator state."""
        return self.service.rollup_report(self.alloc)
