"""Serving engine: scheduler-driven continuous batching on the paged KV
(port of :mod:`repro.serve.engine`, single engine, dense family).

Admission is batched: one prefill per prompt bucket, then ONE support-core
burst (``paged_kv.admit_prefill_many``) for the whole batch.  Each decode
step ends in one gated burst, and completion releases lanes through
FREE_ALL packets -- admit, append and release all speak the packet
protocol.  On the card every one of those bursts is one launch of the
support-core CUDA kernel.

Left for later slices (ROADMAP.md, Queue 1): the prefix cache and its
aliasing, compaction, deferred refills and the multi-engine window.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ArchConfig
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

    @property
    def commits(self) -> int:
        """Support-core commits this engine made (each one kernel launch
        on the card; a decode step commits even when its gate skips)."""
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


def run_admission(eng: "ServingEngine", sched, preemption: bool = False
                  ) -> bool:
    """One admission pass: plan under the page budget (optionally evicting
    a lower-priority running lane when stuck), admit the batch, record the
    admission-seeded first tokens, and retire requests the seed finished.
    Returns whether anything was admitted."""
    plan = sched.plan_admission(eng.free_pages)
    if not plan.size and preemption:
        lane = sched.preempt_victim(free_pages=eng.free_pages)
        if lane is not None:
            eng.preempt([lane])
            sched.preempt(lane)
            plan = sched.plan_admission(eng.free_pages)
    if not plan.size:
        return False
    items = [AdmissionItem(lane, r.tokens)
             for b in plan.batches for lane, r in b.items]
    failed = eng.admit_many(items)
    sched.commit_admission(plan)
    if failed:
        sched.fail_admission(failed)
        print(f"WARNING: allocator rejected admission of "
              f"{len(failed)} request(s) (pool exhausted)")
    done0 = sched.note_admission(eng.admitted_tokens)
    if done0:
        eng.release(done0)
        sched.complete(done0)
    return True


class ServingEngine:
    """Continuous-batching engine; lanes are slots in the running batch.

    ``device`` defaults to ``cuda`` (raising on a host without a card);
    ``params`` must live on the same device.
    """

    def __init__(self, cfg: ArchConfig, kvcfg: PagedKVConfig,
                 params: DenseLM,
                 sched_cfg: Optional[SchedulerConfig] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.kvcfg = kvcfg
        self.params = params
        self.sched_cfg = sched_cfg or make_scheduler_config(cfg, kvcfg)
        self.tenants = pkv.paged_tenants(kvcfg, self.device)
        self.service = self.tenants.service
        self.admitted_tokens: dict[int, int] = {}
        self.state = ServeState(
            paged=pkv.init_paged_kv(kvcfg, self.tenants),
            tokens=torch.zeros((kvcfg.max_lanes,), dtype=I32,
                               device=self.device))
        self._decode = make_decode_step(cfg, kvcfg, self.tenants)
        self._prefill = make_family_prefill(cfg)
        self.stats = EngineStats()

    # ---------------- multi-tenant telemetry ----------------

    def _note_burst(self, per_tenant, queue_live, queue_capacity,
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
        if issued:
            self.stats.burst_slots_live += int(queue_live)
            self.stats.burst_slots_capacity += int(queue_capacity)

    def tenant_report(self) -> dict[str, dict]:
        """Per-tenant occupancy/quota/counters of the live allocator state."""
        return self.service.tenant_report(self.state.paged.alloc,
                                          tenants=self.tenants.handles)

    # ---------------- admission ----------------

    def admit_many(self, items: Sequence[AdmissionItem]) -> list[int]:
        """Prefill and install a batch of sequences with ONE support-core
        burst; lanes must be distinct.  Returns the lanes whose admission
        FAILED (already reclaimed).  ``self.admitted_tokens`` maps each
        admitted lane to its admission-seeded first generated token."""
        if not items:
            return []
        items = [it if isinstance(it, AdmissionItem) else AdmissionItem(*it)
                 for it in items]
        W = self.sched_cfg.admit_width
        dev = self.device

        groups: dict[int, list[AdmissionItem]] = {}
        for it in items:
            groups.setdefault(pick_bucket(len(it.tokens), self.sched_cfg),
                              []).append(it)

        all_lanes: list[int] = []
        all_len: list[int] = []
        all_next: list[torch.Tensor] = []
        kv_chunks: list[tuple[torch.Tensor, torch.Tensor]] = []
        for bucket, group in sorted(groups.items()):
            k = len(group)
            width = max(W, k)
            toks = np.zeros((width, bucket), np.int32)
            lengths = np.ones((width,), np.int32)   # dummy rows: benign index
            for i, it in enumerate(group):
                toks[i, : len(it.tokens)] = it.tokens
                lengths[i] = len(it.tokens)
            res = self._prefill(self.params, {
                "tokens": torch.as_tensor(toks, device=dev),
                "lengths": torch.as_tensor(lengths, device=dev)})
            self.stats.prefill_passes += 1
            all_next.append(res.last_logits[:k].argmax(dim=-1).to(I32))
            all_lanes.extend(int(it.lane) for it in group)
            all_len.extend(int(n) for n in lengths[:k])
            ks, vs = res.kv                      # [width, L, T, kv, hd]
            kv_chunks.append((ks[:k], vs[:k]))

        order = np.argsort(np.asarray(all_lanes, np.int32), kind="stable")
        perm = torch.as_tensor(order, device=dev)
        lanes_arr = torch.as_tensor(np.asarray(all_lanes, np.int32)[order],
                                    device=dev)
        next_tokens = torch.cat(all_next)[perm]
        # pad every bucket's KV to the widest time extent, then ONE burst
        t_max = max(c[0].shape[2] for c in kv_chunks)

        def padded(i):
            return torch.cat([torch.nn.functional.pad(
                c[i], (0, 0, 0, 0, 0, t_max - c[i].shape[2]))
                for c in kv_chunks])

        kv_lens = torch.as_tensor(np.asarray(all_len, np.int32)[order],
                                  device=dev)
        paged, stats = pkv.admit_prefill_many(
            self.kvcfg, self.state.paged, lanes_arr, padded(0)[perm],
            padded(1)[perm], kv_lens, self.tenants)
        self.stats.hmq_admit_bursts += 1
        self.stats.alloc_failures += int(stats.failed)
        self._note_burst(stats.per_tenant, stats.queue_live,
                         stats.queue_capacity)
        self.state = self.state._replace(
            paged=paged,
            tokens=self.state.tokens.index_put((lanes_arr.long(),),
                                               next_tokens))
        lanes_host = lanes_arr.cpu().tolist()
        ok = paged.active[lanes_arr.long()].cpu().tolist()
        failed = [lane for lane, o in zip(lanes_host, ok) if not o]
        self.stats.admitted += len(items) - len(failed)
        toks = next_tokens.cpu().tolist()
        self.admitted_tokens = {lane: t for lane, t, o
                                in zip(lanes_host, toks, ok) if o}
        if failed:
            # reclaim orphaned partial grants so failure never leaks the pool
            self.release(failed, completed=False)
        return failed

    def admit(self, lane: int, tokens: np.ndarray) -> bool:
        """Prefill one sequence into ``lane``; False when the allocator
        rejected it (the lane is left inactive and clean)."""
        return not self.admit_many([AdmissionItem(
            lane, np.asarray(tokens, np.int32))])

    # ---------------- decode ----------------

    def step(self) -> np.ndarray:
        """One decode step for all active lanes; returns next tokens."""
        self.state, _logits, stats = self._decode(self.params, self.state)
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

    def release(self, lanes: Sequence[int], completed: bool = True) -> None:
        """Free everything the lanes own through FREE_ALL packets (one
        burst).  ``completed=False`` reclaims lanes without counting them
        as served."""
        pkts = release_packet_array(list(lanes), self.kvcfg.max_lanes)
        paged, stats = pkv.release_packets(
            self.kvcfg, self.state.paged,
            torch.as_tensor(pkts, device=self.device), self.tenants)
        self.stats.hmq_release_bursts += 1
        self._note_burst(stats.per_tenant, stats.queue_live,
                         stats.queue_capacity)
        self.state = self.state._replace(paged=paged)
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
