"""Allocator policy models: the paper's five baselines + IC-Malloc + SpeedMalloc
(a copy of :mod:`repro.sim.policies`; the prefix-cache replay drives the
port's own cache and eviction policies).

Each policy is a :class:`PolicySpec` consumed by the trace engine.  Three
kinds:

  local   — tiered software allocators (Jemalloc / TCMalloc / Mimalloc):
            per-thread caches, shared pool refills guarded by atomics,
            metadata resident in MAIN-core caches (pollution).
  accel   — per-core hardware front-ends (Mallacc, Memento+): local fast
            path at cache-access speed, but the shared tier is unchanged
            (atomics + shared-metadata pollution remain — §2.3).
  central — single-owner offload (IC-Malloc, SpeedMalloc): no thread-local
            metadata on main cores (zero pollution), requests serialized
            through one server.  IC-Malloc pays atomic-based cross-core
            round-trips (§6.4.2); SpeedMalloc pays the 8-cycle signal and
            HMQ service, frees are async (malloc-priority, §5.2).

Structural parameters (batch sizes, cache caps, metadata footprints) follow
each allocator's public design; see inline notes.
"""
from __future__ import annotations

from typing import NamedTuple


class PolicySpec(NamedTuple):
    name: str
    kind: str                       # local | accel | central
    # tiered-cache structure
    refill_batch: int = 16          # objects pulled from shared tier on miss
    local_cap: int = 64             # per-(thread,class) cached objects
    flush_keep: int = 32            # objects kept after a flush
    # metadata footprint on MAIN cores
    md_lines_per_op: float = 2.0    # metadata cache lines touched per op
    md_ws_lines_per_thread: float = 160.0
    # shared-tier synchronization
    atomic_contention_frac: float = 1.0   # fraction of threads contending
    atomics_per_shared_trip: float = 2.0
    atomics_per_foreign_free: float = 1.0
    # instruction-count factor vs Jemalloc (§6.2.2: TCM -11.1%, Mi -13.9%,
    # SpeedMalloc additional -4.97% over TCMalloc)
    instr_factor: float = 1.0
    pf_cycles_per_1k: float = 0.0   # residual page-fault/kernel overhead
    # accel front-end
    accel_cap: int = 0              # buffered entries per size class
    accel_hit_cost: float = 4.0
    # central offload
    service_malloc: float = 0.0
    service_free: float = 0.0
    signal_cost: float = 0.0
    atomics_per_request: float = 0.0  # IC-Malloc software queue
    free_async: bool = False
    # central + per-thread stash front-end (the serving stack's lane stash:
    # a tiny local tier in front of the support-core; refill_batch objects
    # are pulled per refill trip).  0 = no front tier (plain SpeedMalloc).
    stash_cap: int = 0
    # energy accounting
    extra_core: str = "none"        # none | big | little
    per_core_power_adder: float = 0.0


JEMALLOC = PolicySpec(
    # arena-based: moderate thread caching, bin metadata spread across
    # arenas; highest metadata footprint & kernel overhead of the three.
    name="jemalloc", kind="local",
    refill_batch=4, local_cap=16, flush_keep=8,
    md_lines_per_op=4.5, md_ws_lines_per_thread=520.0,
    atomic_contention_frac=0.75,     # 4 arenas serve 16 threads, hot arenas skew
    atomics_per_shared_trip=3.5,
    atomics_per_foreign_free=2.5,    # remote arena lock both ways
    instr_factor=1.0, pf_cycles_per_1k=110.0,  # per event; §6.2.2: page faults in
    #                                kernel, outside the allocation phase
)

TCMALLOC = PolicySpec(
    # per-thread cache + central transfer cache; batch refills; global
    # transfer-cache lock -> full contention.
    name="tcmalloc", kind="local",
    refill_batch=16, local_cap=64, flush_keep=32,
    md_lines_per_op=2.2, md_ws_lines_per_thread=260.0,
    atomic_contention_frac=0.5,      # transfer cache sharded by size class
    atomics_per_shared_trip=2.0,
    instr_factor=0.889, pf_cycles_per_1k=8.0,
)

MIMALLOC = PolicySpec(
    # free-list sharding per page (aggregated metadata layout): cheap local
    # ops, foreign frees via per-page atomic push (low contention).
    name="mimalloc", kind="local",
    refill_batch=32, local_cap=128, flush_keep=64,
    md_lines_per_op=1.6, md_ws_lines_per_thread=200.0,
    atomic_contention_frac=0.22,     # per-page sharded frees
    atomics_per_shared_trip=1.5,
    instr_factor=0.861, pf_cycles_per_1k=7.0,
)

MALLACC = PolicySpec(
    # TCMalloc + 16KB malloc-cache at L1: pops/pushes of hot size classes at
    # ~L1 speed.  Shared tier identical to TCMalloc (multi-thread weakness).
    name="mallacc", kind="accel",
    refill_batch=16, local_cap=64, flush_keep=32,
    md_lines_per_op=1.2, md_ws_lines_per_thread=210.0,
    atomic_contention_frac=1.0, atomics_per_shared_trip=2.0,
    instr_factor=0.889, pf_cycles_per_1k=7.0,
    accel_cap=48, accel_hit_cost=4.0,
    per_core_power_adder=0.04,
)

MEMENTO = PolicySpec(
    # Memento+ (§6.1.3): near-core object allocator, 16 entries per size
    # class; TCMalloc transfer cache on the coherent bus for cross-thread.
    name="memento", kind="accel",
    refill_batch=16, local_cap=16, flush_keep=8,
    md_lines_per_op=0.9, md_ws_lines_per_thread=150.0,
    atomic_contention_frac=1.0, atomics_per_shared_trip=2.0,
    instr_factor=0.889, pf_cycles_per_1k=7.0,
    accel_cap=16, accel_hit_cost=4.0,
    per_core_power_adder=0.06,
)

IC_MALLOC = PolicySpec(
    # §6.4.2: harvest an idle big core; cross-core communication via atomic
    # software queues (no signals, no HMQ); decoupled metadata (no pollution).
    name="ic-malloc", kind="central",
    md_lines_per_op=0.0, md_ws_lines_per_thread=0.0,
    instr_factor=0.889, pf_cycles_per_1k=7.0,
    service_malloc=40.0, service_free=28.0,
    atomics_per_request=2.0,       # enqueue + dequeue/response
    free_async=False,
    extra_core="big",
)

SPEEDMALLOC = PolicySpec(
    # the paper's system: signals (8cy) + HMQ (malloc-priority, async free),
    # centralized metadata in the support-core L1, zero atomics.
    name="speedmalloc", kind="central",
    md_lines_per_op=0.0, md_ws_lines_per_thread=0.0,
    instr_factor=0.845, pf_cycles_per_1k=6.0,  # -4.97% instr vs TCMalloc (§6.2.2)
    service_malloc=14.0, service_free=10.0,
    signal_cost=8.0, atomics_per_request=0.0,
    free_async=True,
    extra_core="little",
)

def speedmalloc_stash(stash_cap: int = 8, refill_batch: int = 4,
                      name: str | None = None) -> PolicySpec:
    """SpeedMalloc + a per-thread stash front-end (the serving stack's
    per-lane page stash, DESIGN.md §7): local pops at cache speed, bulk
    ``refill_batch`` pulls through the HMQ on a miss.  Parameterized so the
    fig14–17 sweeps can model stash-size sensitivity."""
    return SPEEDMALLOC._replace(
        name=name or f"speedmalloc-stash{stash_cap}",
        stash_cap=stash_cap, refill_batch=refill_batch)


#: default stash variant (matches the serving default: S=8, refill 4)
SPEEDMALLOC_STASH = speedmalloc_stash(8, 4, name="speedmalloc-stash")

#: SpeedMalloc with a buddy-system central design (DESIGN.md §15): the
#: support-core walks a per-class buddy tree instead of popping a free
#: list — splits on the way down, buddy-probe + merge on the way up.
#: Grant/fail decisions are availability-only and therefore IDENTICAL to
#: the free-list central (the serving stack's differential suites prove
#: it); only the per-request service cycles differ, so this spec is
#: SPEEDMALLOC with the tree-maintenance cost folded into the HMQ
#: service times.
SPEEDMALLOC_BUDDY = SPEEDMALLOC._replace(
    name="speedmalloc-buddy",
    service_malloc=18.0,       # + tree descent / split on demand
    service_free=14.0,         # + buddy probe and merge cascade
)

#: IC-Malloc ablation variants for Fig. 17 (decoupled -> +signals -> +HMQ)
IC_PLUS_SIGNALS = IC_MALLOC._replace(
    name="ic+signals", signal_cost=8.0, atomics_per_request=0.0,
    service_malloc=30.0, service_free=22.0)
SPEEDMALLOC_FULL = SPEEDMALLOC._replace(name="ic+signals+hmq")

BASELINES = [JEMALLOC, TCMALLOC, MIMALLOC, MALLACC, MEMENTO]
ALL_POLICIES = {p.name: p for p in
                [JEMALLOC, TCMALLOC, MIMALLOC, MALLACC, MEMENTO,
                 IC_MALLOC, SPEEDMALLOC, SPEEDMALLOC_STASH,
                 SPEEDMALLOC_BUDDY]}


# --------------------------------------------------------------------------
# Prefix-cache eviction simulators (DESIGN.md §11): replay the engine's
# logical insert/probe trace through a fresh cache under each EvictionPolicy
# and compare counters — the same differential idiom the stash policy model
# uses against the serving bursts (tests/test_sim.py).
# --------------------------------------------------------------------------

def replay_prefix_trace(trace, eviction: str, budget_pages: int,
                        page_size: int) -> dict:
    """Replay a :class:`~repro_torch.core.paged_kv.PrefixCache` event trace.

    ``trace`` is the engine cache's ``trace`` list — ``("insert", tokens,
    n_pages)``, ``("probe", tokens)``, ``("evict", n)``, and the zero-copy
    aliasing events ``("alias", tokens, n)`` / ``("unalias", tokens, n)``
    (DESIGN.md §12) in lifecycle order.  The replay drives a FRESH cache
    (synthetic block ids — eviction policies key on token content, so block
    identity is irrelevant) under the named ``eviction`` policy and returns
    its counters.  A replay under the SAME policy as the live engine must
    agree exactly on every counter: the engine's cache decisions — including
    which pinned victims eviction skips and requeues — are a pure function
    of the logical event stream, never of allocator state.
    """
    import numpy as np

    from ..alloc.eviction import get_eviction
    from ..core.paged_kv import PrefixCache

    cache = PrefixCache(page_size, budget_pages, policy=get_eviction(eviction))
    next_block = 0
    for ev in trace:
        if ev[0] == "insert":
            _, tokens, n = ev
            blocks = list(range(next_block, next_block + n))
            next_block += n
            cache.insert(np.asarray(tokens, np.int32)[: n * page_size], blocks)
        elif ev[0] == "probe":
            cache.probe(np.asarray(ev[1], np.int32), touch=True)
        elif ev[0] == "evict":
            cache.evict_pages(ev[1])
        elif ev[0] == "alias":
            _, tokens, n = ev
            cache.alias(np.asarray(tokens, np.int32), n)
        elif ev[0] == "unalias":
            _, tokens, n = ev
            cache.unalias(np.asarray(tokens, np.int32), n)
        else:
            raise ValueError(f"unknown trace event {ev[0]!r}")
    return {"hits": cache.hits, "misses": cache.misses,
            "inserts": cache.inserts, "evictions": cache.evictions,
            "dup_skips": cache.dup_skips, "pages": cache.pages,
            "aliases": cache.aliases}
