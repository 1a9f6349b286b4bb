"""Cycle cost model of the allocator simulator (port of
:mod:`repro.sim.costmodel`).

All constants trace to the paper:
  * Table 2 -- L1d 4cy, L2 12cy, LLC 24cy; DRAM DDR4-2400 (~100cy at ~3GHz).
  * §2.4 -- "a single atomic instruction ... can consume up to 700 cycles"
    at high core counts; "most allocation functions can be finished within
    100 cycles".
  * Table 2 -- main<->support-core signal latency 8 cycles.
  * §6.3 -- support-core power 33.72% of a main core; area 24.43%.

An analytical event-cost model, not a microarchitectural simulator: the
engine counts events per policy and this module converts counts to cycles.
The formulas run on the host in numpy float32, each Python float cast to
f32 where the JAX package's weak-typed float meets an f32 array
(:mod:`.cachemodel`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

F32 = np.float32


class CostParams(NamedTuple):
    # memory hierarchy (cycles)
    l1_hit: float = 4.0
    l2_hit: float = 12.0
    llc_hit: float = 24.0
    dram: float = 100.0
    # allocator paths (cycles)
    malloc_fast: float = 60.0       # thread-local fast path (<100cy, §2.4)
    malloc_shared: float = 180.0    # shared-cache/central refill excl. atomics
    free_fast: float = 30.0
    free_shared: float = 90.0
    mmap: float = 2500.0            # kernel page mapping (amortized per call)
    # synchronization
    atomic_base: float = 40.0       # uncontended atomic RMW
    atomic_slope: float = 44.0      # +cycles per contending core (~700 @ 16)
    # SpeedMalloc / offload interfaces
    signal: float = 8.0             # main<->support-core signal (Table 2)
    hmq_service_malloc: float = 14.0  # L1-resident free-list pop (few loads @4cy)
    hmq_service_free: float = 10.0
    icq_service: float = 50.0       # IC-Malloc server-side service (sw queue pop + alloc)
    # accelerator baselines
    mallacc_hit: float = 4.0        # malloc-cache pop (L1-speed, Mallacc)
    memento_hit: float = 4.0        # object-allocator hit = 1 cache access
    # power (relative units; main core = 1.0)
    big_core_power: float = 1.0
    support_core_power: float = 0.3372
    uncore_power_frac: float = 0.25   # memory controllers etc. on top of cores
    mallacc_power: float = 0.04       # per-core malloc-cache adder
    memento_power: float = 0.06       # per-core object-allocator adder


DEFAULT_COSTS = CostParams()


def atomic_cost(p: CostParams, contending_cores) -> np.float32:
    """Contended atomic RMW cost; ~`atomic_base` solo, ~700cy at 16 cores."""
    c = F32(contending_cores)
    return F32(p.atomic_base) + F32(p.atomic_slope) * np.maximum(
        c - F32(1.0), F32(0.0))


def queue_wait(service: float, rho) -> np.float32:
    """M/D/1 mean wait for a single-server queue at utilization rho."""
    rho = np.clip(F32(rho), F32(0.0), F32(0.95))
    return F32(service) * rho / (F32(2.0) * (F32(1.0) - rho))


# ---------------- calibration entry points ----------------
# Imports are lazy: ``sim.engine`` imports this module at load time.

def replay_cycles(counts, threads: int,
                  costs: CostParams = DEFAULT_COSTS) -> float:
    """Coarse cycle estimate for a replayed trace's event counts.

    ``counts`` is a ``sim.engine.SimCounts`` (host values).  Prices the
    counted events with the paper-derived constants -- the per-event
    pricing ``simulate`` uses, minus its utilization and queueing terms,
    which need a workload spec.  Good for ranking policies on one trace,
    not for absolute latency claims.
    """
    p = costs
    atomic = F32(float(atomic_cost(p, threads)))
    c = {k: F32(v) for k, v in counts._asdict().items()}
    return float(
        c["fast_hits"] * F32(p.malloc_fast)
        + c["accel_hits"] * F32(p.mallacc_hit)
        + c["shared_trips"] * F32(p.malloc_shared + float(atomic))
        + c["foreign_pushes"] * atomic
        + c["frees"] * F32(p.free_fast)
        + c["mmaps"] * F32(p.mmap))


def calibration_table(threads: int = 16, device=None) -> dict:
    """Sim-vs-paper speedup table over the multi-threaded workloads.

    Returns ``{"rows": {workload: {policy: sim_ratio, "paper": (tc, mi,
    sp)}}, "geomean": {policy: sim}, "paper_geomean": {...}}`` -- the
    check that the sim's software baselines track paper Table 3 (the
    hardware policies are then pure predictions).  The traces run on
    ``device`` (the card unless ``"cpu"``).
    """
    from .engine import geomean, speedup_table
    from .policies import (IC_MALLOC, JEMALLOC, MALLACC, MEMENTO, MIMALLOC,
                           SPEEDMALLOC, TCMALLOC)
    from .workloads import MULTI_THREADED, PAPER_GEOMEAN, PAPER_TABLE3

    pols = [JEMALLOC, TCMALLOC, MIMALLOC, MALLACC, MEMENTO, IC_MALLOC,
            SPEEDMALLOC]
    rows = speedup_table(list(MULTI_THREADED.values()), pols,
                         threads=threads, device=device)
    sims: dict[str, list] = {p.name: [] for p in pols[1:]}
    table = {}
    for name, r in rows.items():
        table[name] = {k: r[k] for k in sims}
        table[name]["paper"] = PAPER_TABLE3[name]
        for k in sims:
            sims[k].append(r[k])
    return {
        "rows": table,
        "geomean": {k: geomean(v) for k, v in sims.items()},
        "paper_geomean": dict(PAPER_GEOMEAN),
    }


def fit_workload_params(name: str, threads: int = 16, device=None,
                        ) -> tuple[float, float, float, tuple]:
    """Fit (user_miss_cycles, events_per_1k) for one workload so the three
    SOFTWARE baselines match paper Table 3 (log-squared loss, speedmalloc
    half-weighted because it is the prediction, not the anchor).

    Grid search then three local refinement rounds; returns
    ``(user_miss_cycles, events_per_1k, err, (tc, mi, sp))``.  The fitted
    values are what ``sim/workloads.py`` carries.
    """
    import dataclasses

    from .engine import simulate
    from .policies import JEMALLOC, MIMALLOC, SPEEDMALLOC, TCMALLOC
    from .workloads import MULTI_THREADED, PAPER_TABLE3

    spec0 = MULTI_THREADED[name]
    t_tc, t_mi, t_sp = PAPER_TABLE3[name]

    def cell(spec, pol):
        return simulate(spec, pol, threads=threads,
                        device=device)["cycles_per_1k"]

    def errs(spec):
        base = cell(spec, JEMALLOC)
        tc, mi, sp = (base / cell(spec, p)
                      for p in (TCMALLOC, MIMALLOC, SPEEDMALLOC))
        return (np.log(tc / t_tc) ** 2 + np.log(mi / t_mi) ** 2
                + 0.5 * np.log(sp / t_sp) ** 2), (tc, mi, sp)

    def at(u, e):
        return dataclasses.replace(spec0, user_miss_cycles=u,
                                   events_per_1k=min(e, 3.2))

    best = None
    for u in (100, 200, 350, 500, 700, 1000, 1400, 1900, 2500, 3200):
        for e in (0.2, 0.4, 0.7, 1.0, 1.4, 1.9, 2.4, 2.8, 3.2):
            err, vals = errs(at(u, e))
            if best is None or err < best[0]:
                best = (err, u, e, vals)
    err, u, e, vals = best
    for _ in range(3):
        bu, be = u, e
        for du in (0.8, 0.9, 1.0, 1.12, 1.25):
            for de in (0.8, 0.9, 1.0, 1.12, 1.25):
                cu, ce = u * du, min(e * de, 3.2)
                err2, v2 = errs(at(cu, ce))
                if err2 < err:
                    err, vals, bu, be = err2, v2, cu, ce
        u, e = bu, be
    return float(u), float(e), float(err), vals
