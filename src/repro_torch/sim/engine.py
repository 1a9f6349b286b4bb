"""Trace-driven allocator simulator (port of :mod:`repro.sim.engine`).

The *structural* part -- per-thread caches, shared-pool refills, accel
buffers, live/peak accounting -- is simulated event by event: the JAX
package's ``lax.scan`` is one launch of the ``sim_trace`` CUDA kernel per
trace on the card, and its plain version on the CPU
(:mod:`repro_torch.kernels.sim_trace`).  Only the nine counts come back
from the card, in one read per trace.  The *cost* part converts the counts
into cycles with the paper-derived constants (:mod:`.costmodel`) plus the
cache-pollution model (:mod:`.cachemodel`), on the host in float32 where
the JAX package computes in f32 and in Python floats where it casts with
``float(...)``, so the metric dicts agree with the JAX package's.

Outputs per (workload, policy, thread-count): wall-cycles per 1k
instructions (speedups are ratios of these), the Fig. 10/11 decompositions
(L2-miss cycles, atomic cycles), peak memory (Fig. 12), and relative energy
(Fig. 13).  Every entry point runs its traces on ``device``: the card
unless ``"cpu"`` (:func:`repro_torch.device.resolve_device`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.sim_trace.ops import sim_trace
from ..kernels.sim_trace.ref import SimCounts
from . import cachemodel as cm
from .costmodel import DEFAULT_COSTS, CostParams, atomic_cost, queue_wait
from .policies import PolicySpec
from .workloads import (IPC_BASE, NUM_CLASSES, SIZE_CLASS_BYTES, WorkloadSpec,
                        make_trace)

F32 = np.float32

#: extra vulnerability to passive false sharing (cache-scratch); centralized
#: allocation hands out thread-segregated lines (paper §6.2.2 notes Mi/TC
#: handle this better than Je)
FS_VULNERABILITY = {"jemalloc": 1.0, "tcmalloc": 0.35, "mimalloc": 0.20,
                    "mallacc": 0.35, "memento": 0.30, "ic-malloc": 0.15,
                    "speedmalloc": 0.15, "ic+signals": 0.15,
                    "ic+signals+hmq": 0.15}
FS_CYCLES_PER_1K = 95.0

_TRACE_KEYS = ("thread", "op", "size_class", "foreign")
_I32 = np.iinfo(np.int32)


def _events(trace: dict, threads: int) -> np.ndarray:
    """The trace's four arrays as one ``[4, E]`` int32 host array.

    Raises ``ValueError`` on arrays of unequal length, on a thread outside
    ``[0, threads)``, a size class outside ``[0, NUM_CLASSES)`` or a value
    beyond int32 (the JAX scan would clamp the read and drop the write),
    and ``TypeError`` on a non-integer array."""
    if threads < 0:
        raise ValueError(f"threads must be >= 0, got {threads}")
    cols = [np.asarray(trace[k]) for k in _TRACE_KEYS]
    if any(a.ndim != 1 for a in cols) or len({a.shape[0] for a in cols}) > 1:
        raise ValueError("a trace's thread, op, size_class and foreign must "
                         "be 1-D arrays of one length, got shapes "
                         f"{[a.shape for a in cols]}")
    for k, a in zip(_TRACE_KEYS, cols):
        if a.size and a.dtype.kind not in "biu":
            raise TypeError(f"trace[{k!r}] must be integer, got {a.dtype}")
    if cols[0].size:
        for k, a, hi in zip(_TRACE_KEYS, cols,
                            (threads, None, NUM_CLASSES, None)):
            lo_ok, hi_ok = (0, hi) if hi is not None else (_I32.min,
                                                           _I32.max + 1)
            if a.min() < lo_ok or a.max() >= hi_ok:
                raise ValueError(
                    f"trace[{k!r}] holds values in [{a.min()}, {a.max()}], "
                    f"outside [{lo_ok}, {hi_ok})")
    return np.stack(cols).astype(np.int32).reshape(4, -1)


@functools.lru_cache(maxsize=None)
def _sizes(dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(SIZE_CLASS_BYTES, dtype=torch.int32, device=dev)


def _run_trace(policy: PolicySpec, trace: dict, threads: int,
               device: DeviceLike = None) -> SimCounts:
    dev = resolve_device(device)
    events = torch.from_numpy(_events(trace, threads)).to(dev)
    return sim_trace(events, threads, policy, _sizes(dev))


def run_trace_counts(policy: PolicySpec, trace: dict, threads: int,
                     device: DeviceLike = None) -> SimCounts:
    """Structural event counts for a *scripted* trace (public entry point):
    0-d float32 tensors on ``device``.

    Used by the sim<->serve cross-validation: a hand-built trace of the
    serving engine's decode allocation pattern runs through the policy
    model, and ``shared_trips`` predicts the engine's measured HMQ burst
    count."""
    return _run_trace(policy, trace, threads, device)


def host_counts(cnt: SimCounts) -> SimCounts:
    """``cnt`` with each count a numpy float32 scalar: one device read."""
    vals = torch.stack(list(cnt)).cpu().numpy()
    return SimCounts(*(F32(v) for v in vals))


@functools.lru_cache(maxsize=4096)
def _cached_counts(spec_key, policy: PolicySpec, T: int, num_events: int,
                   churn: float, foreign: float, size_dist: str, seed: int,
                   device: torch.device) -> SimCounts:
    """Structural counts depend only on (trace, policy, device) -- cache
    across the cheap cycle re-assemblies (calibration, thread sweeps)."""
    spec_like = WorkloadSpec(name=spec_key, threads=T, alloc_instr_frac=0.05,
                             foreign_free_frac=foreign, size_dist=size_dist,
                             user_ws_lines=1, user_lines_per_1k=1,
                             churn=churn, seed=seed)
    trace = make_trace(spec_like, num_events=num_events, threads=T)
    return host_counts(_run_trace(policy, trace, T, device))


def simulate(spec: WorkloadSpec, policy: PolicySpec, threads: int | None = None,
             costs: CostParams = DEFAULT_COSTS, num_events: int = 4096,
             device: DeviceLike = None) -> dict:
    """Run one (workload, policy, threads) cell; returns the metric dict."""
    T = threads if threads is not None else spec.threads
    cnt = _cached_counts(spec.name, policy, T, num_events, spec.churn,
                         spec.foreign_free_frac, spec.size_dist, spec.seed,
                         resolve_device(device))

    events = cnt.mallocs + cnt.frees
    ev_per_1k = spec.events_per_1k_instr          # per thread
    scale = F32(ev_per_1k) / np.maximum(events, F32(1.0))  # trace -> per 1k

    central = policy.kind == "central"

    # ---- allocator path cycles (per 1k instructions, per thread) ----
    if central and policy.stash_cap > 0:
        # stash front-end over the central server (speedmalloc_stash): only
        # refill trips reach the HMQ; stash hits run at cache speed.  A trip
        # pulls refill_batch blocks -- the first pays the full service, the
        # rest a per-block pop.
        per_trip = policy.service_malloc + 2.0 * max(policy.refill_batch - 1, 0)
        trips_per_1k = float(cnt.shared_trips) * float(scale)
        hits_per_1k = float(cnt.fast_hits) * float(scale)
        frees_per_1k = float(cnt.frees) * float(scale)
        foreign_per_1k = float(cnt.foreign_pushes) * float(scale)
        demand = T * (trips_per_1k * per_trip
                      + foreign_per_1k * policy.service_free)
        client = (hits_per_1k * costs.malloc_fast
                  + trips_per_1k * (2 * policy.signal_cost + per_trip)
                  + frees_per_1k * costs.free_fast
                  + foreign_per_1k * policy.signal_cost)  # async central free
        atomics = cnt.shared_trips * F32(policy.atomics_per_request)
        wall0 = 1000.0 / IPC_BASE + client
        rho = spec.burst * demand / wall0
        wait_m = queue_wait(per_trip, rho)
        alloc_cycles = F32(client + trips_per_1k * float(wait_m))
        queue_cycles = trips_per_1k * float(wait_m)
        serial_floor = float(demand)
    elif central:
        m_frac = float(cnt.mallocs / np.maximum(events, F32(1.0)))
        f_frac = 1.0 - m_frac
        # Support-core demand per 1k instructions (server-side work for ALL
        # threads' requests lands on the single server).
        demand = T * ev_per_1k * (m_frac * policy.service_malloc
                                  + f_frac * policy.service_free)
        per_malloc_base = 2 * policy.signal_cost + policy.service_malloc
        per_free_base = policy.signal_cost + (
            0.0 if policy.free_async
            else policy.signal_cost + policy.service_free)
        client = ev_per_1k * (m_frac * per_malloc_base + f_frac * per_free_base)
        atomics = (cnt.mallocs + cnt.frees) * F32(policy.atomics_per_request)
        wall0 = 1000.0 / IPC_BASE + client
        if policy.free_async:   # malloc-priority: frees don't delay mallocs
            rho = spec.burst * (demand * m_frac * policy.service_malloc
                                / max(m_frac * policy.service_malloc
                                      + f_frac * policy.service_free, 1e-9)) / wall0
        else:
            rho = spec.burst * demand / wall0
        wait_m = queue_wait(policy.service_malloc, rho)
        alloc_cycles = F32(client + ev_per_1k * m_frac * float(wait_m))
        queue_cycles = ev_per_1k * m_frac * float(wait_m)
        serial_floor = float(demand)   # wall >= total server demand
    else:
        serial_floor = 0.0
        alloc_cycles = (cnt.fast_hits * F32(costs.malloc_fast)
                        + cnt.accel_hits * F32(policy.accel_hit_cost)
                        + cnt.shared_trips * F32(costs.malloc_shared)
                        + cnt.frees * F32(costs.free_fast)
                        + cnt.mmaps * F32(costs.mmap)) * scale
        atomics = (cnt.shared_trips * F32(policy.atomics_per_shared_trip)
                   + cnt.foreign_pushes * F32(policy.atomics_per_foreign_free))
        queue_cycles = F32(0.0)

    contenders = np.maximum(F32(policy.atomic_contention_frac * T), F32(1.0))
    atomic_cycles = atomics * atomic_cost(costs, contenders) * scale

    # ---- cache pollution (metadata on main cores) ----
    md_ws = policy.md_ws_lines_per_thread * min(T, 8)   # neighbors' metadata too
    if spec.user_miss_cycles > 0:
        user_mem_cycles = spec.user_miss_cycles
    else:
        base_miss = cm.user_miss_rate(spec.user_ws_lines, cm.L2_LINES)
        user_mem_cycles = (F32(spec.user_lines_per_1k) * base_miss
                           * F32(costs.dram))
    pollution_cycles = float(cm.pollution_cycles_per_1k(
        user_mem_cycles, md_ws, spec.user_ws_lines))
    md_own_cycles = policy.md_lines_per_op * ev_per_1k * 0.15 * costs.dram
    polluted = pollution_cycles + md_own_cycles

    fs_cycles = spec.false_sharing * FS_VULNERABILITY.get(policy.name, 0.3) \
        * FS_CYCLES_PER_1K

    base_cycles = policy.instr_factor * 1000.0 / IPC_BASE
    if isinstance(user_mem_cycles, np.float32):
        # an f32 user term keeps the sums below in f32, as in JAX
        l2_miss_cycles = (user_mem_cycles + F32(pollution_cycles)
                          + F32(md_own_cycles))
        total = F32(base_cycles) + l2_miss_cycles
        md_share = F32(polluted) / max(
            F32(polluted) + user_mem_cycles, 1e-9)
    else:
        l2_miss_cycles = user_mem_cycles + pollution_cycles + md_own_cycles
        total = F32(base_cycles + l2_miss_cycles)
        md_share = polluted / max(polluted + user_mem_cycles, 1e-9)
    total = (total + alloc_cycles + atomic_cycles + F32(fs_cycles)
             + F32(policy.pf_cycles_per_1k * ev_per_1k))
    total = np.maximum(total, F32(serial_floor))  # central server bound

    # ---- memory (Fig. 12): peak live + policy cache overhead ----
    peak = cnt.peak_bytes
    if central and policy.free_async:
        # deferred free: one HMQ window of frees stays live past its free()
        avg_size = float(np.mean(SIZE_CLASS_BYTES))
        peak = peak + F32(T * 2.0 * avg_size)

    return {
        "workload": spec.name, "policy": policy.name, "threads": T,
        "cycles_per_1k": float(total),
        "base_cycles": float(base_cycles),
        "alloc_cycles": float(alloc_cycles),
        "atomic_cycles": float(atomic_cycles),
        "queue_cycles": float(queue_cycles),
        "l2_miss_cycles": float(l2_miss_cycles),
        "pollution_cycles": float(polluted),
        "fs_cycles": float(fs_cycles),
        "peak_bytes": float(peak),
        "fast_hit_rate": float((cnt.fast_hits + cnt.accel_hits)
                               / np.maximum(cnt.mallocs, F32(1.0))),
        "metadata_miss_fraction": float(md_share),
        "energy": float(F32(_power(policy, T, costs)) * total),
    }


def _power(policy: PolicySpec, T: int, costs: CostParams) -> float:
    p = T * (costs.big_core_power + policy.per_core_power_adder)
    if policy.extra_core == "big":
        p += costs.big_core_power
    elif policy.extra_core == "little":
        p += costs.support_core_power
    return p * (1.0 + costs.uncore_power_frac)


def speedup_table(workloads, policies, threads=16, **kw) -> dict:
    """cycles ratios vs the first policy (convention: jemalloc first);
    ``kw`` (``device``, ``costs``, ``num_events``) goes to :func:`simulate`."""
    rows: dict = {}
    for spec in workloads:
        cells = {p.name: simulate(spec, p, threads=threads, **kw) for p in policies}
        base = cells[policies[0].name]["cycles_per_1k"]
        rows[spec.name] = {name: base / c["cycles_per_1k"]
                           for name, c in cells.items()}
        rows[spec.name]["_cells"] = cells
    return rows


def geomean(values) -> float:
    a = np.asarray(list(values), np.float64)
    return float(np.exp(np.log(a).mean()))
