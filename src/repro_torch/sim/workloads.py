"""Workload descriptors and trace generators of the allocator simulator
(a copy of :mod:`repro.sim.workloads`: numpy only, so the traces are
byte-identical to the JAX package's).

One :class:`WorkloadSpec` per paper benchmark (§6.1.2):
  multi-threaded: Larson, Xmalloc, Cache-Scratch, Sh6/Sh8bench, Mstress,
                  AllocTest (mimalloc-bench); BFS, BC (GAPBS); DC (NAS)
  single-threaded: Espresso, Cfrac; Redis LPUSH/RPUSH/LPOP/RPOP/SADD/SPOP

``alloc_instr_frac`` comes from paper Table 3 (multi-threaded) or §6.2.1
(single-threaded ~3%).  The remaining descriptors (working set, cross-thread
free fraction, burstiness) are *calibrated* so that the three software
baselines land in the paper's reported bands; the hardware policies are
then evaluated with NO further per-workload tuning.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: bytes per size class (geometric, 16B..2KB — Fig. 6 style segregated classes)
SIZE_CLASS_BYTES = np.array([16, 32, 64, 128, 256, 512, 1024, 2048], np.int64)
NUM_CLASSES = len(SIZE_CLASS_BYTES)

#: average instructions per allocator call (fast-path malloc ~60cy @ IPC 1.4)
INSTR_PER_ALLOC_OP = 60.0
IPC_BASE = 1.4


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    threads: int
    alloc_instr_frac: float        # Table 3 (fraction, e.g. 0.0599)
    foreign_free_frac: float       # frees issued by a non-owner thread
    size_dist: str                 # small | pareto | uniform | fixed
    user_ws_lines: float           # user L2 working set (cache lines)
    user_lines_per_1k: float       # user L2 touches per 1k instructions
    burst: float = 1.0             # arrival burstiness (queue-model multiplier)
    churn: float = 0.6             # fraction of objects freed soon after alloc
    false_sharing: float = 0.0     # cache-scratch style passive false sharing
    events_per_1k: float = 0.0     # allocator ops / 1k instr / thread (calibrated;
    #                                0 -> derive from alloc_instr_frac)
    user_miss_cycles: float = 0.0  # user memory-stall cycles per 1k instr
    #                                (calibrated; 0 -> derive from ws/lines)
    seed: int = 0

    @property
    def events_per_1k_instr(self) -> float:
        """allocator ops (malloc+free) per 1k instructions per thread."""
        if self.events_per_1k > 0:
            return self.events_per_1k
        return self.alloc_instr_frac * 1000.0 / INSTR_PER_ALLOC_OP


MULTI_THREADED: dict[str, WorkloadSpec] = {w.name: w for w in [
    WorkloadSpec("larson",    16, 0.0599, 0.55, "small",  7000, 90, burst=1.5, churn=0.5,
                 events_per_1k=2.16, user_miss_cycles=102.4, seed=1),
    WorkloadSpec("xmalloc",   16, 0.0245, 0.90, "small",  2200, 45, burst=1.2, churn=0.7,
                 events_per_1k=0.1, user_miss_cycles=51.2, seed=2),
    WorkloadSpec("scratch",   16, 0.0262, 0.10, "fixed",  2500, 70, burst=1.0, churn=0.9,
                 false_sharing=1.0, events_per_1k=0.39, user_miss_cycles=51.2, seed=3),
    WorkloadSpec("sh6bench",  16, 0.0555, 0.05, "small",  5200, 85, burst=1.6, churn=0.6,
                 events_per_1k=1.12, user_miss_cycles=51.2, seed=4),
    WorkloadSpec("sh8bench",  16, 0.0722, 0.05, "small",  4200, 70, burst=1.8, churn=0.6,
                 events_per_1k=0.35, user_miss_cycles=51.2, seed=5),
    WorkloadSpec("mstress",   16, 0.0546, 0.30, "small",  5600, 80, burst=1.5, churn=0.5,
                 events_per_1k=0.78, user_miss_cycles=51.2, seed=6),
    WorkloadSpec("alloctest", 16, 0.0391, 0.05, "pareto", 1600, 50, burst=2.0, churn=0.8,
                 events_per_1k=0.1, user_miss_cycles=51.2, seed=7),
    WorkloadSpec("bfs",       16, 0.0307, 0.20, "uniform", 10500, 130, burst=1.3, churn=0.4,
                 events_per_1k=3.2, user_miss_cycles=51.2, seed=8),
    WorkloadSpec("bc",        16, 0.0037, 0.20, "uniform", 8500, 95, burst=1.0, churn=0.4,
                 events_per_1k=0.1, user_miss_cycles=51.2, seed=9),
    WorkloadSpec("dc",        16, 0.0694, 0.10, "uniform", 7500, 85, burst=1.4, churn=0.5,
                 events_per_1k=0.1, user_miss_cycles=175.0, seed=10),
]}

SINGLE_THREADED: dict[str, WorkloadSpec] = {w.name: w for w in [
    WorkloadSpec("espresso", 1, 0.040, 0.0, "small",  3000, 70, churn=0.8, seed=11),
    WorkloadSpec("cfrac",    1, 0.055, 0.0, "small",  1200, 55, churn=0.9, seed=12),
    WorkloadSpec("redis-lpush", 1, 0.030, 0.0, "fixed", 5000, 80, churn=0.3, seed=13),
    WorkloadSpec("redis-rpush", 1, 0.030, 0.0, "fixed", 5000, 80, churn=0.3, seed=14),
    WorkloadSpec("redis-lpop",  1, 0.030, 0.0, "fixed", 5000, 80, churn=0.7, seed=15),
    WorkloadSpec("redis-rpop",  1, 0.030, 0.0, "fixed", 5000, 80, churn=0.7, seed=16),
    WorkloadSpec("redis-sadd",  1, 0.032, 0.0, "fixed", 5500, 82, churn=0.3, seed=17),
    WorkloadSpec("redis-spop",  1, 0.032, 0.0, "fixed", 5500, 82, churn=0.7, seed=18),
]}

ALL_WORKLOADS = {**MULTI_THREADED, **SINGLE_THREADED}

#: paper Table 3 — speedups over Jemalloc @ 16 threads (validation targets)
PAPER_TABLE3 = {
    #            TCMalloc  Mimalloc  SpeedMalloc
    "larson":    (2.71, 2.17, 3.19),
    "xmalloc":   (1.06, 1.09, 1.16),
    "scratch":   (1.49, 1.54, 1.62),
    "sh6bench":  (1.63, 1.45, 1.73),
    "sh8bench":  (1.31, 1.39, 1.49),
    "mstress":   (1.65, 1.62, 1.71),
    "alloctest": (1.04, 1.40, 1.46),
    "bfs":       (2.55, 2.50, 3.57),
    "bc":        (1.18, 1.16, 1.20),
    "dc":        (1.10, 1.39, 1.64),
}
#: paper geomean speedups @16T: SpeedMalloc over {Je, TC, Mi, Mallacc, Memento+}
PAPER_GEOMEAN = {"jemalloc": 1.75, "tcmalloc": 1.18, "mimalloc": 1.15,
                 "mallacc": 1.23, "memento": 1.18}


def make_trace(spec: WorkloadSpec, num_events: int = 4096,
               threads: int | None = None) -> dict[str, np.ndarray]:
    """Synthesize an allocation event trace.

    Arrays: thread [E], op [E] (1=malloc, 2=free), size_class [E],
    foreign [E] (free issued by non-owner), all int32.
    Malloc/free are balanced (live set stays bounded); `churn` controls how
    quickly an allocation is freed (LIFO-ish vs long-lived).
    """
    T = threads if threads is not None else spec.threads
    rng = np.random.RandomState(spec.seed * 7919 + T)
    E = num_events

    if spec.size_dist == "small":
        probs = np.array([0.30, 0.28, 0.20, 0.12, 0.06, 0.02, 0.01, 0.01])
    elif spec.size_dist == "pareto":
        raw = 1.0 / (np.arange(1, NUM_CLASSES + 1) ** 1.3)
        probs = raw / raw.sum()
    elif spec.size_dist == "fixed":
        probs = np.zeros(NUM_CLASSES)
        probs[2] = 1.0
    else:  # uniform
        probs = np.full(NUM_CLASSES, 1.0 / NUM_CLASSES)

    thread = rng.randint(0, T, size=E).astype(np.int32)
    size_class = rng.choice(NUM_CLASSES, size=E, p=probs).astype(np.int32)
    # op stream: malloc until churn triggers a free of a pending object
    op = np.ones(E, np.int32)
    pending = 0
    for i in range(E):
        if pending > 0 and rng.rand() < spec.churn * pending / (pending + 4):
            op[i] = 2
            pending -= 1
        else:
            op[i] = 1
            pending += 1
    foreign = (rng.rand(E) < spec.foreign_free_frac) & (op == 2)
    return {
        "thread": thread,
        "op": op,
        "size_class": size_class,
        "foreign": foreign.astype(np.int32),
    }
