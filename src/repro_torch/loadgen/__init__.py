"""`repro_torch.loadgen`: open-loop traffic and allocator-op trace record
and replay (port of :mod:`repro.loadgen`).

* Open loop (:mod:`.arrivals`, :mod:`.workload`, :mod:`.driver`): seeded
  Poisson, bursty and diurnal arrivals with heavy-tailed prompt and output
  lengths, shared-prefix and priority mixes; the driver submits to a
  :class:`~repro_torch.serve.multi_engine.MultiEngine` by virtual arrival
  time and reports p50/p90/p99 time to first token, per-token latency and
  queue depth.
* Trace (:mod:`.trace`): a recorder on ``AllocService`` writes every
  allocator op to the JAX package's tracefile format; the replayer drives
  a tracefile through a model-free ``AllocService`` under any policy, or
  through the allocator simulator's policies (``replay_sim_policies``).
"""
from .arrivals import (bounded_pareto_lengths, bursty_arrivals,
                       diurnal_arrivals, poisson_arrivals)
from .driver import OpenLoopReport, run_open_loop
from .trace import (AllocTrace, ReplayResult, TraceRecorder,
                    certify_complete, load_trace, record_service,
                    replay_sim_policies, replay_trace, save_trace,
                    to_sim_trace)
from .workload import ARRIVAL_KINDS, LoadgenSpec, build_workload

__all__ = [
    "ARRIVAL_KINDS", "AllocTrace", "LoadgenSpec", "OpenLoopReport",
    "ReplayResult", "TraceRecorder", "bounded_pareto_lengths",
    "build_workload", "bursty_arrivals", "certify_complete",
    "diurnal_arrivals", "load_trace", "poisson_arrivals", "record_service",
    "replay_sim_policies", "replay_trace", "run_open_loop", "save_trace",
    "to_sim_trace",
]
