"""Workload composition: arrivals × lengths × prefixes × priorities (a
copy of :mod:`repro.loadgen.workload` over the port's scheduler; seeded
draws are the JAX package's, draw for draw).

A :class:`LoadgenSpec` fully determines a timed request stream from one
seed: the arrival process places requests on the virtual clock, the
heavy-tailed samplers size their prompts and generation budgets, and the
mix knobs shape WHAT the requests stress — ``shared_prefix_frac`` makes a
fraction of prompts open with one common system-prompt prefix (exercising
the prefix cache), ``priority_frac`` promotes a fraction to priority 1
(exercising preemption under ``--preemption``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..serve.scheduler import Request
from .arrivals import (bounded_pareto_lengths, bursty_arrivals,
                       diurnal_arrivals, poisson_arrivals)

ARRIVAL_KINDS = ("poisson", "bursty", "diurnal")


@dataclasses.dataclass(frozen=True)
class LoadgenSpec:
    """Seeded open-loop workload description (all times in decode steps)."""

    n_requests: int = 32
    arrival: str = "poisson"          # one of ARRIVAL_KINDS
    rate: float = 0.25                # mean arrivals per decode step
    # bursty (Markov-modulated) knobs: quiet rate is `rate`, burst rate is
    # `rate * burst_factor`, mean regime dwell is `burst_dwell` steps
    burst_factor: float = 8.0
    burst_dwell: float = 24.0
    # diurnal knobs: rate(t) = rate * (1 + amplitude * sin(2*pi*t/period))
    diurnal_amplitude: float = 0.8
    diurnal_period: float = 256.0
    # heavy-tailed lengths (bounded Pareto)
    prompt_alpha: float = 2.0
    prompt_min: int = 8
    prompt_cap: int = 48
    output_alpha: float = 1.5
    output_min: int = 2
    output_cap: int = 12
    # mixes
    shared_prefix_frac: float = 0.0   # fraction opening with the common prefix
    shared_prefix_tokens: int = 16
    priority_frac: float = 0.0        # fraction promoted to priority 1
    seed: int = 0


def build_workload(spec: LoadgenSpec, vocab_size: int,
                   rng: Optional[np.random.RandomState] = None,
                   ) -> list[tuple[float, Request]]:
    """``[(arrival_step, Request), ...]`` sorted by virtual arrival time.

    Deterministic in ``spec`` (one RandomState seeded from ``spec.seed``
    drives every draw); ``rng`` overrides the generator for callers
    composing several workloads from one stream.
    """
    if spec.arrival not in ARRIVAL_KINDS:
        raise ValueError(f"unknown arrival process {spec.arrival!r}; "
                         f"expected one of {ARRIVAL_KINDS}")
    rng = rng or np.random.RandomState(spec.seed)
    n = spec.n_requests
    if spec.arrival == "poisson":
        times = poisson_arrivals(n, spec.rate, rng)
    elif spec.arrival == "bursty":
        times, _ = bursty_arrivals(n, spec.rate,
                                   spec.rate * spec.burst_factor,
                                   spec.burst_dwell, rng)
    else:
        times = diurnal_arrivals(n, spec.rate, spec.diurnal_amplitude,
                                 spec.diurnal_period, rng)

    plens = bounded_pareto_lengths(n, spec.prompt_alpha, spec.prompt_min,
                                   spec.prompt_cap, rng)
    olens = bounded_pareto_lengths(n, spec.output_alpha, spec.output_min,
                                   spec.output_cap, rng)
    shared = rng.uniform(size=n) < spec.shared_prefix_frac
    hi_pri = rng.uniform(size=n) < spec.priority_frac
    prefix = rng.randint(0, vocab_size,
                         size=spec.shared_prefix_tokens).astype(np.int32)

    out = []
    for rid in range(n):
        plen = int(plens[rid])
        tokens = rng.randint(0, vocab_size, size=plen).astype(np.int32)
        if shared[rid] and plen > spec.shared_prefix_tokens:
            tokens[:spec.shared_prefix_tokens] = prefix
        out.append((float(times[rid]), Request(
            rid=rid, tokens=tokens, max_new_tokens=int(olens[rid]),
            priority=1 if hi_pri[rid] else 0)))
    return out
