"""Seeded arrival processes and heavy-tailed length samplers (a copy of
:mod:`repro.loadgen.arrivals`, numpy only; seeded draws are the JAX
package's, draw for draw).

All times are in VIRTUAL decode-step units (``MultiEngine.step_window``
advances the clock by ``quantum`` steps per window), so a workload is
machine-independent: the same seed yields the same arrival schedule on any
host, and wall-clock only enters when the driver measures latency.
Every generator takes a ``numpy.random.RandomState`` — determinism is the
contract the record/replay differential and the regression gates rely on.
"""
from __future__ import annotations

import numpy as np


def poisson_arrivals(n: int, rate: float,
                     rng: np.random.RandomState) -> np.ndarray:
    """``[n]`` float64 arrival times of a Poisson process.

    ``rate`` is mean arrivals per decode step; interarrivals are i.i.d.
    Exponential(rate), so their mean is ``1/rate`` and their coefficient
    of variation is 1.
    """
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def bursty_arrivals(n: int, rate_lo: float, rate_hi: float, dwell: float,
                    rng: np.random.RandomState,
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Two-state Markov-modulated Poisson process (quiet/burst regimes).

    Interarrivals draw from the current regime's rate; after each arrival
    the regime flips with probability ``1 - exp(-gap / dwell)`` (``dwell``
    = mean steps spent in a regime).  Returns ``(times, regimes)`` with
    ``regimes[i] in {0 (lo), 1 (hi)}`` so tests can assert the process
    actually alternates.
    """
    if min(rate_lo, rate_hi) <= 0 or dwell <= 0:
        raise ValueError("rates and dwell must be positive")
    times = np.empty(n)
    regimes = np.empty(n, np.int32)
    t, regime = 0.0, 0
    for i in range(n):
        gap = rng.exponential(1.0 / (rate_hi if regime else rate_lo))
        t += gap
        times[i] = t
        regimes[i] = regime
        if rng.uniform() < 1.0 - np.exp(-gap / dwell):
            regime = 1 - regime
    return times, regimes


def diurnal_arrivals(n: int, base_rate: float, amplitude: float,
                     period: float,
                     rng: np.random.RandomState) -> np.ndarray:
    """Sinusoidally-modulated Poisson process (diurnal ramp), by thinning.

    Instantaneous rate ``lam(t) = base_rate * (1 + amplitude *
    sin(2*pi*t/period))``; candidates from a homogeneous process at
    ``lam_max`` are accepted with probability ``lam(t)/lam_max``
    (Lewis–Shedler thinning), preserving exact Poisson statistics within
    any narrow time slice.
    """
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    if base_rate <= 0 or period <= 0:
        raise ValueError("base_rate and period must be positive")
    lam_max = base_rate * (1.0 + amplitude)
    times = np.empty(n)
    t, i = 0.0, 0
    while i < n:
        t += rng.exponential(1.0 / lam_max)
        lam = base_rate * (1.0 + amplitude * np.sin(2 * np.pi * t / period))
        if rng.uniform() * lam_max < lam:
            times[i] = t
            i += 1
    return times


def bounded_pareto_lengths(n: int, alpha: float, lo: int, hi: int,
                           rng: np.random.RandomState) -> np.ndarray:
    """``[n]`` int heavy-tailed lengths: Pareto(alpha) scaled by ``lo``,
    hard-capped at ``hi`` (a cap the tests assert is respected — an
    uncapped tail would blow past prefill buckets and page budgets)."""
    if not lo <= hi:
        raise ValueError(f"need lo <= hi, got {lo} > {hi}")
    raw = lo * (1.0 + rng.pareto(alpha, size=n))
    return np.minimum(raw, hi).astype(np.int64)
