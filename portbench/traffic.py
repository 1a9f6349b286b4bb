"""The one traffic generator: a mix file of parameters in, a seeded
schedule of requests out.

Every seed gets the same set of sizes and gaps, in another order: a
length distribution gives ``n`` requests the lengths at its quantiles
``(i + 1/2) / n``; a Poisson process gives its ``n`` interarrival gaps the
exponential's quantiles, scaled to fill the segment exactly.  The seed
shuffles each set whole (a uniform random permutation), so arrivals
cluster and long prompts bunch as independent draws would, while the
work a run offers does not change with the seed; its order and the token
ids do.

A mix (``portbench/traffic/<cell>.json``)::

    {"source": <where the lengths come from>, "assumed": {...},
     "loop": "open" | "backlog",
     "arrival": {"process": "poisson", "rate": <requests/s>},   (open)
     "warmup_s": <s of arrivals before the window>,              (open)
     "request_s": <s a request is in flight>, "in_flight_s": <s>, (open)
     "requests": <n queued at t = 0>,                            (backlog)
     "warmup": {"requests": <n>, "output": <dist>},              (backlog)
     "prompt": <dist>, "output": <dist>,
     "engine": {...}, "drain_s": <s>, "check": {...}}

A dist is ``{"dist": "lognormal", "median", "sigma", "lo", "hi"}`` (a
log-normal conditioned on ``[lo, hi]``: the requests a lane cannot hold
are left out, not cut) or ``{"dist": "uniform", "lo", "hi"}``; lengths
are integers, both ends included.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np

_NORMAL = NormalDist()


@dataclasses.dataclass
class Item:
    """One request of the schedule."""

    rid: int
    due: float                 # seconds from the segment's origin
    prompt: np.ndarray         # int32 token ids
    max_new_tokens: int
    segment: str               # "warmup" or "window"


def quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _lognormal_span(dist: dict) -> tuple[float, float, float, float]:
    """``(mu, sigma, F(lo), F(hi))`` of a conditioned log-normal, the
    bounds taken half a token out so that each integer keeps its share."""
    mu, sig = math.log(float(dist["median"])), float(dist["sigma"])
    cdf = [_NORMAL.cdf((math.log(x) - mu) / sig)
           for x in (float(dist["lo"]) - 0.5, float(dist["hi"]) + 0.5)]
    return mu, sig, cdf[0], cdf[1]


def lengths(dist: dict, n: int) -> np.ndarray:
    """The ``n`` lengths of ``dist`` at its quantiles, ascending."""
    u = quantiles(n)
    lo, hi = int(dist["lo"]), int(dist["hi"])
    if dist["dist"] == "lognormal":
        mu, sig, f0, f1 = _lognormal_span(dist)
        z = [_NORMAL.inv_cdf(f0 + q * (f1 - f0)) for q in u]
        raw = np.rint(np.exp(mu + sig * np.asarray(z)))
        return np.clip(raw, lo, hi).astype(np.int64)
    if dist["dist"] == "uniform":
        return lo + np.floor(u * (hi - lo + 1)).astype(np.int64)
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


def mean_length(dist: dict) -> float:
    """The distribution's own mean (not the quantile set's; a
    log-normal's before rounding to whole tokens)."""
    lo, hi = float(dist["lo"]), float(dist["hi"])
    if dist["dist"] == "uniform":
        return (lo + hi) / 2
    mu, sig, f0, f1 = _lognormal_span(dist)
    # E[X | a < X < b] = e^(mu + sig^2 / 2) * (P(a, b) shifted by sig) / P
    shifted = [_NORMAL.cdf((math.log(x) - mu) / sig - sig)
               for x in (lo - 0.5, hi + 0.5)]
    return math.exp(mu + sig * sig / 2) * (shifted[1] - shifted[0]) \
        / (f1 - f0)


def median_length(dist: dict) -> float:
    return float(np.median(lengths(dist, 4001)))


def residual_lengths(dist: dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles of what is left of the requests in
    flight in a steady open loop: the residual of ``dist``, whose chance of
    ``r`` tokens to go is proportional to ``P(length >= r)`` (at least 1)."""
    hi = int(dist["hi"])
    full = lengths(dist, 4096)
    r = np.arange(1, hi + 1)
    surv = (full[None, :] >= r[:, None]).mean(axis=1)
    cdf = np.cumsum(surv) / surv.sum()
    return r[np.minimum(np.searchsorted(cdf, quantiles(n)), hi - 1)]


def gaps(rate: float, n: int, span: float) -> np.ndarray:
    """``n`` exponential interarrival gaps at the quantiles, scaled to sum
    to ``span`` seconds (ascending; the caller permutes them)."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    g = -np.log1p(-quantiles(n)) / rate
    return g * (span / g.sum())


def shuffled(values: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    return np.asarray(values)[rng.permutation(len(values))]


def _segment(rng: np.random.RandomState, n: int, prompt: dict, output: dict,
             vocab: int) -> tuple[np.ndarray, np.ndarray, list]:
    p = shuffled(lengths(prompt, n), rng)
    o = shuffled(lengths(output, n), rng)
    toks = [rng.randint(0, vocab, size=int(k)).astype(np.int32) for k in p]
    return p, o, toks


def schedule(mix: dict, seed: int, seconds: float, vocab: int) -> list[Item]:
    """The requests of one run, in due order.  Open loop: ``round(rate *
    request_s)`` requests, the steady count in flight, with the residual
    output lengths (:func:`residual_lengths`),
    due evenly over the first ``in_flight_s`` of the warm-up, so that the
    lanes start near their steady load; ``warmup_s`` of arrivals due from
    ``-warmup_s``; then ``round(rate * seconds)`` due in ``[0, seconds)``,
    the window's first at 0.  Backlog: the warm-up's requests, then
    ``requests`` more, all due at 0."""
    rng = np.random.RandomState(seed % (2 ** 32))
    items: list[Item] = []
    if mix["loop"] == "open":
        rate = float(mix["arrival"]["rate"])
        if mix["arrival"]["process"] != "poisson":
            raise ValueError(f"unknown arrival process "
                             f"{mix['arrival']['process']!r}")
        warm = float(mix.get("warmup_s", 0.0))
        n0 = int(round(rate * float(mix.get("request_s", 0.0))))
        if n0:
            span0 = float(mix.get("in_flight_s", 1.0))
            p = shuffled(lengths(mix["prompt"], n0), rng)
            o = shuffled(residual_lengths(mix["output"], n0), rng)
            toks = [rng.randint(0, vocab, size=int(k)).astype(np.int32)
                    for k in p]
            items += [Item(len(items), -warm + span0 * i / n0, tk, int(k),
                           "warmup") for i, (tk, k) in enumerate(zip(toks, o))]
        for seg, start, span in (("warmup", -warm, warm),
                                 ("window", 0.0, float(seconds))):
            n = int(round(rate * span))
            if not n:
                continue
            g = shuffled(gaps(rate, n, span), rng)
            due = start + np.concatenate([[0.0], np.cumsum(g)[:-1]])
            p, o, toks = _segment(rng, n, mix["prompt"], mix["output"], vocab)
            items += [Item(len(items), float(t), tk, int(k), seg)
                      for t, tk, k in zip(due, toks, o)]
    elif mix["loop"] == "backlog":
        warm = mix.get("warmup", {})
        segs = [("warmup", int(warm.get("requests", 0)),
                 warm.get("output", mix["output"])),
                ("window", int(mix["requests"]), mix["output"])]
        for seg, n, out in segs:
            if not n:
                continue
            p, o, toks = _segment(rng, n, mix["prompt"], out, vocab)
            items += [Item(len(items), 0.0, tk, int(k), seg)
                      for tk, k in zip(toks, o)]
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    return items


def offered_output_tokens_per_s(mix: dict) -> float:
    """What an open loop offers: rate times the mean output length."""
    return float(mix["arrival"]["rate"]) * mean_length(mix["output"])


def percentile(values: list, q: float) -> float:
    """The ``q``-th percentile of ``values`` by nearest rank."""
    if not values:
        return math.nan
    return sorted(values)[max(1, math.ceil(q / 100.0 * len(values))) - 1]
