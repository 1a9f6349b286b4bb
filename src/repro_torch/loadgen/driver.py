"""Open-loop driver: submit by virtual arrival time, measure the tail (a
port of :mod:`repro.loadgen.driver`).

Closed-loop runs (submit everything, wait for the drain) hide queueing
delay.  This driver keeps a VIRTUAL clock in decode-step units (each
``MultiEngine.step_window`` advances it by ``quantum``) and submits every
request whose arrival time has passed, whether or not earlier ones are
done, so a backlog shows up in time to first token.

Per-request timestamps (submit -> first token -> completion) are read on
the wall clock after each window, the finest unit the loop can observe.
A request's first token is its prefill argmax, which the engine copies to
the host inside admission (``ServingEngine.admit_many``) and the
scheduler records in ``Request.output``; so when a window ends, every
token it produced is already on the host and a TTFT on the card is the
time until the token was readable, not a launch time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class _Timing:
    arrival_step: float
    submit_wall: float = 0.0
    submit_step: float = 0.0
    first_wall: Optional[float] = None
    first_step: Optional[float] = None
    done_wall: Optional[float] = None
    done_step: Optional[float] = None
    generated: int = 0
    failed: bool = False


def _pct(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


@dataclasses.dataclass
class OpenLoopReport:
    """Tail-latency rollup of one open-loop run."""

    completed: int
    failed: int
    stranded: int                  # never admitted (starved or aborted)
    windows: int
    decode_steps: int
    wall_s: float
    # TTFT (submit -> first token), wall-clock µs and virtual decode steps
    p50_ttft_us: float
    p90_ttft_us: float
    p99_ttft_us: float
    p50_ttft_steps: float
    p99_ttft_steps: float
    # per-token decode latency (first token -> completion), µs/token
    p50_tpot_us: float
    p99_tpot_us: float
    # queue depth (waiting + running across shards), sampled per window
    queue_depth_mean: float
    queue_depth_max: int
    requests_per_s: float

    def as_metrics(self) -> dict:
        """Flat dict of the report, floats rounded to 3 places."""
        return {k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in dataclasses.asdict(self).items()}


def run_open_loop(me, timed_requests: Sequence[tuple[float, "object"]],
                  max_windows: Optional[int] = None,
                  verbose: bool = False) -> OpenLoopReport:
    """Drive ``me`` (a MultiEngine) through a timed request stream.

    ``timed_requests`` is ``[(arrival_step, Request), ...]`` (from
    :func:`~repro_torch.loadgen.workload.build_workload`).  Requests keep
    their own ``max_new_tokens``.  The loop ends when everything drains, when
    admission starves with no future arrival able to unblock it, or after
    ``max_windows`` (smoke-run bound); undrained requests count as
    ``stranded``.
    """
    pending = sorted(timed_requests, key=lambda tr: tr[0])
    timings = {req.rid: _Timing(arrival_step=t) for t, req in pending}
    seen_first: set = set()
    seen_done: set = set()
    queue_depth: list[int] = []

    now = 0.0
    windows = 0
    t0 = time.perf_counter()
    while pending or me.has_work:
        if max_windows is not None and windows >= max_windows:
            break
        if pending and not me.has_work and pending[0][0] > now:
            # system idle: fast-forward the virtual clock to the next
            # arrival (an open-loop driver never busy-spins empty windows)
            now = pending[0][0]
        submitted = 0
        while pending and pending[0][0] <= now:
            _, req = pending.pop(0)
            tm = timings[req.rid]
            tm.submit_wall = time.perf_counter()
            tm.submit_step = now
            me.submit([req])
            submitted += 1

        progressed = me.step_window()
        windows += 1
        now += me.quantum
        queue_depth.append(sum(len(s.waiting) + len(s.running)
                               for s in me.scheds))

        wall = time.perf_counter()
        for sched in me.scheds:
            for req in sched.running.values():
                if req.output and req.rid not in seen_first:
                    tm = timings[req.rid]
                    tm.first_wall, tm.first_step = wall, now
                    seen_first.add(req.rid)
            for req in sched.finished:
                if req.rid in seen_done:
                    continue
                tm = timings[req.rid]
                if req.rid not in seen_first:
                    # admitted and retired within one window
                    tm.first_wall, tm.first_step = wall, now
                    seen_first.add(req.rid)
                tm.done_wall, tm.done_step = wall, now
                tm.generated = req.generated
                seen_done.add(req.rid)
            for req in sched.failed:
                if req.rid not in seen_done:
                    timings[req.rid].failed = True
                    seen_done.add(req.rid)
        if verbose:
            print(f"window {windows}: t={now:.0f} "
                  f"done={len(seen_done)}/{len(timings)} "
                  f"depth={queue_depth[-1]}")
        if not progressed and not submitted and me.has_work:
            # admission starved and no arrival this window can unblock it
            print(f"WARNING: open-loop admission starved — "
                  f"{sum(len(s.waiting) for s in me.scheds)} request(s) "
                  f"stranded")
            break
    wall_s = time.perf_counter() - t0

    done = [tm for tm in timings.values()
            if tm.done_wall is not None and not tm.failed]
    failed = sum(tm.failed for tm in timings.values())
    ttft_us = [(tm.first_wall - tm.submit_wall) * 1e6 for tm in done]
    ttft_steps = [tm.first_step - tm.arrival_step for tm in done]
    tpot_us = [(tm.done_wall - tm.first_wall) * 1e6 / (tm.generated - 1)
               for tm in done if tm.generated > 1]
    return OpenLoopReport(
        completed=len(done),
        failed=failed,
        stranded=len(timings) - len(done) - failed,
        windows=windows,
        decode_steps=me.stats.decode_steps,
        wall_s=wall_s,
        p50_ttft_us=_pct(ttft_us, 50), p90_ttft_us=_pct(ttft_us, 90),
        p99_ttft_us=_pct(ttft_us, 99),
        p50_ttft_steps=_pct(ttft_steps, 50),
        p99_ttft_steps=_pct(ttft_steps, 99),
        p50_tpot_us=_pct(tpot_us, 50), p99_tpot_us=_pct(tpot_us, 99),
        queue_depth_mean=float(np.mean(queue_depth)) if queue_depth else 0.0,
        queue_depth_max=int(max(queue_depth)) if queue_depth else 0,
        requests_per_s=len(done) / wall_s if wall_s > 0 else 0.0,
    )
