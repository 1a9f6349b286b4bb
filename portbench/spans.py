"""The program's own timing, read by the benchmark: each ``Request``'s
stamps, and the spans of ``repro_torch.tracing`` on the profiler's clock.

**Stamps.**  ``Request.t_submit``, ``t_admit``, ``t_first`` and
``t_done`` are integer nanoseconds of ``time.perf_counter``, the clock of
a request's ``due``: :func:`stamp_tail_ms` reads the queue wait and the
exact time to the first token (``metrics/queue_wait_p90_ms.py``,
``metrics/first_token_p90_ms.py``), :func:`stamp_tpot_ms` the exact time
per output token (``metrics/tpot_stamp_p90_ms.py``).  A program without
the stamps reads nothing.

**Spans.**  The rest maps a traced span's program spans (``SpanRecord``:
name, start and end ns on the same clock, parent index, attrs) onto the
profiler's clock and reads them against its device events:

* :func:`calibrate`, at each end of the profiled span, opens
  :data:`CALIB` short spans, each around one marker kernel's launch;
  :func:`calibrated` fits an anchor to each group (:func:`launch_offset`:
  a span bounds the offset by where its launch event lies, to a few us)
  and :func:`trace_clock` maps host nanoseconds through the anchors,
  linear between the first and the last;
* :func:`innermost` cuts host time into segments labelled by the
  innermost span open in each, and :func:`idle_by_label` splits the
  device's idle time by them, with the benchmark's own host segments
  (``trace.host_segments``) where no span is open: the total is the
  union's complement, as ``trace.summarise`` has it;
* :func:`trace_events` reads the profiler's device operations with their
  correlation ids and the runtime's launch events, and :func:`attribute`
  gives each kernel the span open at its launch (by correlation id, or
  at its device start where the profiler gave no launch);
* :func:`decode_idle_ms`, :func:`moe_share`, :func:`alloc_share` and
  :func:`child_idle_share` reduce them.

The harness does not record spans yet: a traced run that turns the
recorder on over the profiler's span, calibrates at both ends and keeps
the drained spans on ``run.trace`` is a change to ``core.py`` and
``trace.py``.  ``tools/trace_spans.py`` does that from outside, for a
chip run.
"""
from __future__ import annotations

import bisect
from typing import Optional

from . import traffic as tr

DECODE_STEP = "decode.step"


# ---------------------------------------------------------------- stamps

def stamp_tail_ms(run, since: str, until: str, q: float = 90
                  ) -> Optional[float]:
    """The ``q``-th percentile, in ms, over every request due in the
    window of ``until - since``: each a ``Request`` stamp, or ``"due"``
    for the request's due time.  A request without ``until`` counts to
    the drain's end, as the end-to-end tails count it.  ``None`` where no
    request is due or the program keeps no such stamps."""
    due = run.due_in_window()
    if not due or not hasattr(due[0].request, until):
        return None

    def at(r, name):
        if name == "due":
            return r.due
        ns = getattr(r.request, name)
        return run.t_drained if ns is None else ns / 1e9

    return tr.percentile([(at(r, until) - at(r, since)) * 1e3 for r in due],
                         q)


def stamp_tpot_ms(run, q: float = 90) -> Optional[float]:
    """The ``q``-th percentile, in ms, over every request due in the
    window of ``(t_done - t_first) / (tokens - 1)``: the time per output
    token between the program's own stamps, where the end-to-end tail
    reads the ends of the calls.  A request that failed, was cut or never
    finished counts to the drain's end, as the end-to-end tails count
    it.  ``None`` where no request is due or the program keeps no
    stamps."""
    due = run.due_in_window()
    if not due or not hasattr(due[0].request, "t_done"):
        return None
    out = []
    for r in due:
        req = r.request
        served = req.state == "finished" and not r.truncated \
            and req.t_done is not None
        first = run.t_drained if req.t_first is None else req.t_first / 1e9
        done = req.t_done / 1e9 if served else run.t_drained
        out.append((done - first) * 1e3 / max(r.n_out - 1, 1))
    return tr.percentile(out, q)


# ---------------------------------------------------------------- clocks

#: calibration spans at each end of a profiled span, and their name
CALIB = 10
CALIB_SPAN = "clock.calib"


def calibrate() -> None:
    """:data:`CALIB` short :data:`CALIB_SPAN` spans, each around one
    marker kernel's launch (``torch.cuda._sleep``) right after a
    ``synchronize()``: the recorder must be on, inside the profiler's
    span."""
    import torch
    from repro_torch import tracing
    for _ in range(CALIB):
        torch.cuda.synchronize()
        with tracing.span(CALIB_SPAN):
            torch.cuda._sleep(1)


def launch_offset(windows: list) -> Optional[tuple[int, int]]:
    """The offsets (profiler ns less host ns) that put every launch
    inside its host interval: each window ``(start, end, launch)`` bounds
    it to ``[launch - end, launch - start]``; returns their intersection
    ``(lo, hi)``, or ``None`` where they disagree (a drift, a pairing
    gone wrong)."""
    if not windows:
        return None
    lo = max(t - e for _, e, t in windows)
    hi = min(t - s for s, _, t in windows)
    return (lo, hi) if lo <= hi else None


def calibrated(spans: list, ops: list, launches: dict
               ) -> tuple[list, Optional[list], list]:
    """``(the spans less the calibration ones, the anchors, each fit's
    width in ns)``: an anchor ``(host ns, offset)`` fitted to each group
    of :data:`CALIB` calibration spans, the first and the last, by the
    marker launches they hold (the middle of the offsets
    :func:`launch_offset` allows).  A group with markers missing, or
    whose launches no one offset fits, gives no anchor; ``None`` where
    neither gives one."""
    cal = [s for s in spans if s.name == CALIB_SPAN]
    keep = [i for i, s in enumerate(spans) if s.name != CALIB_SPAN]
    index = {old: new for new, old in enumerate(keep)}
    rest = [spans[i]._replace(parent=index.get(spans[i].parent, -1))
            for i in keep]
    marks = sorted(launches[c] for n, _, _, c in ops
                   if "spin_kernel" in n and c in launches)
    if len(cal) < 2 * CALIB:
        groups = [(cal, marks)] if len(cal) == len(marks) else []
    else:
        # the groups lie at the two ends of the profiled span: a marker
        # launched in its first half is the first group's
        mid = (min(launches.values()) + max(launches.values())) / 2
        groups = [(cal[:CALIB], [t for t in marks if t < mid][:CALIB]),
                  (cal[-CALIB:], [t for t in marks if t >= mid][-CALIB:])]
    anchors, widths = [], []
    for group, at in groups:
        fit = len(at) == len(group) > 0 and launch_offset(
            [(s.start_ns, s.end_ns, t) for s, t in zip(group, at)])
        if fit:
            anchors.append((group[0].start_ns, (fit[0] + fit[1]) // 2))
            widths.append(fit[1] - fit[0])
    return rest, anchors or None, widths


def trace_clock(anchors: list):
    """``host ns -> profiler ns`` through one anchor, or linear between
    the first and last of several."""
    (h0, e0), (h1, e1) = anchors[0], anchors[-1]
    if h1 == h0:
        return lambda t: t + e0
    slope = (e1 - e0) / (h1 - h0)
    return lambda t: t + e0 + round(slope * (t - h0))


def on_trace_clock(spans: list, anchors: list) -> list:
    """The spans with their start and end on the profiler's clock."""
    f = trace_clock(anchors)
    return [s._replace(start_ns=f(s.start_ns), end_ns=f(s.end_ns))
            for s in spans]


# ---------------------------------------------------------------- segments

def innermost(spans: list) -> list[tuple[int, int, int]]:
    """``[(start, end, span index)]``, in order: every stretch of time
    some span covers, labelled by the innermost one open then."""
    kids: list[list[int]] = [[] for _ in spans]
    roots = []
    for i, s in enumerate(spans):
        (kids[s.parent] if s.parent >= 0 else roots).append(i)
    out = []

    def walk(i):
        t = spans[i].start_ns
        for k in kids[i]:
            if spans[k].start_ns > t:
                out.append((t, spans[k].start_ns, i))
            walk(k)
            t = max(t, spans[k].end_ns)
        if spans[i].end_ns > t:
            out.append((t, spans[i].end_ns, i))

    for r in roots:
        walk(r)
    return out


def overlay(primary: list, fallback: list) -> list:
    """``primary`` segments ``(start, end, label)`` where they lie, the
    ``fallback`` ones elsewhere; both sorted and disjoint."""
    out, j = [], 0
    for s, e, label in fallback:
        t = s
        while j < len(primary) and primary[j][1] <= t:
            j += 1
        k = j
        while k < len(primary) and primary[k][0] < e:
            ps, pe, pl = primary[k]
            if ps > t:
                out.append((t, ps, label))
            out.append((max(ps, t), min(pe, e), pl))
            t = min(pe, e)
            k += 1
        if t < e:
            out.append((t, e, label))
    return out


def idle_intervals(merged: list, lo: int, hi: int) -> list:
    """The gaps of ``[lo, hi)`` between the merged busy intervals."""
    edges = [lo] + [x for m in merged for x in m] + [hi]
    out = []
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b))
    return out


def idle_by_label(idle: list, segs: list) -> dict:
    """Seconds of the ``idle`` intervals under each segment's label."""
    out: dict = {}
    j = 0
    for a, b in idle:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s, e, label = segs[k]
            part = min(b, e) - max(a, s)
            if part > 0:
                out[label] = out.get(label, 0.0) + part / 1e9
            k += 1
    return out


def labelled(spans: list, segs: list) -> list:
    """:func:`innermost` segments labelled by their span's name."""
    return [(s, e, spans[i].name) for s, e, i in segs]


def under(spans: list, i: int, name: str) -> bool:
    """Whether span ``i`` is ``name`` or lies inside one."""
    while i >= 0:
        if spans[i].name == name:
            return True
        i = spans[i].parent
    return False


# ---------------------------------------------------------------- kernels

def trace_events(prof) -> tuple[list, dict]:
    """``([(name, start_ns, end_ns, correlation id)]`` of every device
    operation, ``{correlation id: start_ns}`` of the runtime's launch
    events)`` from a ``torch.profiler`` run (CUDA activity records the
    runtime's calls beside the device's work)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ops, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        s = int(e.start_ns())
        if e.device_type() == cuda:
            ops.append((e.name(), s, s + int(e.duration_ns()),
                        int(e.correlation_id())))
        elif e.correlation_id():
            launches[int(e.correlation_id())] = s
    return ops, launches


def attribute(ops: list, launches: dict, segs: list) -> tuple[list, dict]:
    """Each device operation's span (its index, ``-1`` outside every
    span): the innermost one open at its launch, found by correlation id,
    else at its device start.  Returns the indices and how many
    operations each method placed."""
    starts = [s for s, _, _ in segs]
    out, how = [], {"correlation": 0, "device start": 0}
    for _, s, _, corr in ops:
        t = launches.get(corr)
        how["device start" if t is None else "correlation"] += 1
        t = s if t is None else t
        j = bisect.bisect_right(starts, t) - 1
        out.append(segs[j][2] if j >= 0 and t < segs[j][1] else -1)
    return out, how


# ---------------------------------------------------------------- readings

def decode_idle_ms(spans: list, idle: list, lo: int, hi: int
                   ) -> Optional[float]:
    """Device-idle ms inside ``decode.step`` spans (profiler clock), per
    step that starts in ``[lo, hi)``."""
    steps = [(s.start_ns, s.end_ns, DECODE_STEP) for s in spans
             if s.name == DECODE_STEP]
    n = sum(lo <= s < hi for s, _, _ in steps)
    if not n:
        return None
    return 1e3 * idle_by_label(idle, steps).get(DECODE_STEP, 0.0) / n


def child_idle_share(spans: list, idle: list, segs: list) -> Optional[float]:
    """Percent of the idle time inside ``decode.step`` spans that falls
    under one of its child spans rather than its own self time."""
    inside = [(s, e, i) for s, e, i in segs if under(spans, i, DECODE_STEP)]
    by = idle_by_label(idle, [(s, e, spans[i].name == DECODE_STEP)
                              for s, e, i in inside])
    total = sum(by.values())
    return 100.0 * by.get(False, 0.0) / total if total else None


def moe_share(spans: list, ops: list, owner: list) -> Optional[float]:
    """Percent: device time of the operations launched inside ``moe``
    spans of decode steps over that of every operation launched inside a
    ``decode.step``."""
    step = moe = 0
    for (_, s, e, _), i in zip(ops, owner):
        if i >= 0 and under(spans, i, DECODE_STEP):
            step += e - s
            if under(spans, i, "moe"):
                moe += e - s
    return 100.0 * moe / step if step else None


def alloc_share(spans: list, lo: int, hi: int) -> Optional[float]:
    """Percent: host time inside ``alloc.commit`` spans over ``[lo,
    hi)`` (one clock; the spans do not nest in one another)."""
    if hi <= lo:
        return None
    inside = sum(max(0, min(s.end_ns, hi) - max(s.start_ns, lo))
                 for s in spans if s.name == "alloc.commit")
    return 100.0 * inside / (hi - lo)
