"""Reduction of the profiler's device trace of a traced run.

The profiler (``torch.profiler``, CUDA activity only) records the last
:data:`portbench.core.TRACE_SECONDS` of the window, from one call boundary
to another.  From it: the seconds in which any device operation ran (the
union of their intervals), each kernel family's device seconds, the
operations that took most time, and the device's idle gaps
labelled by what the benchmark's spans say the host was doing then.
"""
from __future__ import annotations

from typing import Iterable

#: kernel family -> substrings of its CUDA kernels' names
FAMILIES = {
    "paged_attention": ("paged_attention_kernel", "paged_combine_kernel"),
    "flash_attention": ("flash_mma_kernel", "flash_attention_kernel"),
    "support_core": ("support_core_burst_kernel",),
}
TOP = 10


def family(name: str):
    for fam, keys in FAMILIES.items():
        if any(k in name for k in keys):
            return fam
    return None


def union_seconds(intervals: Iterable[tuple[int, int]]) -> tuple[float, list]:
    """Seconds covered by ``[start_ns, end_ns)`` intervals, and the merged
    intervals in order."""
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged) / 1e9, merged


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters, at most 100 characters."""
    n = name[5:] if name.startswith("void ") else name
    depth, out = 0, []
    for ch in n:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return ("".join(out).strip() or name)[:100]


def device_events(prof) -> list[tuple[str, int, int]]:
    """``(name, start_ns, end_ns)`` of every device operation."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    try:
        events = prof.profiler.kineto_results.events()
        for e in events:
            if e.device_type() == cuda:
                s = int(e.start_ns())
                out.append((e.name(), s, s + int(e.duration_ns())))
    except AttributeError:          # an older profiler: FunctionEvents
        for e in prof.events():
            if e.device_type == cuda:
                out.append((e.name, int(e.time_range.start * 1e3),
                            int(e.time_range.end * 1e3)))
    return out


STEP = "decode step (host dispatch and sync)"
REST = "window rest (admission, prefill, release, commit)"
LOOP = "between windows (the benchmark's loop, waiting for arrivals)"


def host_segments(windows: list, t0: float, t1: float) -> list:
    """``[(start, end, label)]`` covering host seconds ``[t0, t1]`` in
    order: what the benchmark's spans say the host was doing."""
    out, t = [], t0
    for w in windows:
        marks = [(w.t0, REST)] + [m for s0, s1 in w.steps
                                  for m in ((s0, STEP), (s1, REST))]
        marks.append((w.t1, LOOP))
        label = LOOP
        for at, nxt in marks:
            at = min(max(at, t0), t1)
            if at > t:
                out.append((t, at, label))
                t = at
            label = nxt
    if t < t1:
        out.append((t, t1, LOOP))
    return out


def summarise(events: list, t0: float, t1: float, epoch_ns: int,
              windows: list) -> dict:
    """The traced span's numbers from its device events; ``epoch_ns``
    maps host perf-counter seconds to the trace's clock."""
    busy, merged = union_seconds((s, e) for _, s, e in events)
    fam_s = {f: 0.0 for f in FAMILIES}
    by_name: dict[str, float] = {}
    for name, s, e in events:
        f = family(name)
        if f is not None:
            fam_s[f] += (e - s) / 1e9
        k = short_name(name)
        by_name[k] = by_name.get(k, 0.0) + (e - s) / 1e9
    lo = int(t0 * 1e9) + epoch_ns
    hi = int(t1 * 1e9) + epoch_ns
    edges = [lo] + [x for m in merged for x in m] + [hi]
    segs = [(int(a * 1e9) + epoch_ns, int(b * 1e9) + epoch_ns, label)
            for a, b, label in host_segments(windows, t0, t1)]
    idle: dict[str, float] = {}
    j = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, lo), min(b, hi)
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s0, s1, label = segs[k]
            part = min(b, s1) - max(a, s0)
            if part > 0:
                idle[label] = idle.get(label, 0.0) + part / 1e9
            k += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy, "window_s": t1 - t0, "kernel_s": fam_s,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}


def reduce(run, prof) -> None:
    """Fill ``run.trace`` from the profiler of the traced span."""
    t = run.trace
    t.update(summarise(device_events(prof), t["t0"], t["t1"],
                       t["epoch_ns"], run.windows[t["first"]:t["last"]]))
