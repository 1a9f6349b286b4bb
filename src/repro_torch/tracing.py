"""Spans on one host clock: the port's one timing system.

One process-wide recorder (:data:`RECORDER`) keeps spans in memory while
it is on:

    from repro_torch import tracing
    tracing.enable()
    ...                                  # serve
    spans = tracing.drain()              # [SpanRecord], start order
    tracing.disable()

``span(name, **attrs)`` is a context manager.  While the recorder is off
it returns one shared no-op object: an attribute check, no clock read.
While it is on, the span appends ``SpanRecord(name, start_ns, end_ns,
parent, attrs)``, where ``parent`` is the index of the span open around
it (``-1`` at the top) in the list :func:`drain` returns.  The clock is
``time.perf_counter_ns`` (:func:`now_ns`), the clock of ``time
.perf_counter``: ``Request``'s stamps and the caller's own
``perf_counter`` readings compare with the spans directly.

``timed(name, **attrs)`` always reads the clock, on or off, and records
like ``span`` while the recorder is on; a caller that times its work
(``ServingEngine.step``, read by ``step_times_us``) reads the timed span's
``start_ns`` / ``end_ns``, so the work is timed in one place.

The spans the serving loop opens (their names are fixed, readers cite
them): ``window`` (``MultiEngine.step_window``) around
``window.admission`` (``run_admission``; attrs ``shard`` and the
admitted ``rids``), ``decode.step`` (``ServingEngine.step``; attr
``shard``) and ``window.commit`` (the window's merged commit).
``window.admission`` holds ``admit.prefill`` (each prefill forward) and
``admit.readback`` (its host copies); ``decode.step`` holds
``decode.forward`` (the model, logits and argmax; in a MoE model one
``moe`` span per layer, each around a ``moe.route``: router, top-k and
dispatch, and a ``moe.experts``: the experts' products),
``decode.alloc`` (``decode_append``: the page write and the gated burst)
and ``decode.readback`` (the step's host copies).  Every
burst goes through ``AllocService.commit``, one ``alloc.commit`` span
(attr ``kind``: ``admission``, ``decode``, ``release``, ``window`` or
``other``; :func:`summary` gives each kind a row of its own).

On the card the decode step is a CUDA graph replay
(:mod:`repro_torch.serve.decode_graph`): ``decode.step`` then holds
``decode.replay`` (the copy-in and the replay's one launch) and
``decode.readback``, and ``decode.forward``, ``decode.alloc``,
``alloc.commit[decode]``, ``moe``, ``moe.route`` and ``moe.experts``
are opened once, at the capture in the first step, and never again.

**Counters.**  :data:`COUNTERS` keeps process-wide counts that outlive
the engines, as ``Kernel.launches`` does: the host adds to a name
(:meth:`Counters.add`) where a count is known on the host, and the device
to a vector of names (:meth:`Counters.add_device`) where it arises in the
decode step, so that a CUDA graph replay, which runs no Python, still
counts it; :meth:`Counters.read` copies the device's vectors to the host
once.  A replay adds to the host counts what its capture counted
(:mod:`repro_torch.serve.decode_graph`).  Always on; the ``meta`` device
counts nothing.  The names: ``moe.rows_routed`` and ``moe.rows_computed``
(token-expert rows the routers assigned to real tokens -- a decode
step's active lanes, a prefill's prompt tokens, on the device there
(:func:`repro_torch.models.moe.real_rows`) -- and every row the expert
products computed, at every MoE layer call), and, on a split cache
alone, summed over decode steps,
``kv.held_tokens`` (tokens the active lanes hold) and for each KV tenant
``<tenant>.held_pages`` and ``<tenant>.held_bytes`` (pages the active
lanes' block tables map, and their K/V bytes), ``kv_window_pages.recycled``
(pages a split cache's window tenant recycled) and, at admission,
``<tenant>.admitted_pages`` (pages the admitted lanes' tables map).
"""
from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import torch

#: the recorder's clock (integer nanoseconds of ``time.perf_counter``)
now_ns = time.perf_counter_ns


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int          # index of the enclosing span in the drained list
    attrs: dict


class Recorder:
    """The in-memory span list: a span's record ``[name, start_ns,
    end_ns, parent, attrs]`` is appended as it opens (so a parent's index
    is known to its children) and its end filled in as it closes;
    ``stack`` holds the indices of the open ones."""

    def __init__(self):
        self.on = False
        self.records: list[list] = []
        self.stack: list[int] = []


RECORDER = Recorder()


class _NoSpan:
    """What ``span`` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


class Span:
    """A span that reads the clock; it records itself when the recorder
    was on as it opened."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "_record")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.start_ns = self.end_ns = 0
        self._record = None

    def __enter__(self):
        self.start_ns = t = now_ns()
        rec = RECORDER
        if rec.on:
            stack = rec.stack
            self._record = [self.name, t, t, stack[-1] if stack else -1,
                            self.attrs]
            stack.append(len(rec.records))
            rec.records.append(self._record)
        return self

    def __exit__(self, *exc):
        self.end_ns = t = now_ns()
        if self._record is not None:
            self._record[2] = t
            RECORDER.stack.pop()
        return False

    def note(self, **attrs) -> None:
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)

    @property
    def duration_us(self) -> float:
        return (self.end_ns - self.start_ns) / 1e3


def span(name: str, **attrs):
    """A span of ``name``: recorded while the recorder is on, else the
    shared no-op object."""
    if not RECORDER.on:
        return NO_SPAN
    return Span(name, attrs)


def timed(name: str, **attrs) -> Span:
    """A span that reads the clock whether or not the recorder is on."""
    return Span(name, attrs)


def enable() -> None:
    RECORDER.on = True


def disable() -> None:
    RECORDER.on = False


def drain() -> list[SpanRecord]:
    """The recorded spans, in the order they opened, and an empty
    recorder.  Raises while a recorded span is still open (its children's
    parent indices would point into the next drain)."""
    if RECORDER.stack:
        raise RuntimeError(
            f"drain() inside {len(RECORDER.stack)} open span(s): "
            f"{[RECORDER.records[i][0] for i in RECORDER.stack]}")
    out, RECORDER.records = RECORDER.records, []
    return [SpanRecord(*r) for r in out]


def _row_name(s: SpanRecord) -> str:
    """A span's row in :func:`summary`: its name, and its ``kind`` where
    it has one (``alloc.commit[decode]``)."""
    kind = s.attrs.get("kind")
    return s.name if kind is None else f"{s.name}[{kind}]"


def summary(spans: list[SpanRecord]) -> list[tuple[str, int, float, float]]:
    """``(row, count, total ms, self ms)`` per span name (per name and
    ``kind`` for a span with one), by total time; a span's self time is
    its duration less its children's."""
    child_ns = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            child_ns[s.parent] += s.end_ns - s.start_ns
    rows: dict[str, list] = {}
    for s, c in zip(spans, child_ns):
        r = rows.setdefault(_row_name(s), [0, 0, 0])
        r[0] += 1
        r[1] += s.end_ns - s.start_ns
        r[2] += s.end_ns - s.start_ns - c
    out = [(n, c, t / 1e6, x / 1e6) for n, (c, t, x) in rows.items()]
    return sorted(out, key=lambda row: -row[2])        # total ms


def format_summary(spans: list[SpanRecord]) -> str:
    """:func:`summary` as a table."""
    lines = [f"{'span':<24} {'count':>7} {'total ms':>11} {'self ms':>11}"]
    lines += [f"{n:<24} {c:>7} {t:>11.3f} {x:>11.3f}"
              for n, c, t, x in summary(spans)]
    return "\n".join(lines)


class Counters:
    """Process-wide counts by name: host integers and int64 vectors on a
    device, one per (names, device), which the decode step adds to in
    place (a graph replay adds to the same vector)."""

    def __init__(self):
        self.host: dict[str, int] = {}
        self.device: dict[tuple, torch.Tensor] = {}

    def add(self, name: str, n: int) -> None:
        self.host[name] = self.host.get(name, 0) + int(n)

    def add_device(self, names: Sequence[str], values: torch.Tensor
                   ) -> None:
        """Add ``values [len(names)]`` (any integer or bool dtype) to the
        device's vector of ``names``.  Nothing on ``meta``."""
        if values.device.type == "meta":
            return
        key = (tuple(names), str(values.device))
        acc = self.device.get(key)
        if acc is None:
            acc = self.device[key] = torch.zeros(
                (len(names),), dtype=torch.int64, device=values.device)
        acc.add_(values.to(torch.int64))

    def read(self) -> dict[str, int]:
        """Every count by name: the host's and the devices' summed."""
        out = dict(self.host)
        for (names, _), acc in self.device.items():
            for name, v in zip(names, acc.cpu().tolist()):
                out[name] = out.get(name, 0) + int(v)
        return out


COUNTERS = Counters()
