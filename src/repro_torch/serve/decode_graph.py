"""The decode step captured once as a CUDA graph and replayed.

An engine's decode step (:func:`~repro_torch.serve.serve_step
.make_decode_step`) keeps every shape fixed and asks the host nothing
about data: every lane runs at ``max_lanes`` with the inactive ones
masked, the paged kernel's split comes from shapes alone, the gated
burst decides its skip on the device, MoE routing has a static capacity
and the three hand-written kernels launch on the current stream.  Run
eagerly it is ~2,400 host launches a step; on the card the engine
captures it once (:class:`DecodeGraph`) and replays it every later step,
one launch, with the same kernels in the same order.

**Static buffers.**  The graph reads and writes one fixed copy of the
engine's :class:`~repro_torch.serve.serve_step.ServeState`: the captured
step ends by copying its new state into the buffers it read, so after a
replay the engine's state *is* those buffers.  Admission, release, the
burst window's commit and compaction replace state leaves with new
tensors between steps; before a replay :meth:`DecodeGraph.__call__`
copies in only the leaves that are not the buffers themselves.  The K/V
pools are never copied: they are written in place (``pool_write``, the
admission burst, compaction) and are the graph's own; a replaced pool
raises.  Whisper's encoder outputs are written in place at admission and
only read by the step, so they are shared too.

**Capture.**  The step is warmed up and captured on buffers that copy the
state with every lane inactive: pool writes go to the sink page and no
packet is live, so the served state is never touched.  The real state is
copied in before the first replay.

**Launch counters.**  ``Kernel.launches`` counts in Python, which a
replay does not run: the capture records each kernel's launches inside
the graph and undoes the warm-up's and the capture's own increments (they
serve no lane), and each replay adds the recorded counts.  The host
counts of :data:`~repro_torch.tracing.COUNTERS` (the MoE rows) are
replayed the same way; its device counts are additions the graph itself
replays.

Outputs other than the state (logits, ``DecodeStats``, the deferred
refills) live in the graph's memory and are overwritten by the next
replay: a caller that keeps one past the step clones it.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.flash_attention.ops import FLASH_KERNEL
from ..kernels.paged_attention.ops import PAGED_KERNEL
from ..kernels.support_core.ops import KERNEL
from ..tracing import COUNTERS
from .serve_step import ServeState

#: the kernels a decode step can launch (whisper's cross-attention is the
#: flash kernel), whose counters a replay advances
STEP_KERNELS = (KERNEL, PAGED_KERNEL, FLASH_KERNEL)


def graph_engages(device: torch.device, mesh, recorder) -> bool:
    """Whether an engine replays its decode step as a graph: its state
    lives on a CUDA card, it has no mesh (a ``DTensor`` step stays eager)
    and no allocator-op recorder is set (its bookkeeping is host work a
    replay would skip).  Every family's step captures."""
    return device.type == "cuda" and mesh is None and recorder is None


def _leaves(tree) -> list:
    """The tensors (and ``None`` parts) of a nest of NamedTuples, in
    order."""
    if tree is None or isinstance(tree, torch.Tensor):
        return [tree]
    return [x for part in tree for x in _leaves(part)]


def _map(fn, tree):
    if tree is None or isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(_map(fn, part) for part in tree))


def _pools(state: ServeState) -> tuple:
    """The K/V pools of ``state``, a split cache's window tenant's too."""
    paged = state.paged
    win = () if paged.win is None else (paged.win.k_pages, paged.win.v_pages)
    return (paged.k_pages, paged.v_pages, *win)


def static_state(state: ServeState) -> ServeState:
    """The graph's buffers: a copy of ``state`` with every lane inactive,
    sharing its K/V pools (a split cache's window pools too) and encoder
    outputs."""
    paged, win = state.paged, state.paged.win
    own = state._replace(paged=paged._replace(
        k_pages=None, v_pages=None, win=None if win is None
        else win._replace(k_pages=None, v_pages=None)), enc_out=None)
    static = _map(lambda t: None if t is None else t.clone(), own)
    static.paged.active.zero_()
    swin = static.paged.win
    if win is not None:
        swin = swin._replace(k_pages=win.k_pages, v_pages=win.v_pages)
    return static._replace(
        paged=static.paged._replace(k_pages=paged.k_pages,
                                    v_pages=paged.v_pages, win=swin),
        enc_out=state.enc_out)


def _counts() -> list[int]:
    return [k.launches for k in STEP_KERNELS]


def _set_counts(counts: list[int]) -> None:
    for k, n in zip(STEP_KERNELS, counts):
        k.launches = n


class CudaGraph:
    """A ``torch.cuda.CUDAGraph`` behind the three calls
    :class:`DecodeGraph` makes."""

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def warm(self, fn) -> None:
        """Run ``fn`` once on a side stream: libraries and kernels load,
        the caching allocator hands out its first blocks."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)

    def capture(self, fn):
        """Record ``fn``'s launches; returns its outputs, which every
        replay rewrites in place."""
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            return fn()

    def replay(self) -> None:
        self.graph.replay()


class DecodeGraph:
    """An engine's decode step ``step(params, state) -> (state, logits,
    stats[, pending])``, captured on its own buffers at construction and
    replayed by each call (through a :class:`CudaGraph`, for which the CPU
    tests stand in a class with the same three calls)."""

    def __init__(self, step, params, state: ServeState):
        self.static = static_state(state)
        self._pools = _pools(self.static)
        self._graph = CudaGraph()
        bufs = _leaves(self.static)

        def run():
            new, *out = step(params, self.static)
            for dst, src in zip(bufs, _leaves(new)):
                if src is not dst:
                    dst.copy_(src)
            return out

        c0, h0 = _counts(), dict(COUNTERS.host)
        self._graph.warm(run)
        c1, h1 = _counts(), dict(COUNTERS.host)
        self.outputs = self._graph.capture(run)
        #: each step kernel's launches inside the graph
        self.launches = [b - a for a, b in zip(c1, _counts())]
        #: the host counts one step adds
        self.host_counts = {k: v - h1.get(k, 0)
                            for k, v in COUNTERS.host.items()
                            if v != h1.get(k, 0)}
        _set_counts(c0)
        COUNTERS.host.clear()
        COUNTERS.host.update(h0)

    def copy_in(self, state: ServeState) -> int:
        """Copy into the buffers the leaves of ``state`` that are not
        theirs; returns how many.  Raises where a K/V pool is not the
        graph's own."""
        copied = 0
        for dst, src in zip(_leaves(self.static), _leaves(state)):
            if src is dst:
                continue
            if any(dst is p for p in self._pools):
                raise RuntimeError(
                    "a K/V pool was replaced: the pools are written in "
                    "place and never copied into the decode graph")
            dst.copy_(src)
            copied += 1
        return copied

    def __call__(self, state: ServeState) -> tuple[tuple, int]:
        """One replay on ``state`` (the captured step's parameters):
        ``((static state, logits, stats[, pending]), leaves copied in)``."""
        copied = self.copy_in(state)
        self._graph.replay()
        for k, n in zip(STEP_KERNELS, self.launches):
            k.launches += n
        for name, n in self.host_counts.items():
            COUNTERS.add(name, n)
        return (self.static, *self.outputs), copied
