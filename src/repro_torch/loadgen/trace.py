"""Allocator-op trace record and replay (port of
:mod:`repro.loadgen.trace`; same tracefile format and version, so a trace
written by either package loads and replays in the other).

A :class:`TraceRecorder` hangs off ``AllocService.recorder`` and keeps every
state mutation in mutation order:

* ``burst``  -- one committed HMQ burst: the request queue's four int32
  planes (op, lane, size_class, arg) and its ``max_blocks_per_req``;
* ``window`` -- a burst-window boundary (``MultiEngine.step_window``);
* ``retag`` / ``bump`` -- the prefix cache's owner demotions and alias
  refcount bumps, which change what a later FREE_ALL matches and when a
  refcounted free reaches zero.

Every commit of the port is eager (the JAX package's in-jit decode bursts
are ordinary calls here), so the recorder sees all of them, the decode
steps' gated bursts included, and ``traced_commits`` stays 0.  Recording
copies each committed queue to the host once, and only while a recorder
is attached.

:func:`replay_trace` rebuilds the tenant table from the header and drives
the recorded bursts through a fresh ``AllocService`` with no model, on the
card unless asked for the CPU; under the free list each burst is one launch
of the support-core CUDA kernel.  The header's ``backend`` is written as
``"jnp"`` (the semantics the port's plain path reproduces) and ignored on
load: the port has no backend knob.

:func:`to_sim_trace` lowers a recorded op stream into the allocator
simulator's logical trace, and :func:`replay_sim_policies` runs it through
named sim policies (one ``sim_trace`` kernel launch per policy on the
card): one tracefile, many simulators, one report.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..alloc.policies import get_policy
from ..alloc.service import AllocService
from ..core.packets import (FREE_ALL, OP_FREE, OP_MALLOC, OP_REFILL,
                            RequestQueue)
from ..device import DeviceLike, resolve_device
from ..sim.costmodel import replay_cycles
from ..sim.engine import host_counts, run_trace_counts
from ..sim.policies import ALL_POLICIES
from ..sim.workloads import NUM_CLASSES

TRACE_MAGIC = b"REPROALLOCTRACE"
TRACE_VERSION = 1

# Event kind tags in the serialized stream.
K_BURST = 1
K_WINDOW = 2
K_RETAG = 3
K_BUMP = 4

#: the ``backend`` the port writes into a trace header
TRACE_BACKEND = "jnp"


@dataclasses.dataclass
class AllocTrace:
    """An in-memory allocator-op trace: versioned header + event stream.

    ``header`` keys: ``version``, ``policy``, ``backend``, ``tenants``
    (``[[name, capacity], ...]`` in size-class order), ``traced_commits``,
    ``complete``.  ``events`` entries:

    * ``("burst", R, op, lane, size_class, arg)`` -- four ``[Q]`` int32
      numpy arrays, ``R`` = max_blocks_per_req
    * ``("window",)``
    * ``("retag", size_class, blocks, new_owner)``
    * ``("bump", size_class, blocks, delta)``
    """

    header: dict
    events: list

    @property
    def bursts(self) -> int:
        return sum(1 for ev in self.events if ev[0] == "burst")

    @property
    def live_bursts(self) -> int:
        """Bursts carrying at least one non-NOP packet."""
        return sum(1 for ev in self.events
                   if ev[0] == "burst" and bool(np.any(ev[2] != 0)))

    @property
    def windows(self) -> int:
        return sum(1 for ev in self.events if ev[0] == "window")

    @property
    def ops(self) -> int:
        """Live (non-NOP) packets across every recorded burst."""
        return sum(int(np.sum(ev[2] != 0)) for ev in self.events
                   if ev[0] == "burst")

    @property
    def names_block_ids(self) -> bool:
        """Whether any event names a block id: a single free
        (``OP_FREE`` with ``arg >= 0``), a retag or a bump.  Such ids are
        the recorded policy's, so they name other pages under another."""
        return any(ev[0] in ("retag", "bump") or (
            ev[0] == "burst" and bool(np.any((ev[2] == OP_FREE)
                                             & (ev[5] >= 0))))
            for ev in self.events)

    def drop_block_ids(self) -> "AllocTrace":
        """The trace without its block-naming ops: single frees become
        NOPs (all four planes 0, as the replay's padding) and retags and
        bumps go.  What stays -- mallocs, refills, runs, FREE_ALLs and the
        window marks -- means the same pages under every policy, so the
        result replays under any of them (a what-if of the run's
        admission and release traffic).  The header is copied with
        ``complete`` reset to ``None``: the result is not the run's
        record."""
        events = []
        for ev in self.events:
            if ev[0] in ("retag", "bump"):
                continue
            if ev[0] == "burst":
                _, r, *planes = ev
                single = (planes[0] == OP_FREE) & (planes[3] >= 0)
                ev = ("burst", r, *(np.where(single, 0, p).astype(np.int32)
                                    for p in planes))
            events.append(ev)
        return AllocTrace(header=dict(self.header, complete=None),
                          events=events)


def _host_i32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, np.int32).reshape(-1).copy()


class TraceRecorder:
    """Appends every allocator op of one ``AllocService`` to an event list,
    in state-mutation order.  Attach with :func:`record_service`; detach by
    resetting ``service.recorder`` to ``None``."""

    def __init__(self, service: AllocService):
        self.service = service
        self.events: list = []
        self.traced_commits = 0     # always 0: no commit of the port is traced

    # -- AllocService hooks --

    def on_commit(self, queue: RequestQueue, max_blocks_per_req: int) -> None:
        planes = torch.stack([queue.op, queue.lane, queue.size_class,
                              queue.arg]).to(torch.int32).cpu().numpy()
        self.events.append(("burst", int(max_blocks_per_req),
                            *(p.copy() for p in planes)))

    def on_retag(self, size_class, blocks, new_owner) -> None:
        self.events.append(("retag", int(size_class), _host_i32(blocks),
                            int(new_owner)))

    def on_bump(self, size_class, blocks, delta) -> None:
        self.events.append(("bump", int(size_class), _host_i32(blocks),
                            int(delta)))

    def mark_window(self) -> None:
        """Burst-window boundary (called by ``MultiEngine.step_window``)."""
        self.events.append(("window",))

    # -- finishing --

    def finish(self, complete: Optional[bool] = None) -> AllocTrace:
        """Snapshot the stream into an :class:`AllocTrace`; ``complete``
        says whether it provably holds every state change
        (:func:`certify_complete`), ``None`` "not certified"."""
        svc = self.service
        header = {
            "version": TRACE_VERSION,
            "policy": svc.policy.name,
            "backend": TRACE_BACKEND,
            "tenants": [[t.name, int(t.capacity)] for t in svc.tenants],
            "traced_commits": self.traced_commits,
            "complete": complete,
        }
        return AllocTrace(header=header, events=list(self.events))


def record_service(service: AllocService) -> TraceRecorder:
    """Attach a fresh recorder to ``service`` and return it."""
    rec = TraceRecorder(service)
    service.recorder = rec
    return rec


def certify_complete(trace: AllocTrace, engines: Sequence,
                     window_bursts: int = 0) -> AllocTrace:
    """Mark ``trace`` complete iff it holds every state change the run
    made.

    Every commit of the port is recorded, so the first check is a count:
    the trace's bursts must equal the engines' commits
    (``EngineStats.commits``: admissions, decode steps, releases) plus the
    deployment's ``window_bursts`` (``MultiEngineStats.window_bursts``).
    The second is compaction: a pass rebuilds the free stack ascending,
    and no event carries that, so a pass that moved pages under a policy
    whose bursts keep the stack as they find it (the free list; see the
    policy's ``rebuilds_stack``) leaves a trace that replays to another
    stack.  Raises in either case.
    """
    made = sum(e.stats.commits for e in engines) + int(window_bursts)
    if trace.header.get("traced_commits", 0) or trace.bursts != made:
        raise ValueError(
            f"trace incomplete: {trace.bursts} recorded bursts "
            f"({trace.header.get('traced_commits', 0)} unserialized) but "
            f"the run made {made} commits; attach the recorder before the "
            f"first commit and detach it after the last")
    moved = sum(e.stats.compaction_moves for e in engines)
    policy = get_policy(trace.header["policy"])
    if moved and not getattr(policy, "rebuilds_stack", False):
        raise ValueError(
            f"trace incomplete: compaction moved {moved} pages under the "
            f"{policy.name} policy, whose free stack the pass rebuilt "
            f"outside the trace; record compacting runs under a policy "
            f"that rebuilds its stack every burst (bitmap, buddy)")
    trace.header["complete"] = True
    return trace


# ---------------- tracefile serialization ----------------

def save_trace(trace: AllocTrace, path) -> None:
    """Write the versioned binary tracefile (the JAX package's format)."""
    header = json.dumps(trace.header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(TRACE_MAGIC)
        f.write(struct.pack("<BI", TRACE_VERSION, len(header)))
        f.write(header)
        for ev in trace.events:
            kind = ev[0]
            if kind == "burst":
                _, r, op, lane, cls, arg = ev
                f.write(struct.pack("<BII", K_BURST, op.shape[0], r))
                for plane in (op, lane, cls, arg):
                    f.write(np.asarray(plane, "<i4").tobytes())
            elif kind == "window":
                f.write(struct.pack("<B", K_WINDOW))
            elif kind in ("retag", "bump"):
                _, cls, blocks, x = ev
                f.write(struct.pack("<BiIi", K_RETAG if kind == "retag"
                                    else K_BUMP, cls, blocks.shape[0], x))
                f.write(np.asarray(blocks, "<i4").tobytes())
            else:
                raise ValueError(f"unknown event kind {kind!r}")


def load_trace(path) -> AllocTrace:
    """Read a tracefile written by :func:`save_trace` or by the JAX
    package (version-checked)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(TRACE_MAGIC)] != TRACE_MAGIC:
        raise ValueError(f"{path}: not a repro allocator tracefile")
    off = len(TRACE_MAGIC)
    version, hlen = struct.unpack_from("<BI", data, off)
    off += struct.calcsize("<BI")
    if version != TRACE_VERSION:
        raise ValueError(f"{path}: tracefile version {version} "
                         f"unsupported (expected {TRACE_VERSION})")
    header = json.loads(data[off:off + hlen].decode("utf-8"))
    off += hlen
    events: list = []
    while off < len(data):
        kind = data[off]
        off += 1
        if kind == K_BURST:
            q, r = struct.unpack_from("<II", data, off)
            off += struct.calcsize("<II")
            planes = []
            for _ in range(4):
                planes.append(np.frombuffer(data, "<i4", q, off)
                              .astype(np.int32))
                off += 4 * q
            events.append(("burst", r, *planes))
        elif kind == K_WINDOW:
            events.append(("window",))
        elif kind in (K_RETAG, K_BUMP):
            cls, nb, x = struct.unpack_from("<iIi", data, off)
            off += struct.calcsize("<iIi")
            blocks = np.frombuffer(data, "<i4", nb, off).astype(np.int32)
            off += 4 * nb
            events.append(("retag" if kind == K_RETAG else "bump",
                           cls, blocks, x))
        else:
            raise ValueError(f"{path}: corrupt event kind {kind} at "
                             f"byte {off - 1}")
    return AllocTrace(header=header, events=events)


# ---------------- model-free AllocService replay ----------------

@dataclasses.dataclass
class ReplayResult:
    """Outcome of one model-free replay: final state and counters."""

    state: object                 # final FreeListState, on the replay device
    report: dict                  # svc.tenant_report(state)
    bursts: int                   # bursts committed
    live_bursts: int              # of those, carrying >= 1 non-NOP packet
    windows: int
    ops: int                      # live packets replayed
    wall_s: float                 # the replay loop, ending in a device sync
    signatures: int               # distinct burst shapes (Q is unified)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _service(trace: AllocTrace, policy: str,
             dev: torch.device) -> AllocService:
    svc = AllocService(policy=policy, device=dev)
    for name, capacity in trace.header["tenants"]:
        svc.register_tenant(name, capacity)
    return svc


def replay_trace(trace: AllocTrace, policy: Optional[str] = None,
                 device: DeviceLike = None) -> ReplayResult:
    """Drive a recorded trace through a fresh model-free ``AllocService``.

    With the recorded policy (``policy=None``), the packets replay as
    recorded and the final per-tenant counters are the live run's exactly.
    ``policy`` replays the same packets under another design (a what-if),
    as the JAX package's replay does, and raises ``ValueError`` on a trace
    that :attr:`~AllocTrace.names_block_ids`: its single frees, retags
    and bumps name the recorded policy's pages, which another policy
    grants elsewhere (the JAX package applies them as they are and can
    leave duplicate or out-of-range ids on the free stack; ROADMAP.md,
    Queue 3).  :meth:`AllocTrace.drop_block_ids` gives the part of such a
    trace that every policy reads alike.  A buddy trace's
    ``OP_MALLOC_RUN`` packets grant as plain mallocs under the other
    policies.

    ``device`` defaults to ``cuda`` (raising without a card).  Queues are
    padded with NOPs -- behaviour-neutral: scheduling sorts NOPs last -- to
    one power-of-two capacity across the trace, as the JAX replay pads
    them by default; every burst commits gated, with one host-to-device
    copy of its queue.
    """
    recorded = trace.header["policy"]
    if policy not in (None, recorded) and trace.names_block_ids:
        raise ValueError(
            f"a {recorded} trace that names block ids (single frees, "
            f"retags, bumps) replays only under {recorded}; replay "
            f"trace.drop_block_ids() under {policy}")
    dev = resolve_device(device)
    svc = _service(trace, policy or recorded, dev)
    state = svc.init_state()
    q_unified = _next_pow2(max(
        [ev[2].shape[0] for ev in trace.events if ev[0] == "burst"] or [1]))

    t0 = time.perf_counter()
    shapes: set = set()
    bursts = live_bursts = windows = ops = 0
    for ev in trace.events:
        kind = ev[0]
        if kind == "burst":
            _, r, *planes = ev
            buf = np.zeros((4, q_unified), np.int32)
            buf[:, :planes[0].shape[0]] = np.stack(planes)
            queue = RequestQueue(*torch.as_tensor(buf).to(dev).unbind(0))
            state, _ = svc.commit(state, queue, max_blocks_per_req=r,
                                  gated=True)
            shapes.add(r)
            bursts += 1
            live = int(np.sum(planes[0] != 0))
            live_bursts += live > 0
            ops += live
        elif kind == "window":
            windows += 1
        elif kind in ("retag", "bump"):
            _, cls, blocks, x = ev
            op = svc.retag_blocks if kind == "retag" else svc.bump_refcounts
            state = op(state, svc.tenants[cls], blocks, x)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return ReplayResult(state=state, report=svc.tenant_report(state),
                        bursts=bursts, live_bursts=live_bursts,
                        windows=windows, ops=ops, wall_s=wall,
                        signatures=len(shapes))


# ---------------- sim-policy replay ----------------

def to_sim_trace(trace: AllocTrace, threads: int = 8) -> dict:
    """Lower a recorded op stream into the sim's logical-trace format.

    A modeling bridge, not a bit-level one: the sim replays single-sized
    malloc/free events per thread, so a malloc/refill granting ``n``
    blocks becomes ``n`` op-1 events, a single free one op-2 event, and a
    FREE_ALL expands to the lane's tracked holdings at that point.  Lanes
    map onto ``threads`` sim threads round-robin; size classes fold mod
    the sim's ``NUM_CLASSES``.  The arrays equal the JAX package's
    ``to_sim_trace`` of the same trace.
    """
    thread_l: list = []
    op_l: list = []
    cls_l: list = []
    holdings: dict = {}
    for ev in trace.events:
        if ev[0] != "burst":
            continue
        _, _r, op, lane, cls, arg = ev
        for o, ln, c, a in zip(op.tolist(), lane.tolist(), cls.tolist(),
                               arg.tolist()):
            if o not in (OP_MALLOC, OP_REFILL, OP_FREE):
                continue
            th = ln % threads if ln >= 0 else 0
            sc = c % NUM_CLASSES
            key = (c, ln)
            if o in (OP_MALLOC, OP_REFILL):
                n = max(int(a), 1)
                holdings[key] = holdings.get(key, 0) + n
                o_sim = 1
            else:
                n = holdings.pop(key, 0) if a == FREE_ALL else 1
                if a != FREE_ALL:
                    holdings[key] = max(holdings.get(key, 0) - 1, 0)
                o_sim = 2
            thread_l.extend([th] * n)
            op_l.extend([o_sim] * n)
            cls_l.extend([sc] * n)
    n = len(op_l)
    return {
        "thread": np.asarray(thread_l, np.int32),
        "op": np.asarray(op_l, np.int32),
        "size_class": np.asarray(cls_l, np.int32),
        "foreign": np.zeros(n, np.int32),
    }


def replay_sim_policies(trace: AllocTrace,
                        policies: Sequence[str] = ("speedmalloc",
                                                   "speedmalloc-stash"),
                        threads: int = 8,
                        device: DeviceLike = None) -> dict[str, dict]:
    """Replay one trace through named sim policies (``ALL_POLICIES``) on
    ``device`` (the card unless ``"cpu"``).

    Returns per-policy counter dicts plus an estimated cycle cost from the
    calibrated cost model (``sim.costmodel.replay_cycles``).
    """
    dev = resolve_device(device)
    sim_trace = to_sim_trace(trace, threads=threads)
    out: dict[str, dict] = {}
    for name in policies:
        cnt = host_counts(run_trace_counts(ALL_POLICIES[name], sim_trace,
                                           threads, dev))
        out[name] = {
            "mallocs": int(cnt.mallocs),
            "frees": int(cnt.frees),
            "fast_hits": int(cnt.fast_hits),
            "accel_hits": int(cnt.accel_hits),
            "shared_trips": int(cnt.shared_trips),
            "mmaps": int(cnt.mmaps),
            "peak_bytes": int(cnt.peak_bytes),
            "est_cycles": float(replay_cycles(cnt, threads)),
        }
    return out
