"""Request-lifecycle scheduler for continuous batching (a copy of
:mod:`repro.serve.scheduler`, DESIGN.md §3, on the port's own configs).

The serving stack's control plane: requests flow

    waiting queue  ->  prefill buckets  ->  running lanes  ->  completion

and every allocation-lifecycle transition speaks the support-core's packet
protocol (DESIGN.md §2):

* **Admission** — the scheduler selects a batch of waiting requests under a
  page-budget policy, groups them into a small set of padded prefill
  *buckets* (so the jitted prefill compiles once per bucket, not once per
  prompt length), and the engine admits the whole batch with ONE
  ``admit_prefill_many`` HMQ burst — the paper's batched "server-client"
  (Larson) admission instead of one synchronized burst per sequence.
* **Decode** — ``decode_append``'s two-tier fast path: page boundaries pop
  the per-lane stash, and at most ONE bulk HMQ burst per step carries
  refills/flushes (skipped entirely when no packet is live — DESIGN.md §7).
  The page budget charges each admission's stash pre-charge
  (``stash_precharge``) so admission never overcommits against the stash.
* **Completion** — finished lanes are released through compact
  ``OP_FREE``/``FREE_ALL`` lane packets (``paged_kv.release_packets``), not a
  host-built dense mask.

Bucketing policy
----------------
Attention families (dense / moe / vlm / audio) use *padded* buckets: causal
masking makes right-padding invisible to the real positions, so any prompt
length maps to the smallest configured bucket that holds it.  Recurrent
families (ssm, hybrid) fold every processed token into their state, so their
buckets are *exact-length*: same-length prompts still batch (and still share
the single admission burst), but distinct lengths compile separately.

The scheduler is deliberately host-side and pure-Python: it owns no arrays,
only request bookkeeping; all device work stays in the engine's jitted steps.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Optional

import numpy as np

from ..configs.base import ArchConfig
from ..core.packets import NO_LANE
from ..core.paged_kv import PagedKVConfig
from ..tracing import now_ns

WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"
FAILED = "failed"        # admission malloc failed; request was not served


def _stamp():
    """A clock stamp field: no part of a request's identity."""
    return dataclasses.field(default=None, compare=False, repr=False)


@dataclasses.dataclass
class Request:
    """One serving request and its lifecycle bookkeeping.

    ``tokens`` is the CURRENT prefill prefix: the original prompt, extended
    with the already-generated tokens when the request is preempted and
    re-queued (so a resumed request prefills its full context and continues
    exactly where it stopped).  ``output`` accumulates every generated
    token across preemptions; ``priority`` orders admission (higher first)
    and selects preemption victims (lowest running priority evicted).

    Four stamps on the span clock (:func:`repro_torch.tracing.now_ns`,
    integer ns of ``time.perf_counter``) follow the request: ``t_submit``
    (:meth:`Scheduler.submit`), ``t_admit`` (its first admission),
    ``t_first`` (its first output token on the host) and ``t_done``
    (FINISHED).  A preempted request keeps its first ``t_admit`` and
    ``t_first``.
    """

    rid: int
    tokens: np.ndarray                       # [T] int32 current prefix
    max_new_tokens: int = 16
    frames: Optional[np.ndarray] = None      # [F, d] (audio)
    patches: Optional[np.ndarray] = None     # [P, d] (vlm)
    priority: int = 0                        # higher admitted/retained first
    # --- runtime state (scheduler-owned) ---
    state: str = WAITING
    lane: int = -1
    generated: int = 0                       # == len(output); survives preemption
    output: list = dataclasses.field(default_factory=list)  # generated ids
    preemptions: int = 0                     # times this request was evicted
    _admit_mark: int = 0                     # len(output) at last admission
    # Tokens covered by a prefix-cache hit at the LAST admission plan
    # (multiple of page_size, < prompt_len; 0 = no hit / cache off).  Set by
    # plan_admission's probe; prefill starts at the first uncached token.
    cached_len: int = 0
    t_submit: Optional[int] = _stamp()
    t_admit: Optional[int] = _stamp()
    t_first: Optional[int] = _stamp()
    t_done: Optional[int] = _stamp()

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Static policy knobs for the request scheduler."""

    page_size: int
    num_pages: int
    max_lanes: int
    buckets: tuple[int, ...]        # padded prefill lengths, ascending
    admit_width: int = 4            # static prefill batch width per bucket
    page_reserve: int = 0           # pages withheld from admission for decode growth
    exact_buckets: bool = False     # recurrent families: bucket == exact length
    max_kv_len: int = 0             # per-lane KV capacity in tokens (0 = unchecked)
    # Pages the engine's admission burst pre-charges into the lane's page
    # stash (kvcfg.stash_refill when the stash front-end is enabled).  The
    # page budget must account for them or admission would overcommit the
    # pool against its own stash grants.
    stash_precharge: int = 0


def default_buckets(max_len: int, start: int = 16) -> tuple[int, ...]:
    """Power-of-two padded lengths from ``start`` up to ``max_len``."""
    b = [start]
    while b[-1] < max_len:
        b.append(b[-1] * 2)
    return tuple(b)


def make_scheduler_config(
    cfg: ArchConfig,
    kvcfg: PagedKVConfig,
    max_prompt_len: Optional[int] = None,
    admit_width: Optional[int] = None,
    page_reserve: Optional[int] = None,
) -> SchedulerConfig:
    """Derive scheduler policy from the arch + paged-KV configs.

    The default page reserve holds back one page per lane so that running
    sequences can cross at least their next page boundary even when
    admission is saturating the pool.
    """
    capacity = kvcfg.max_pages_per_lane * kvcfg.page_size
    max_len = min(max_prompt_len or capacity, capacity)
    # Exact-length buckets where padding changes semantics: recurrent
    # families fold pad tokens into their state, and capacity-routed MoE
    # couples every token's keep/drop to the total token count (so even
    # exact buckets leave MoE with the usual batched-capacity drift — see
    # DESIGN.md §3; exact lengths just remove the pad-token component).
    # Same-length prompts still batch and still share the admission burst.
    exact = cfg.family in ("ssm", "hybrid") or cfg.num_experts > 1
    # Clamp buckets to the per-lane KV capacity: a bucket beyond what the
    # block table can address would make prefill emit unadmittable KV.
    buckets = tuple(sorted({min(b, max_len) for b in default_buckets(max_len)}))
    return SchedulerConfig(
        page_size=kvcfg.page_size,
        num_pages=kvcfg.num_pages,
        max_lanes=kvcfg.max_lanes,
        buckets=buckets,
        max_kv_len=capacity,
        admit_width=admit_width if admit_width is not None
        else min(kvcfg.max_lanes, 4),
        page_reserve=page_reserve if page_reserve is not None
        else kvcfg.max_lanes,
        exact_buckets=exact,
        stash_precharge=kvcfg.stash_refill if kvcfg.stash_size else 0,
    )


def pick_bucket(length: int, scfg: SchedulerConfig) -> int:
    """Padded prefill length for a prompt of ``length`` tokens."""
    if scfg.exact_buckets:
        return length
    for b in scfg.buckets:
        if b >= length:
            return b
    return length                       # beyond the largest bucket: own compile


def pages_needed(kv_len: int, scfg: SchedulerConfig) -> int:
    """KV pages one admitted sequence of ``kv_len`` cached tokens consumes."""
    return math.ceil(kv_len / scfg.page_size)


def release_packet_array(lanes: list[int], max_lanes: int) -> np.ndarray:
    """Compact lane-packet array for ``paged_kv.release_packets``.

    Fixed capacity ``max_lanes`` (one slot per possible completion) so the
    packet shape is static; unused slots carry ``NO_LANE``.
    """
    pkts = np.full((max_lanes,), NO_LANE, np.int32)
    pkts[: len(lanes)] = np.asarray(sorted(lanes), np.int32)
    return pkts


@dataclasses.dataclass
class AdmissionBatch:
    """One prefill bucket's worth of an admission plan."""

    bucket: int                      # padded prompt length
    items: list[tuple[int, Request]]  # (lane, request), lanes ascending


@dataclasses.dataclass
class AdmissionPlan:
    """A scheduler-selected admission batch: k sequences, one HMQ burst."""

    batches: list[AdmissionBatch]
    pages_charged: int

    @property
    def size(self) -> int:
        return sum(len(b.items) for b in self.batches)


class Scheduler:
    """Continuous-batching request scheduler.

    Host-side control plane over the engine: tracks the waiting queue and
    the running-lane table, plans page-budget-bounded admission batches, and
    emits the completion packets that drive the packet-routed lane release.
    """

    def __init__(self, scfg: SchedulerConfig):
        self.scfg = scfg
        self.waiting: deque[Request] = deque()
        self.running: dict[int, Request] = {}       # lane -> request
        self.finished: list[Request] = []
        self.failed: list[Request] = []

    # ---------------- intake ----------------

    def submit(self, req: Request) -> None:
        kv_len = self._kv_len(req)
        if self.scfg.max_kv_len and kv_len > self.scfg.max_kv_len:
            raise ValueError(
                f"request {req.rid}: {kv_len} KV tokens exceed the per-lane "
                f"capacity of {self.scfg.max_kv_len}; it could never be "
                f"admitted")
        req.state = WAITING
        req.t_submit = now_ns()
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def free_lanes(self) -> list[int]:
        return [ln for ln in range(self.scfg.max_lanes) if ln not in self.running]

    # ---------------- admission policy ----------------

    def _kv_len(self, req: Request) -> int:
        """Tokens this request puts in the KV cache at admission.

        The vlm prefix is charged at the request's ACTUAL patch count — the
        same number the engine admits — not the config's nominal
        ``frontend_tokens``, so the page budget never drifts from what the
        burst will allocate.
        """
        prefix = req.patches.shape[0] if req.patches is not None else 0
        return req.prompt_len + prefix

    def admission_order(self) -> list[Request]:
        """Waiting requests in admission order: priority (desc), then FIFO.

        The stable sort keeps the historical FIFO behaviour exactly when
        every request carries the default priority 0.
        """
        return sorted(self.waiting, key=lambda r: -r.priority)

    def plan_admission(self, free_pages: int, probe=None,
                       alias: bool = False) -> AdmissionPlan:
        """Select waiting requests to admit, priority-then-FIFO, under the
        page budget.

        A request is admissible while (a) a lane is free, (b) its bucket has
        fewer than ``admit_width`` members (the static prefill batch width),
        and (c) its KV pages — plus one recurrent-state slot charge-through —
        fit in ``free_pages - page_reserve`` after earlier picks.  Selection
        is head-of-line blocking: the first request that does not fit stops
        the scan, preserving FIFO fairness under scarcity (within the
        priority ordering — see :meth:`admission_order`).

        ``probe`` is the engine's prefix-cache peek (``request -> cached
        token count``): the probe runs BEFORE bucket selection, so a cache
        hit buckets by its uncached SUFFIX length (a 2048-token prompt with
        a 2040-token hit compiles into the smallest bucket, not the
        largest).  Page charging depends on the hit-admission mode:

        * copy mode (``alias=False``, the default): cached pages are copied
          into freshly allocated lane pages at admission, so charging stays
          at the FULL kv length — budget math identical with the cache on
          or off.
        * alias mode (``alias=True``, DESIGN.md §12): cached pages are
          spliced into the lane's block table with a refcount bump, no new
          pages back them, so the charge drops by ``cached_len /
          page_size`` — a hot shared prefix admits for the price of its
          suffix.
        """
        budget = free_pages - self.scfg.page_reserve
        lanes = self.free_lanes()
        by_bucket: dict[int, list[tuple[int, Request]]] = {}
        charged = 0
        taken = 0
        for req in self.admission_order():
            if taken >= len(lanes):
                break
            req.cached_len = int(probe(req)) if probe is not None else 0
            bucket = pick_bucket(req.prompt_len - req.cached_len, self.scfg)
            members = by_bucket.setdefault(bucket, [])
            if len(members) >= self.scfg.admit_width:
                break
            need = pages_needed(self._kv_len(req), self.scfg) \
                + self.scfg.stash_precharge
            if alias:
                # cached_len is page-aligned; aliased prefix pages are
                # shared, not allocated, so only the suffix is charged
                need -= req.cached_len // self.scfg.page_size
            if charged + need > budget:
                break
            members.append((lanes[taken], req))
            charged += need
            taken += 1
        batches = [AdmissionBatch(bucket=b, items=items)
                   for b, items in sorted(by_bucket.items()) if items]
        return AdmissionPlan(batches=batches, pages_charged=charged)

    def commit_admission(self, plan: AdmissionPlan) -> None:
        """Move the planned requests waiting -> running on their lanes."""
        admitted = {id(req) for b in plan.batches for _, req in b.items}
        self.waiting = deque(r for r in self.waiting if id(r) not in admitted)
        for b in plan.batches:
            for lane, req in b.items:
                req.state = RUNNING
                req.lane = lane
                req._admit_mark = len(req.output)
                if req.t_admit is None:
                    req.t_admit = now_ns()
                self.running[lane] = req

    # ---------------- decode / completion lifecycle ----------------

    def note_admission(self, admitted_tokens: dict[int, int]) -> list[int]:
        """Record the admission-seeded tokens as generated output.

        ``admitted_tokens`` is :attr:`ServingEngine.admitted_tokens` — for
        attention families the prefill argmax IS the request's first
        generated token (recurrent families publish an empty mapping).
        Recording it keeps ``Request.output`` complete, which preemption's
        resume prefix depends on.  Returns lanes already finished by the
        seed alone (``max_new_tokens == 1``), which the caller must release.
        """
        done = []
        for lane, tok in admitted_tokens.items():
            req = self.running.get(lane)
            if req is None:
                continue               # admission failed; lane already gone
            req.output.append(int(tok))
            req.generated += 1
            if req.t_first is None:
                req.t_first = now_ns()
            if req.generated >= req.max_new_tokens:
                done.append(lane)
        return done

    def note_decode_step(self, tokens: Optional[np.ndarray] = None
                         ) -> list[int]:
        """Advance every running request one token; return finished lanes.

        ``tokens`` — the ``[max_lanes]`` next-token array the engine's step
        returned — records each lane's generated token on its request
        (``Request.output``), which preemption needs to rebuild the resume
        prefix and callers need for the final response payload.
        """
        done = []
        for lane, req in self.running.items():
            req.generated += 1
            if tokens is not None:
                req.output.append(int(tokens[lane]))
            if req.t_first is None:
                req.t_first = now_ns()
            if req.generated >= req.max_new_tokens:
                done.append(lane)
        return done

    def release_packet_array(self, lanes: list[int]) -> np.ndarray:
        """Completion packets for ``paged_kv.release_packets`` (module fn)."""
        return release_packet_array(lanes, self.scfg.max_lanes)

    def kv_token_prefix(self, lane: int) -> np.ndarray:
        """The token sequence whose KV the running lane holds right now —
        the demotion key for the prefix cache (DESIGN.md §11).

        The admission prefix contributed KV for every prompt token; each
        decode step then appended KV for the token it CONSUMED, i.e. the
        previously sampled one — so the last sampled token's KV was never
        written and ``output[-1]`` is excluded.  Call BEFORE
        :meth:`complete` pops the request.
        """
        req = self.running[lane]
        gen = req.output[req._admit_mark:-1]
        if not gen:
            return np.asarray(req.tokens, np.int32)
        return np.concatenate([np.asarray(req.tokens, np.int32),
                               np.asarray(gen, np.int32)])

    def head_shortfall(self, free_pages: int) -> Optional[int]:
        """Pages missing for the head-of-line waiting request, or ``None``
        when more pages wouldn't help (no waiting work, no free lane, or
        the head already fits and admission is stuck on something else).
        Drives the prefix cache's shortfall eviction: the engine evicts at
        least this many cached pages and replans."""
        if not self.waiting or not self.free_lanes():
            return None
        head = self.admission_order()[0]
        need = pages_needed(self._kv_len(head), self.scfg) \
            + self.scfg.stash_precharge
        short = need - (free_pages - self.scfg.page_reserve)
        return short if short > 0 else None

    def fail_admission(self, lanes: list[int]) -> list[Request]:
        """Retire lanes whose admission the allocator rejected.

        The engine reports these from :meth:`ServingEngine.admit_many`; the
        requests move to the ``failed`` list (NOT ``finished``) so served
        counts never silently include unserved work.
        """
        out = []
        for lane in lanes:
            req = self.running.pop(lane)
            req.state = FAILED
            req.lane = -1
            self.failed.append(req)
            out.append(req)
        return out

    # ---------------- preemption (DESIGN.md §10) ----------------

    def _held_kv_len(self, req: Request) -> int:
        """KV tokens the running request holds right now (admission prefix
        plus tokens generated since) — also its resume-prefix length."""
        return self._kv_len(req) + len(req.output) - req._admit_mark

    def preempt_victim(self, free_pages: Optional[int] = None
                       ) -> Optional[int]:
        """Lane to evict when admission is stuck: the lowest-priority
        running request, provided some WAITING request outranks it (strict
        priority preemption — equal priorities never thrash each other).
        Ties break toward the lane holding the most KV tokens, so one
        eviction frees the most pages.  Returns ``None`` when no eviction
        is justified.

        Two screens keep eviction from destroying work for nothing:
        requests whose grown resume prefix could no longer be re-admitted
        (``max_kv_len``) are never victims — evicting them would forfeit a
        request that will otherwise complete; and when ``free_pages`` is
        given, eviction is skipped unless the head waiting request would
        plausibly FIT afterwards (admission-charge estimate), so a
        never-admissible request cannot drain every running lane.
        """
        if not self.running or not self.waiting:
            return None
        head = self.admission_order()[0]
        candidates = [
            (lane, req) for lane, req in self.running.items()
            if not (self.scfg.max_kv_len
                    and self._held_kv_len(req) + 1 > self.scfg.max_kv_len)]
        if not candidates:
            return None
        lane, victim = min(
            candidates,
            key=lambda kv: (kv[1].priority, -self._held_kv_len(kv[1])))
        if victim.priority >= head.priority:
            return None
        if free_pages is not None:
            # what admission charged the victim (its pages + pre-charge)
            # returns to the pool; require the head request to fit then
            freed = pages_needed(self._held_kv_len(victim), self.scfg) \
                + self.scfg.stash_precharge
            need = pages_needed(self._kv_len(head), self.scfg) \
                + self.scfg.stash_precharge
            if need > free_pages + freed - self.scfg.page_reserve:
                return None
        return lane

    def preempt(self, lane: int) -> Request:
        """Evict the running request on ``lane`` and re-queue it.

        The resume prefix is the request's admission-time prefix plus every
        token generated since (``output[_admit_mark:]``), so a later
        re-admission prefills the full context and decode continues exactly
        where the eviction cut it off.  The caller is responsible for the
        engine-side ``FREE_ALL`` (:meth:`ServingEngine.preempt`) — scheduler
        and engine stay decoupled the same way completion is.
        """
        req = self.running[lane]
        if req.generated != len(req.output):
            # A loop that drove note_decode_step() WITHOUT the tokens array
            # (the legacy counting-only signature) cannot preempt safely:
            # the resume prefix is rebuilt from `output`, so missing tokens
            # would silently truncate the request's context.  Fail loudly.
            raise ValueError(
                f"cannot preempt lane {lane}: request {req.rid} counted "
                f"{req.generated} generated tokens but recorded "
                f"{len(req.output)} — pass the engine's token array to "
                f"note_decode_step() so the resume prefix stays complete")
        req = self.running.pop(lane)
        resumed = np.asarray(req.output[req._admit_mark:], np.int32)
        req.tokens = np.concatenate([req.tokens, resumed]) if resumed.size \
            else req.tokens
        req.state = WAITING
        req.lane = -1
        req.preemptions += 1
        if self.scfg.max_kv_len and self._kv_len(req) + 1 > self.scfg.max_kv_len:
            # the grown prefix can never be re-admitted: fail it loudly
            # instead of wedging the waiting queue forever
            req.state = FAILED
            self.failed.append(req)
            return req
        self.waiting.append(req)
        return req

    def complete(self, lanes: list[int]) -> list[Request]:
        """Retire finished lanes; returns the completed requests."""
        out = []
        for lane in lanes:
            req = self.running.pop(lane)
            req.state = FINISHED
            req.t_done = now_ns()
            req.lane = -1
            self.finished.append(req)
            out.append(req)
        return out
