"""The support-core's client API (port of :mod:`repro.alloc.service`).

* :class:`AllocService` owns the tenant table and the policy, and lives on
  one device.  ``register_tenant`` maps a client onto a size class whose
  capacity is its hard quota.
* :class:`BurstBuilder` stages typed ops (``malloc`` / ``refill`` /
  ``malloc_run`` / ``free`` / ``free_all``) and returns :class:`Ticket`\\ s;
  after :meth:`AllocService.commit` runs the burst as ONE support-core
  step, each ticket resolves to its own rows of the response.

N engine shards register disjoint tenant sets under their own namespaces
(``"e0/kv_pages"``, ``"e1/kv_pages"`` ...) on ONE service, and
:meth:`AllocService.rollup_report` sums them by base name.
``retag_blocks`` and ``bump_refcounts`` are the prefix cache's
control-plane scatters (owner demotion, alias references): no burst.

The policy step runs on the device of the state it is given: the CUDA
kernel on the card, the plain PyTorch version on the CPU.  The allocator-op
recorder of the JAX service waits for trace replay (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch

from ..core.freelist import FreeListState
from ..core.hmq import schedule
from ..core.packets import (FREE_ALL, NO_BLOCK, OP_FREE, OP_MALLOC,
                            OP_MALLOC_RUN, OP_NOP, OP_REFILL, RequestQueue)
from ..core.support_core import StepStats
from ..device import DeviceLike, resolve_device
from .policies import FreeListPolicy, get_policy

I32 = torch.int32

#: Separator between an engine namespace and the base tenant name
#: (``"e0/kv_pages"``).
NAMESPACE_SEP = "/"


class TenantHandle(NamedTuple):
    """A registered client of the support-core (one size class); its
    ``capacity`` is its hard block quota."""

    name: str
    size_class: int
    capacity: int

    @property
    def quota(self) -> int:
        return self.capacity

    @property
    def namespace(self) -> str:
        """Engine namespace prefix (empty for un-namespaced tenants)."""
        return self.name.rsplit(NAMESPACE_SEP, 1)[0] \
            if NAMESPACE_SEP in self.name else ""

    @property
    def base_name(self) -> str:
        """Tenant name with the engine namespace stripped (rollup key)."""
        return self.name.rsplit(NAMESPACE_SEP, 1)[-1]


class Ticket(NamedTuple):
    """Handle to a contiguous run of burst slots, resolved after commit."""

    start: int
    count: int


class TenantStats(NamedTuple):
    """Per-tenant (== per size class) breakdown of one burst, all ``[C]``."""

    mallocs: torch.Tensor
    failed: torch.Tensor
    blocks_allocated: torch.Tensor
    blocks_freed: torch.Tensor
    used: torch.Tensor             # post-step occupancy (quota consumption)


class BurstStats(NamedTuple):
    """Telemetry for one committed burst: aggregate + per-tenant, plus the
    queue's slot occupancy."""

    core: StepStats
    per_tenant: TenantStats
    queue_live: torch.Tensor       # non-NOP slots in the built queue
    queue_capacity: torch.Tensor   # queue capacity

    @property
    def failed(self):
        return self.core.failed


class BurstResult(NamedTuple):
    """One committed burst's responses, resolved through tickets."""

    blocks: torch.Tensor           # [Q, R] caller-order granted block ids
    status: torch.Tensor           # [Q] caller-order status (1 = served)
    stats: BurstStats
    live: torch.Tensor             # 0/1: whether any packet was live

    def blocks_for(self, ticket: Ticket) -> torch.Tensor:
        """``[count, R]`` blocks for the ticket's slots (caller order)."""
        return self.blocks[ticket.start:ticket.start + ticket.count]

    def ok_for(self, ticket: Ticket) -> torch.Tensor:
        """``[count]`` bool success per ticket slot."""
        return self.status[ticket.start:ticket.start + ticket.count] == 1


class BurstBuilder:
    """Stages typed allocator ops for one HMQ burst.

    Every op takes a scalar or ``[B]`` vector of lanes (one packet slot per
    lane) plus an optional ``where`` mask; masked-out slots become
    ``OP_NOP`` packets, so shapes never depend on data.  Slot order is
    insertion order == response order.
    """

    def __init__(self, service: "AllocService"):
        self._service = service
        self._ops: list[torch.Tensor] = []
        self._lanes: list[torch.Tensor] = []
        self._classes: list[torch.Tensor] = []
        self._args: list[torch.Tensor] = []
        self._size = 0

    @property
    def size(self) -> int:
        """Number of staged packet slots (the burst's queue capacity)."""
        return self._size

    def _vec(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=I32, device=self._service.device)

    def _lane_vec(self, lane) -> torch.Tensor:
        lanes = self._vec(lane)
        return lanes.reshape(1) if lanes.ndim == 0 else lanes

    def _append(self, op: int, tenant: TenantHandle, lane, arg, where
                ) -> Ticket:
        lanes = self._lane_vec(lane)
        n = lanes.shape[0]
        args = self._vec(arg).expand(n)
        ops = torch.full((n,), op, dtype=I32, device=lanes.device)
        if where is not None:
            mask = torch.as_tensor(where, dtype=torch.bool,
                                   device=lanes.device).expand(n)
            ops = torch.where(mask, ops, OP_NOP)
            args = torch.where(mask, args, 0)
        self._ops.append(ops)
        self._lanes.append(lanes)
        self._classes.append(self._vec(tenant.size_class).expand(n))
        self._args.append(args)
        ticket = Ticket(self._size, n)
        self._size += n
        return ticket

    def malloc(self, tenant: TenantHandle, lane, n=1, where=None) -> Ticket:
        """Request ``n`` blocks of ``tenant`` per lane (on the critical
        path: scheduled before refills and frees)."""
        return self._append(OP_MALLOC, tenant, lane, n, where)

    def refill(self, tenant: TenantHandle, lane, n, where=None) -> Ticket:
        """Speculative bulk malloc at refill priority (after every plain
        malloc, so it never starves an on-path allocation)."""
        return self._append(OP_REFILL, tenant, lane, n, where)

    def malloc_run(self, tenant: TenantHandle, lane, n=1, where=None
                   ) -> Ticket:
        """Malloc with a contiguity hint; a policy without run placement
        (the free list) gets a plain ``OP_MALLOC``, as in the JAX service."""
        op = OP_MALLOC_RUN if self._service.policy.supports_runs \
            else OP_MALLOC
        return self._append(op, tenant, lane, n, where)

    def free(self, tenant: TenantHandle, lane, block, where=None) -> Ticket:
        """Return single block ids; negative ids (``NO_BLOCK``) become NOPs
        rather than FREE_ALL."""
        lanes = self._lane_vec(lane)
        n = lanes.shape[0]
        valid = self._vec(block).expand(n) >= 0
        if where is not None:
            valid = valid & torch.as_tensor(where, dtype=torch.bool,
                                            device=lanes.device).expand(n)
        return self._append(OP_FREE, tenant, lanes, block, valid)

    def free_all(self, tenant: TenantHandle, lane, where=None) -> Ticket:
        """Free every block of ``tenant`` the lane owns (lane release)."""
        return self._append(OP_FREE, tenant, lane, FREE_ALL, where)

    def build_queue(self) -> RequestQueue:
        """Concatenate staged slots into one fixed-format request queue."""
        if not self._size:
            raise ValueError("empty burst: stage at least one op (or skip "
                             "the commit entirely)")
        return RequestQueue(op=torch.cat(self._ops),
                            lane=torch.cat(self._lanes),
                            size_class=torch.cat(self._classes),
                            arg=torch.cat(self._args))


class AllocService:
    """The support-core's client API: tenants in, tickets out.

    ``device`` defaults to ``cuda`` and raises on a host without a card;
    pass ``device="cpu"`` for the plain path.
    """

    def __init__(self, policy: str = "freelist", device: DeviceLike = None):
        self.device = resolve_device(device)
        self.policy: FreeListPolicy = get_policy(policy)
        self._tenants: dict[str, TenantHandle] = {}

    # ---------------- tenants ----------------

    def register_tenant(self, name: str, capacity: int) -> TenantHandle:
        """Add a named client; its quota is ``capacity`` blocks."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        if capacity <= 0:
            raise ValueError(f"tenant {name!r}: capacity must be positive")
        handle = TenantHandle(name=name, size_class=len(self._tenants),
                              capacity=int(capacity))
        self._tenants[name] = handle
        return handle

    def register_tenants(self, spec: Sequence[tuple[str, int]],
                         namespace: str = "") -> tuple[TenantHandle, ...]:
        """Register ``[(base_name, capacity), ...]`` in order (order fixes
        the size-class indices); a non-empty ``namespace`` prefixes every
        name (``"e0" -> "e0/kv_pages"``), so N engine shards register
        disjoint tenant sets on one service."""
        if namespace and NAMESPACE_SEP in namespace:
            raise ValueError(
                f"namespace {namespace!r} must not contain {NAMESPACE_SEP!r}")
        prefix = f"{namespace}{NAMESPACE_SEP}" if namespace else ""
        return tuple(self.register_tenant(f"{prefix}{name}", cap)
                     for name, cap in spec)

    def tenant(self, name: str, namespace: str = "") -> TenantHandle:
        if namespace:
            name = f"{namespace}{NAMESPACE_SEP}{name}"
        try:
            return self._tenants[name]
        except KeyError:
            raise KeyError(f"unknown tenant {name!r}; registered: "
                           f"{list(self._tenants)}") from None

    def namespace_tenants(self, namespace: str) -> tuple[TenantHandle, ...]:
        """All tenants registered under one engine namespace."""
        prefix = f"{namespace}{NAMESPACE_SEP}"
        return tuple(t for t in self.tenants if t.name.startswith(prefix))

    @property
    def namespaces(self) -> tuple[str, ...]:
        """Distinct engine namespaces, in registration order."""
        return tuple(dict.fromkeys(t.namespace for t in self.tenants
                                   if t.namespace))

    @property
    def tenants(self) -> tuple[TenantHandle, ...]:
        return tuple(self._tenants.values())

    @property
    def num_classes(self) -> int:
        return len(self._tenants)

    def tenant_names(self) -> tuple[str, ...]:
        return tuple(self._tenants)

    def init_state(self) -> FreeListState:
        """Fresh segregated metadata covering every registered tenant."""
        if not self._tenants:
            raise ValueError("register at least one tenant before init_state")
        return self.policy.init([t.capacity for t in self.tenants],
                                self.device)

    # ---------------- bursts ----------------

    def new_burst(self) -> BurstBuilder:
        return BurstBuilder(self)

    def retag_blocks(self, state: FreeListState, tenant: TenantHandle,
                     blocks, new_owner: int) -> FreeListState:
        """Rewrite ``owner[class, block]`` of live blocks (no burst): the
        prefix cache's demotion.  A lane's FREE_ALL matches ``owner ==
        lane`` and so skips retagged blocks; single frees still reclaim
        them.  Counters and ``used`` are untouched (the pages stay charged
        to the tenant)."""
        blocks = torch.as_tensor(blocks, dtype=torch.long,
                                 device=state.owner.device).reshape(-1)
        if not blocks.numel():
            return state
        owner = state.owner.clone()
        owner[tenant.size_class, blocks] = int(new_owner)
        return state._replace(owner=owner)

    def bump_refcounts(self, state: FreeListState, tenant: TenantHandle,
                       blocks, delta: int = 1) -> FreeListState:
        """Add ``delta`` to ``refcount[class, block]`` per listed id,
        duplicates accumulating (no burst): the alias splice's reference
        count.  Ids at or past the class's width (the JAX package's
        dropped sentinels) are skipped."""
        blocks = torch.as_tensor(blocks, dtype=torch.long,
                                 device=state.refcount.device).reshape(-1)
        if not blocks.numel():
            return state
        row = state.refcount[tenant.size_class]
        add = torch.zeros((row.shape[0] + 1,), dtype=I32, device=row.device)
        add.index_add_(0, blocks.clamp(max=row.shape[0]),
                       torch.full_like(blocks, int(delta), dtype=I32))
        refcount = state.refcount.clone()
        refcount[tenant.size_class] = row + add[:-1]
        return state._replace(refcount=refcount)

    def commit(
        self,
        state: FreeListState,
        burst: Union[BurstBuilder, RequestQueue],
        max_blocks_per_req: int = 1,
        gated: bool = False,
    ) -> tuple[FreeListState, "BurstResult"]:
        """Run one support-core step over the staged burst.

        ``gated=True`` gives the JAX service's skip semantics -- an all-NOP
        burst leaves the state bit-identical and every ticket resolves
        failed/empty -- decided on the device inside the step, so the
        caller pays no host sync for the gate.
        """
        queue = burst.build_queue() if isinstance(burst, BurstBuilder) \
            else burst
        if self._tenants and state.num_classes != self.num_classes:
            raise ValueError(
                f"allocator state carries {state.num_classes} size classes "
                f"but this service has {self.num_classes} registered tenants "
                f"({list(self._tenants)}); register every tenant BEFORE "
                f"init_state and commit against the matching state")
        live = queue.op != OP_NOP
        new_state, blocks, status, core, per_tenant = self._scheduled_step(
            state, queue, max_blocks_per_req, gated)
        stats = BurstStats(
            core=core, per_tenant=per_tenant,
            queue_live=live.sum(dtype=I32),
            queue_capacity=torch.tensor(queue.capacity, dtype=I32,
                                        device=queue.op.device))
        return new_state, BurstResult(blocks=blocks, status=status,
                                      stats=stats, live=live.any().to(I32))

    def _scheduled_step(self, state, queue, R, gated):
        """Schedule + policy step + caller-order routing + stats (policy-
        independent, as in the JAX service)."""
        C = state.num_classes
        sched, unperm = schedule(queue)
        new_state, blocks, ok = self.policy.step_scheduled(
            state, sched, R, gated=gated)

        is_malloc = ((sched.op == OP_MALLOC) | (sched.op == OP_REFILL)
                     | (sched.op == OP_MALLOC_RUN))
        is_free = sched.op == OP_FREE
        failed = is_malloc & (ok == 0)
        status_sched = torch.where(is_malloc, ok, (sched.op != OP_NOP).to(I32))
        granted = (blocks != NO_BLOCK).sum(1, dtype=I32)
        freed = new_state.free_count - state.free_count
        core = StepStats(
            mallocs=is_malloc.sum(dtype=I32),
            frees=is_free.sum(dtype=I32),
            failed=failed.sum(dtype=I32),
            blocks_allocated=granted.sum(dtype=I32),
            blocks_freed=freed.sum(dtype=I32),
        )
        cls = sched.size_class.clamp(0, C - 1)
        onehot = (torch.arange(C, dtype=I32, device=cls.device)[None, :]
                  == cls[:, None]).to(I32)                           # [Q, C]
        per_tenant = TenantStats(
            mallocs=(is_malloc.to(I32)[:, None] * onehot).sum(0, dtype=I32),
            failed=(failed.to(I32)[:, None] * onehot).sum(0, dtype=I32),
            blocks_allocated=(granted[:, None] * onehot).sum(0, dtype=I32),
            blocks_freed=freed,
            used=new_state.used,
        )
        return (new_state, blocks[unperm], status_sched[unperm], core,
                per_tenant)

    # ---------------- host-side reporting ----------------

    def tenant_report(self, state: FreeListState,
                      tenants: Optional[Sequence[TenantHandle]] = None,
                      ) -> dict[str, dict]:
        """Per-tenant occupancy / quota / counter snapshot (host side)."""
        f = {k: getattr(state, k).cpu().tolist() for k in
             ("used", "peak_used", "alloc_count", "free_count", "fail_count")}
        out = {}
        for t in (self.tenants if tenants is None else tenants):
            c = t.size_class
            out[t.name] = {"size_class": c, "quota": t.quota,
                           **{k: v[c] for k, v in f.items()}}
        return out

    def rollup_report(self, state: FreeListState) -> dict[str, dict]:
        """Cross-engine rollup: :meth:`tenant_report` summed by base tenant
        name over every namespace on this service, with an ``engines``
        count (``"e0/kv_pages"`` + ``"e1/kv_pages"`` -> ``"kv_pages"``)."""
        out: dict[str, dict] = {}
        keys = ("quota", "used", "peak_used", "alloc_count", "free_count",
                "fail_count")
        for t, rep in zip(self.tenants, self.tenant_report(state).values()):
            d = out.setdefault(t.base_name,
                               {"engines": 0, **{k: 0 for k in keys}})
            d["engines"] += 1
            for k in keys:
                d[k] += rep[k]
        return out
