"""Wrapper of the fused support-core CUDA kernel (``csrc/support_core.cu``).

:func:`support_core_burst` has the contract of the JAX package's
``repro.kernels.support_core.ops.support_core_burst``: one already-scheduled
HMQ burst in, ``(new_state, blocks [Q, R], ok [Q])`` out, in scheduled
order.  The device of the state decides the path:

* a CUDA state launches the hand-written kernel (built for ``sm_90a`` with
  ``nvcc`` at first use, bound through ``ctypes``) or raises;
* a CPU state runs the plain PyTorch version
  (:func:`repro_torch.core.support_core._step_scheduled_torch`), and so
  does a ``meta`` one: it has no data for a kernel to read (the dry run).
  On a mesh the allocator's state is replicated and reaches this function
  as local tensors (:func:`repro_torch.distributed.sharding
  .local_replicated`).

On the card each size class is one block or one thread-block cluster;
:func:`plan_burst` picks the path, the cluster size and the slices of the
id range from the shapes alone, and :func:`.ref.support_core_burst_sliced`
is the plain version of that sliced arithmetic.  The plan, the
shared-memory limit and the cluster's schedulability are worked out once
per shape, so a burst costs one ``ctypes`` call.

:data:`KERNEL` counts launches, so a run can show that its bursts went
through the kernel.  The build is :class:`repro_torch.kernels._build.Kernel`'s.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from ...core.freelist import FreeListState
from ...core.packets import RequestQueue
from ...core.support_core import _step_scheduled_torch
from .._build import Kernel

_STATE_FIELDS = ("free_stack", "free_top", "owner", "refcount", "alloc_count",
                 "free_count", "fail_count", "used", "peak_used")
_ROW_FIELDS = ("free_stack", "owner", "refcount")

# Shared with the kernel (csrc/support_core.cu); a change there is one here.
PATHS = ("block", "cluster", "global")
STATIC_SMEM = 256        # bytes kept for the kernel's static shared words
H100_SMEM_OPTIN = 232448  # the shared memory one H100 block may opt into
MAX_CLUSTER = 8           # portable cluster size
SLICE_IDS = 4096          # ids a cluster slice aims at (bytes over more SMs)
SMEM_TILE = 128           # ids a warp sweeps at once, rows in shared memory
GLOBAL_TILE = 32          # the same, rows in device memory


class BurstPlan(NamedTuple):
    """How one burst runs: ``path`` (one of :data:`PATHS`), ``cluster``
    blocks per class, ``slice`` ids per block (whole sweep tiles: 128 ids
    with the rows in shared memory, 32 on the global path; the last slice
    may be shorter) and the dynamic shared memory of each block."""

    path: str
    cluster: int
    slice: int
    smem_bytes: int

    def slices(self, N: int) -> list[tuple[int, int]]:
        """The ``[lo, hi)`` id range of each block of a class, in rank
        order."""
        return [(r * self.slice, min(N, (r + 1) * self.slice))
                for r in range(self.cluster)]


def head_words(Q: int) -> int:
    """Shared words a block stages the queue in: 8 per request (op, lane,
    class, arg, grant, offset, FREE_ALL lanes raw and sorted), padded to
    16 bytes."""
    return -(-8 * Q // 4) * 4


def block_ids(Q: int, smem_optin: int = H100_SMEM_OPTIN) -> int:
    """Ids whose 16 bytes of rows fit one block beside a Q-request queue
    (whole sweep tiles of 128 ids; 0 when the queue alone fills the
    block)."""
    free = smem_optin - STATIC_SMEM - 4 * head_words(Q)
    return max(0, free // 16 // SMEM_TILE * SMEM_TILE)


def _cut(N: int, k: int, tile: int) -> tuple[int, int]:
    """``(blocks, slice)``: at most ``k`` slices of a multiple of ``tile``
    ids covering ``[0, N)``, none empty."""
    S = -(-(-(-N // k)) // tile) * tile
    return -(-N // S), S


def plan_burst(Q: int, C: int, N: int,
               smem_optin: int = H100_SMEM_OPTIN) -> BurstPlan:
    """The path of a burst of ``Q`` requests over ``C`` classes of ``N``
    ids, from the shapes alone.

    * ``block``: the rows fit one block's shared memory (16 bytes per id
      beside the staged queue);
    * ``cluster``: they fit :data:`MAX_CLUSTER` blocks; the cluster takes
      enough blocks for slices of about :data:`SLICE_IDS` ids (up to
      :data:`MAX_CLUSTER`), more if the rows need them;
    * ``global``: beyond that, :data:`MAX_CLUSTER` blocks work on the rows
      in device memory.

    Slices are contiguous, in rank order, whole sweep tiles, and none is
    empty.  The state is never read: it lives on the device."""
    if min(Q, C, N) < 1:
        raise ValueError(f"need Q, C, N >= 1, got Q={Q} C={C} N={N}")
    head = 4 * head_words(Q)
    if head + STATIC_SMEM > smem_optin:
        raise ValueError(f"a queue of Q={Q} requests does not fit a block's "
                         f"{smem_optin} bytes of shared memory")
    cap = block_ids(Q, smem_optin)
    if N <= cap:
        k, S = _cut(N, 1, SMEM_TILE)
        return BurstPlan("block", k, S, head + 16 * S)
    if N <= MAX_CLUSTER * cap:
        k, S = _cut(N, max(-(-N // cap), min(MAX_CLUSTER, -(-N // SLICE_IDS))),
                    SMEM_TILE)
        return BurstPlan("cluster", k, S, head + 16 * S)
    k, S = _cut(N, MAX_CLUSTER, GLOBAL_TILE)
    return BurstPlan("global", k, S, head)


def _bind(lib: ctypes.CDLL) -> None:
    lib.support_core_smem_optin.argtypes = []
    lib.support_core_smem_optin.restype = ctypes.c_int
    lib.support_core_max_active_clusters.argtypes = [ctypes.c_int] * 6
    lib.support_core_max_active_clusters.restype = ctypes.c_int
    lib.support_core_burst_launch.argtypes = (
        [ctypes.c_void_p] * 25 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.support_core_burst_launch.restype = ctypes.c_int


KERNEL = Kernel("support_core",
                Path(__file__).resolve().parent / "csrc" / "support_core.cu",
                _bind)


@functools.lru_cache(maxsize=None)
def card_plan(Q: int, C: int, N: int) -> BurstPlan:
    """:func:`plan_burst` against the card's own shared-memory limit (read
    once), with a cluster's schedulability checked once: a cluster the card
    cannot hold raises, it never falls back to another path."""
    KERNEL.build()
    lib = KERNEL.lib
    plan = plan_burst(Q, C, N, smem_optin=lib.support_core_smem_optin())
    if plan.path != "block":
        n = lib.support_core_max_active_clusters(
            PATHS.index(plan.path), plan.cluster, plan.slice, Q, C, N)
        if n <= 0:
            raise RuntimeError(
                f"support-core burst Q={Q} C={C} N={N}: a cluster of "
                f"{plan.cluster} blocks with {plan.smem_bytes} bytes of shared "
                f"memory each cannot be scheduled on this card "
                f"(cudaOccupancyMaxActiveClusters: {n})")
    return plan


def _check(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def support_core_burst(
    state: FreeListState,
    sched: RequestQueue,
    max_blocks_per_req: int = 1,
    gated: bool = False,
) -> tuple[FreeListState, torch.Tensor, torch.Tensor]:
    """Run one scheduled HMQ burst; ``(new_state, blocks [Q, R], ok [Q])``.

    ``gated=True`` is ``AllocService.commit(gated=True)``'s skip branch:
    when no packet is live the state comes back unchanged, decided on the
    device.  The kernel is out of place; ``state`` is never written.
    """
    dev = state.free_stack.device
    if dev.type in ("cpu", "meta"):
        return _step_scheduled_torch(state, sched, max_blocks_per_req,
                                     gated=gated)
    if dev.type != "cuda":
        raise ValueError(f"support_core_burst: unsupported device {dev}")
    C, N = state.free_stack.shape
    Q, R = sched.capacity, int(max_blocks_per_req)
    if Q < 1 or R < 1:
        raise ValueError(f"need Q >= 1 and R >= 1, got Q={Q} R={R}")
    for name in _STATE_FIELDS:
        shape = (C, N) if name in _ROW_FIELDS else (C,)
        _check(name, getattr(state, name), shape, dev)
    for name in RequestQueue._fields:
        _check(f"sched.{name}", getattr(sched, name), (Q,), dev)
    plan = card_plan(Q, C, N)
    out = {n: torch.empty_like(getattr(state, n)) for n in _STATE_FIELDS}
    blocks = torch.empty((Q, R), dtype=torch.int32, device=dev)
    ok = torch.empty((Q,), dtype=torch.int32, device=dev)
    scratch = (torch.empty((C, N), dtype=torch.int32, device=dev)
               if plan.path == "global" else None)
    err = KERNEL.lib.support_core_burst_launch(
        *(t.data_ptr() for t in sched),
        *(getattr(state, n).data_ptr() for n in _STATE_FIELDS),
        *(out[n].data_ptr() for n in _STATE_FIELDS),
        blocks.data_ptr(), ok.data_ptr(),
        scratch.data_ptr() if scratch is not None else None,
        Q, C, N, R, int(gated), PATHS.index(plan.path), plan.cluster,
        plan.slice, torch.cuda.current_stream(dev).cuda_stream)
    KERNEL.check(err, f"Q={Q} C={C} N={N} R={R} {plan}")
    KERNEL.launches += 1
    return state._replace(**out), blocks, ok
