"""Wrapper of the allocator simulator's trace-scan CUDA kernel
(``csrc/sim_trace.cu``).

:func:`sim_trace` runs one trace -- ``[4, E]`` int32 rows thread, op,
size_class, foreign -- under one ``sim.policies.PolicySpec`` and returns
its :class:`~.ref.SimCounts`.  The device of the events decides the path:

* CUDA events launch the hand-written kernel once (built for ``sm_90a``
  with ``nvcc`` at first use, bound through ``ctypes``) or raise; the
  counts come back as 0-d float32 views of one 9-word device buffer, with
  no host sync;
* CPU events run the plain version (:func:`.ref.run_trace_plain`).

The ``[T, C]`` state sits in the block's shared memory when it fits beside
the staging buffer (:func:`state_path`, from the shapes and the card's
limit read once), else in a device scratch buffer.  The caller checks
that every event's thread and class lie in range (``sim.engine`` does, on
the host); the kernel skips an event that does not.

:data:`KERNEL` counts launches.  The build is
:class:`repro_torch.kernels._build.Kernel`'s.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .._build import Kernel
from .ref import SimCounts, run_trace_plain, trace_flags

# Shared with the kernel (csrc/sim_trace.cu); a change there is one here.
CHUNK = 2048             # events staged per round, 4 int32 rows each
PATHS = ("shared", "global")


def state_path(T: int, C: int, smem_optin: int) -> str:
    """``"shared"`` when the staging buffer, the class tables and the two
    ``[T, C]`` int32 tiers fit one block's ``smem_optin`` bytes of shared
    memory, else ``"global"`` (the tiers in a device scratch buffer)."""
    words = 4 * CHUNK + 2 * C + 2 * T * C
    return "shared" if 4 * words <= smem_optin else "global"


def _bind(lib: ctypes.CDLL) -> None:
    lib.sim_trace_smem_optin.argtypes = []
    lib.sim_trace_smem_optin.restype = ctypes.c_int
    lib.sim_trace_launch.argtypes = (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p] + [ctypes.c_int] * 8
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    lib.sim_trace_launch.restype = ctypes.c_int


KERNEL = Kernel("sim_trace",
                Path(__file__).resolve().parent / "csrc" / "sim_trace.cu",
                _bind)


@functools.lru_cache(maxsize=None)
def card_path(T: int, C: int) -> str:
    """:func:`state_path` against the card's own shared-memory limit."""
    KERNEL.build()
    optin = KERNEL.lib.sim_trace_smem_optin()
    if optin <= 0:
        raise RuntimeError(f"sim_trace: cannot read the card's shared-memory "
                           f"limit ({optin})")
    return state_path(T, C, optin)


def sim_trace(events: torch.Tensor, threads: int, policy,
              sizes: torch.Tensor) -> SimCounts:
    """Scan ``events`` under ``policy`` with ``threads`` threads and the
    per-class byte ``sizes`` (int32 ``[C]``, on the events' device)."""
    dev = events.device
    if dev.type == "cpu":
        return run_trace_plain(events, threads, policy, sizes.tolist())
    if dev.type != "cuda":
        raise ValueError(f"sim_trace: unsupported device {dev}")
    T = int(threads)
    if T < 0:
        raise ValueError(f"threads must be >= 0, got {T}")
    for name, t in (("events", events), ("sizes", sizes)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if events.dim() != 2 or events.shape[0] != 4:
        raise ValueError(f"events must be [4, E], got {tuple(events.shape)}")
    if sizes.dim() != 1 or sizes.shape[0] < 1:
        raise ValueError(f"sizes must be [C] with C >= 1, got "
                         f"{tuple(sizes.shape)}")
    E, C = events.shape[1], sizes.shape[0]
    path = card_path(T, C)
    central, stash_on, _ = trace_flags(policy)
    out = torch.empty((9,), dtype=torch.int32, device=dev)
    scratch = (torch.empty((2 * T * C,), dtype=torch.int32, device=dev)
               if path == "global" else None)
    err = KERNEL.lib.sim_trace_launch(
        events.data_ptr(), E, T, C, sizes.data_ptr(), policy.refill_batch,
        policy.local_cap, policy.flush_keep, policy.accel_cap,
        policy.stash_cap, int(central), int(stash_on), int(path == "shared"),
        scratch.data_ptr() if scratch is not None else None, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    KERNEL.check(err, f"E={E} T={T} C={C} {path}")
    KERNEL.launches += 1
    counts = out[:7].view(torch.float32)
    held = out[7:].to(torch.float32)
    return SimCounts(*counts.unbind(0), *held.unbind(0))
