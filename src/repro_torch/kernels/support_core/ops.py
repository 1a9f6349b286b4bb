"""Wrapper of the fused support-core CUDA kernel (``csrc/support_core.cu``).

:func:`support_core_burst` has the contract of the JAX package's
``repro.kernels.support_core.ops.support_core_burst``: one already-scheduled
HMQ burst in, ``(new_state, blocks [Q, R], ok [Q])`` out, in scheduled
order.  The device of the state decides the path:

* a CUDA state launches the hand-written kernel (built for ``sm_90a`` with
  ``nvcc`` at first use, bound through ``ctypes``) or raises;
* a CPU state runs the plain PyTorch version
  (:func:`repro_torch.core.support_core._step_scheduled_torch`).

:data:`KERNEL` counts launches, so a run can show that its bursts went
through the kernel.  The build goes to ``build/kernels/`` at the repository
root, under a name keyed by the source's content hash.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from ...core.freelist import FreeListState
from ...core.packets import RequestQueue
from ...core.support_core import _step_scheduled_torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "support_core.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_STATE_FIELDS = ("free_stack", "free_top", "owner", "refcount", "alloc_count",
                 "free_count", "fail_count", "used", "peak_used")


class _Kernel:
    """Build-once handle of the shared library and its launch count."""

    def __init__(self):
        self.lib: Optional[ctypes.CDLL] = None
        self.launches = 0          # plain integer, +1 per kernel launch
        self.build_seconds: Optional[float] = None


KERNEL = _Kernel()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the support-core kernel is built "
                       "from csrc/support_core.cu at first use")


def build() -> Path:
    """Compile the kernel (once per source content) and load it.

    Returns the shared library's path; ``KERNEL.build_seconds`` holds the
    time this call spent (0 when the library was already built).
    """
    if KERNEL.lib is not None:
        return Path(KERNEL.lib._name)
    t0 = time.perf_counter()
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    so = BUILD_DIR / f"libsupport_core-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.support_core_in_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.support_core_in_smem.restype = ctypes.c_int
    lib.support_core_burst_launch.argtypes = (
        [ctypes.c_void_p] * 25 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.support_core_burst_launch.restype = ctypes.c_int
    KERNEL.lib = lib
    KERNEL.build_seconds = time.perf_counter() - t0
    return so


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
    if dev.type == "cpu":
        return _step_scheduled_torch(state, sched, max_blocks_per_req,
                                     gated=gated)
    if dev.type != "cuda":
        raise ValueError(f"support_core_burst: unsupported device {dev}")
    C, N = state.free_stack.shape
    Q, R = sched.capacity, int(max_blocks_per_req)
    if Q < 1 or R < 1:
        raise ValueError(f"need Q >= 1 and R >= 1, got Q={Q} R={R}")
    for name in _STATE_FIELDS:
        shape = (C, N) if name in ("free_stack", "owner", "refcount") else (C,)
        _check(name, getattr(state, name), shape, dev)
    for name in RequestQueue._fields:
        _check(f"sched.{name}", getattr(sched, name), (Q,), dev)
    build()
    lib = KERNEL.lib
    out = {name: torch.empty_like(getattr(state, name)) for name in _STATE_FIELDS}
    blocks = torch.empty((Q, R), dtype=torch.int32, device=dev)
    ok = torch.empty((Q,), dtype=torch.int32, device=dev)
    in_smem = lib.support_core_in_smem(Q, N)
    scratch = None if in_smem else torch.empty((C, N), dtype=torch.int32,
                                               device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (*sched, *(getattr(state, n)
                                             for n in _STATE_FIELDS),
                                   *(out[n] for n in _STATE_FIELDS),
                                   blocks, ok)]
    ptrs.append(scratch.data_ptr() if scratch is not None else None)
    err = lib.support_core_burst_launch(*ptrs, Q, C, N, R, int(gated),
                                        in_smem, stream)
    if err != 0:
        raise RuntimeError(f"support-core kernel launch failed: CUDA error "
                           f"{err} (Q={Q} C={C} N={N} R={R})")
    KERNEL.launches += 1
    new_state = state._replace(**out)
    return new_state, blocks, ok
