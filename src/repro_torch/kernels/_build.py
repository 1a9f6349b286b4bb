"""Build-once handles for the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  At first
use it is compiled with ``nvcc`` for ``sm_90a`` into a shared library,
named by the source's content hash, under ``build/kernels/`` at the
repository root, and loaded with ``ctypes``.  Every C entry point returns
``cudaGetLastError()``; :meth:`Kernel.check` raises when it is not 0.
``nvcc`` runs with ``-Xptxas -v``: what it printed is kept beside the
library (``.log``) and in :attr:`Kernel.build_log`, and
:func:`ptxas_report` reads each kernel's registers and spills from it.
Nothing here runs when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from their csrc/*.cu sources at first use")


class Kernel:
    """One CUDA source: its build, its loaded library and its launch count.

    ``bind(lib)`` declares the library's ``argtypes``/``restype``.
    ``launches`` is a plain integer the wrapper adds one to per launch.
    """

    def __init__(self, name: str, source: Path,
                 bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = source
        self._bind = bind
        self.lib: Optional[ctypes.CDLL] = None
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.so_path: Optional[Path] = None
        self.build_log = ""      # nvcc's output for the loaded library

    def _start(self) -> Optional[tuple]:
        """Start ``nvcc`` unless the library exists; ``(proc, cmd, tmp)``."""
        digest = hashlib.sha1(self.source.read_bytes()).hexdigest()[:12]
        so = self.so_path = BUILD_DIR / f"lib{self.name}-{digest}.so"
        if so.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, cmd, tmp

    def _finish(self, started: Optional[tuple], t0: float) -> None:
        if started is not None:
            proc, cmd, tmp = started
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
            self.so_path.with_suffix(".log").write_text(out)
            os.replace(tmp, self.so_path)
        log = self.so_path.with_suffix(".log")
        self.build_log = log.read_text() if log.exists() else ""
        lib = ctypes.CDLL(str(self.so_path))
        self._bind(lib)
        self.lib = lib
        self.build_seconds = time.perf_counter() - t0

    def build(self) -> None:
        """Compile (once per source content) and load.  ``so_path`` names
        the library, ``build_seconds`` the time the first call spent."""
        if self.lib is None:
            t0 = time.perf_counter()
            self._finish(self._start(), t0)

    def check(self, err: int, what: str) -> None:
        """Raise when a C entry point returned a CUDA error."""
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error "
                               f"{err} ({what})")


def build_all(kernels: Sequence[Kernel]) -> None:
    """Build several kernels with one ``nvcc`` each, all started together."""
    t0 = time.perf_counter()
    todo = [k for k in kernels if k.lib is None]
    started = [k._start() for k in todo]
    for k, s in zip(todo, started):
        k._finish(s, t0)


def ptxas_report(log: str) -> list[dict]:
    """One dict per kernel entry in ``nvcc -Xptxas -v`` output: its
    (mangled) ``name``, ``registers``, ``spill_stores``/``spill_loads``
    (bytes) and ``smem`` (static shared memory, bytes)."""
    out: list[dict] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            out.append(dict(name=m.group(1), registers=None, spill_stores=0,
                            spill_loads=0, smem=0))
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[-1]["smem"] = int(m.group(1))
    return out
