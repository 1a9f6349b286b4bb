"""Checkpoints in the JAX package's format (port of
:mod:`repro.distributed.checkpoint`), so either package restores what the
other saved.

A checkpoint of step s is a directory ``step_{s:08d}`` holding one
``.npy`` file per leaf, named ``md5(key)[:12]__p0.npy``, and
``index_p0.json`` (the port saves from one process, index 0): ``{step,
format: 1, arrays: {key: {file, shape, dtype, hash}}}`` with ``hash`` the
first 16 hex digits of the sha256 of the leaf's bytes.  Keys are the JAX
package's flattened paths: dict keys in sorted order, tuple and list
indices, NamedTuple field names, joined by ``/`` (``0/layers/attn/wq``,
``1/step``, ``1/m/embed``).

A bfloat16 leaf is written as the JAX package writes it (``np.save`` of an
``ml_dtypes`` array): npy ``descr`` ``'<V2'`` over the 16-bit words,
index dtype ``"bfloat16"``; it is read back through ``int16`` words, so
no ``ml_dtypes`` is needed.  A save writes ``step_XXXXXXXX.tmp`` and
renames it when complete; a restore checks every hash.
:class:`AsyncCheckpointer` writes on a thread, with back-pressure, and
keeps the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

_FLAT_SEP = "/"
BF16 = "bfloat16"
#: the file names' process index: the port saves from one process
PROCESS = 0


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[list]:
    """``[(key, child)]`` of a container in the JAX package's flatten
    order, or ``None`` for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _flatten(tree) -> dict[str, Any]:
    flat: dict[str, Any] = {}

    def walk(prefix, sub):
        kids = _children(sub)
        if kids is None:
            if sub is not None:
                flat[_FLAT_SEP.join(prefix)] = sub
            return
        for key, child in kids:
            walk(prefix + (key,), child)
    walk((), tree)
    return flat


def _unflatten(template, leaves: dict[str, Any], prefix=()):
    kids = _children(template)
    if kids is None:
        return leaves[_FLAT_SEP.join(prefix)] if template is not None \
            else None
    vals = [_unflatten(child, leaves, prefix + (key,)) for key, child in kids]
    if isinstance(template, dict):
        return dict(zip(sorted(template), vals))
    if _is_namedtuple(template):
        return type(template)(*vals)
    return type(template)(vals)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf on the host as numpy and its index dtype; a bf16 tensor as
    its 16-bit words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_npy(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != BF16:
        np.save(path, arr)
        return
    # the header that np.save writes for an ml_dtypes bfloat16 array
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _hash(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def save_checkpoint(directory: str | Path, tree, step: int) -> Path:
    """Write one checkpoint atomically; returns the committed path."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    index: dict[str, Any] = {"step": step, "format": 1, "arrays": {}}
    for key, leaf in _flatten(tree).items():
        arr, dtype = _to_numpy(leaf)
        fname = (f"{hashlib.md5(key.encode()).hexdigest()[:12]}"
                 f"__p{PROCESS}.npy")
        _save_npy(tmp / fname, arr, dtype)
        index["arrays"][key] = {"file": fname, "shape": list(arr.shape),
                                "dtype": dtype, "hash": _hash(arr)}
    (tmp / f"index_p{PROCESS}.json").write_text(json.dumps(index, indent=1))
    os.sync()
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(directory: str | Path, template,
                       step: Optional[int] = None):
    """Restore into the structure of ``template``, whose leaves are tensors
    (``meta`` ones will do): each comes back as a tensor of the template
    leaf's dtype, on its device (the CPU for a ``meta`` leaf).  Raises
    ``IOError`` on a leaf whose bytes fail their hash, ``KeyError`` on a
    missing one.  Returns ``(tree, step)``."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = directory / f"step_{step:08d}"
    index = json.loads((path / f"index_p{PROCESS}.json").read_text())
    out: dict[str, Any] = {}
    for key, leaf in _flatten(template).items():
        meta = index["arrays"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing array '{key}'")
        arr = np.load(path / meta["file"])
        got = _hash(arr)
        if got != meta["hash"]:
            raise IOError(f"integrity check failed for '{key}' "
                          f"(expected {meta['hash']}, got {got})")
        if meta["dtype"] == BF16:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        dev = leaf.device if leaf.device.type != "meta" else "cpu"
        out[key] = t.to(device=dev, dtype=leaf.dtype)
    return _unflatten(template, out), step


def _host_copy(tree):
    kids = _children(tree)
    if kids is None:
        if isinstance(tree, torch.Tensor):
            return tree.detach().to("cpu", copy=True)
        return None if tree is None else np.array(tree, copy=True)
    return _unflatten(tree, {k: _host_copy(v) for k, v in
                             _flatten(tree).items()})


class AsyncCheckpointer:
    """Off-thread checkpoint writer: :meth:`save` returns once the tree is
    copied to the host (the optimizer updates tensors in place); the
    training loop blocks only while a previous save is in flight
    (back-pressure)."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def save(self, tree, step: int) -> None:
        self.wait()
        host_tree = _host_copy(tree)

        def work():
            try:
                save_checkpoint(self.directory, host_tree, step)
                self._gc()
            except Exception as e:  # noqa: BLE001  (raised again by wait)
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(p for p in self.directory.glob("step_*")
                       if not p.name.endswith(".tmp"))
        for p in steps[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)
