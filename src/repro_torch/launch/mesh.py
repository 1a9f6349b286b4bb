"""Production meshes (port of :mod:`repro.launch.mesh`).

Each function returns a :class:`torch.distributed.device_mesh.DeviceMesh`
with the JAX mesh's shape and dim names over the caller's default process
group, whose world size must be the mesh's size.  The port reads no
environment, so it never opens a group from ``env://``: a caller opens
one with :func:`process_group` --

* the dry run: the ``fake`` backend at 256 or 512 ranks (collectives are
  recorded, never sent), with meta tensors on a ``cuda`` mesh, so that the
  redistributions counted are the ones NCCL would run;
* one card: ``nccl`` at world size 1 over an in-process ``HashStore``;
* the CPU tests: ``gloo`` over a ``FileStore`` shared by the ranks.

One group is open at a time: :func:`process_group` destroys its group on
exit, before the caller opens the next one.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@contextlib.contextmanager
def process_group(backend: str, world_size: int = 1, rank: int = 0,
                  store: Optional[dist.Store] = None):
    """Open the default process group for the ``with`` block and destroy
    it after.  ``store`` defaults to an in-process ``HashStore``, which
    serves one process (world size 1, or the ``fake`` backend's ranks);
    ``backend="fake"`` registers PyTorch's fake backend first."""
    if dist.is_initialized():
        raise RuntimeError("a default process group is already open; one "
                           "mesh's group is destroyed before the next opens")
    if backend == "fake":
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
    dist.init_process_group(backend, store=store or dist.HashStore(),
                            rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape: tuple, names: tuple, device_type: str) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("open the process group first (process_group)")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 (data, model) single-pod or 2x16x16 (pod, data, model)
    multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_elastic_mesh(model_parallelism: int = 16,
                      device_type: str = "cuda") -> DeviceMesh:
    """(data, model) from however many ranks the group has: ``model`` is
    the largest power-of-two fraction of ``model_parallelism`` that
    divides it."""
    n = dist.get_world_size()
    model = min(model_parallelism, n)
    while n % model:
        model //= 2
    return _mesh((n // model, model), ("data", "model"), device_type)


def make_host_smoke_mesh(device_type: str = "cuda") -> DeviceMesh:
    """(ranks, 1) (data, model): the sharded code path on one card (or
    the group's ranks) with no model parallelism."""
    return _mesh((dist.get_world_size(), 1), ("data", "model"), device_type)


def data_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """The axes a data-parallel batch shards over (includes 'pod' if
    present)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
