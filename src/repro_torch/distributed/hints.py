"""Activation-sharding hints threaded through the model code (port of
:mod:`repro.distributed.hints`).

The parameters' placements propagate through ``DTensor`` ops, but the
activation layout between layers decides what a step holds and moves: the
hints redistribute the residual stream to Megatron-style sequence
sharding over ``model``, the logits to vocab sharding, the decode lanes
and the gathered KV over the data axes, and the MoE dispatch buffer over
its groups and experts.

Where JAX's ``with_sharding_constraint`` tells the partitioner a layout,
a hint here redistributes a ``DTensor`` to the placements of JAX's spec:
the collective it takes is the one GSPMD would insert.  A hint whose spec
does not divide the tensor's shape is skipped entirely, as JAX's
``_apply`` skips it; with no mesh, or for a plain tensor, a hint returns
its input.

``ShardingHints(mesh)`` reaches the steps as an argument and the code
below them through :func:`use_hints` / :func:`current_hints` (a
``contextvars.ContextVar``, as in JAX).  JAX's perf flags are arguments
here with JAX's defaults: ``kv_gather_shard="lanes"`` (``"auto"`` shards
the gathered KV over ``model`` too) and ``moe_local_dispatch=False``
(``True`` pins the MoE scatter and combine dp-local and moves the buffer
to the experts' placement explicitly).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from .sharding import _axis_size, constrain, dp_axes, is_dtensor, \
    mesh_sizes


class ShardingHints:
    def __init__(self, mesh, seq_shard: bool = True,
                 kv_gather_shard: str = "lanes",
                 moe_local_dispatch: bool = False):
        if kv_gather_shard not in ("lanes", "auto"):
            raise ValueError(f"kv_gather_shard {kv_gather_shard!r}: 'lanes' "
                             f"or 'auto'")
        self.mesh = mesh
        self.seq_shard = seq_shard
        self.kv_gather_shard = kv_gather_shard
        self.moe_local_dispatch = moe_local_dispatch
        self._dp = dp_axes(mesh) if mesh is not None else None

    def _apply(self, x: torch.Tensor, spec: tuple) -> torch.Tensor:
        if self.mesh is None or not is_dtensor(x):
            return x
        for dim, want in zip(x.shape, spec):
            if want is not None and dim % _axis_size(self.mesh, want):
                return x   # non-divisible: skip the hint entirely
        return constrain(x, self.mesh, spec)

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, d] residual stream: batch over dp, seq over model."""
        if x.ndim != 3:
            return x
        seq = "model" if self.seq_shard else None
        return self._apply(x, (self._dp, seq, None))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, V]: batch over dp, vocab over model."""
        if x.ndim != 3:
            return x
        return self._apply(x, (self._dp, None, "model"))

    def lanes(self, x: torch.Tensor) -> torch.Tensor:
        """[lanes, ...] decode activations: lanes over dp."""
        return self._apply(x, (self._dp,) + (None,) * (x.ndim - 1))

    def microbatches(self, x: torch.Tensor) -> torch.Tensor:
        """[accum, B/accum, ...]: the accumulation dim unsharded, batch
        over dp."""
        if x.ndim < 2:
            return x
        return self._apply(x, (None, self._dp) + (None,) * (x.ndim - 2))

    def gathered_kv_spec(self, kv_heads: int) -> tuple:
        """The spec of the ``[lanes, S, KV, hd]`` gathered cache.
        ``lanes``: lanes over dp only; ``auto``: also over ``model`` -- KV
        heads when they divide, else the position dim."""
        if self.kv_gather_shard == "lanes":
            return (self._dp, None, None, None)
        if kv_heads % mesh_sizes(self.mesh).get("model", 1) == 0:
            return (self._dp, None, "model", None)
        return (self._dp, "model", None, None)

    def gathered_kv(self, x: torch.Tensor, kv_heads: int) -> torch.Tensor:
        """[lanes, S, KV, hd] gathered cache, by :meth:`gathered_kv_spec`."""
        if x.ndim != 4 or self.mesh is None:
            return x
        return self._apply(x, self.gathered_kv_spec(kv_heads))

    def moe_groups(self) -> int:
        """Number of dispatch groups for MoE (== |dp|, so that dispatch is
        local)."""
        if self.mesh is None or self._dp is None:
            return 1
        return _axis_size(self.mesh, self._dp)

    def expert_buffer(self, x: torch.Tensor) -> torch.Tensor:
        """[G, E, C, d] grouped dispatch buffer: groups over dp, experts
        over model when they divide."""
        if x.ndim != 4:
            return x
        return self._apply(x, (self._dp, "model", None, None))

    def expert_buffer_local(self, x: torch.Tensor) -> torch.Tensor:
        """[G, E, C, d] pinned dp-local (E unsharded): the scatter and
        combine side."""
        if x.ndim != 4:
            return x
        return self._apply(x, (self._dp, None, None, None))


NO_HINTS = ShardingHints(None)

_CURRENT: contextvars.ContextVar[ShardingHints] = contextvars.ContextVar(
    "sharding_hints", default=NO_HINTS)


def current_hints() -> ShardingHints:
    """The ambient hints (set by the step factories)."""
    return _CURRENT.get()


@contextlib.contextmanager
def use_hints(h: Optional[ShardingHints]):
    """Make ``h`` (``None``: :data:`NO_HINTS`) the ambient hints; on a
    mesh, plain tensors the step makes (``arange``, ``zeros``) count as
    replicated where they meet a ``DTensor``."""
    token = _CURRENT.set(h if h is not None else NO_HINTS)
    disp = prev = None
    if h is not None and h.mesh is not None:
        # implicit_replication()'s flag, restored on exit rather than
        # cleared (the context manager clears it, which ends an outer one)
        from torch.distributed.tensor import DTensor
        disp = DTensor._op_dispatcher
        prev = disp._allow_implicit_replication
        disp._allow_implicit_replication = True
    try:
        yield
    finally:
        if disp is not None:
            disp._allow_implicit_replication = prev
        _CURRENT.reset(token)
