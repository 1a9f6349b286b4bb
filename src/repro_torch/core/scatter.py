"""Element scatters that drop out-of-range indices.

The JAX package writes ``x.at[i, j].set(v, mode="drop")`` with a positive
out-of-bounds sentinel (``C``, ``N``, ``max_lanes``) in the slots it masks.
PyTorch has no drop mode, and an out-of-range ``index_put_`` raises or
corrupts memory, so these helpers map every out-of-range index to one extra
sink element past the end of a flat copy, scatter, and cut the sink off.
No boolean-mask compaction is involved, so a CUDA caller pays no
device-to-host sync.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


def _flat_index(shape: Sequence[int], idx: Sequence[torch.Tensor]
                ) -> torch.Tensor:
    """Row-major flat index of ``idx`` (one int tensor per dimension of
    ``shape``, broadcast together); any index outside its dimension maps to
    the sink position ``prod(shape)``."""
    parts = torch.broadcast_tensors(*[i.long() for i in idx])
    flat = torch.zeros_like(parts[0])
    valid = torch.ones_like(parts[0], dtype=torch.bool)
    for i, n in zip(parts, shape):
        valid &= (i >= 0) & (i < n)
        flat = flat * n + i
    return torch.where(valid, flat, math.prod(shape))


def _scatter(target, idx, values, add: bool) -> torch.Tensor:
    flat = _flat_index(target.shape, idx)
    vals = torch.as_tensor(values, dtype=target.dtype, device=target.device)
    vals = vals.expand(flat.shape).reshape(-1)
    flat = flat.reshape(-1)
    buf = torch.cat([target.reshape(-1), target.new_zeros(1)])
    if add:
        buf.scatter_add_(0, flat, vals)
    else:
        buf.scatter_(0, flat, vals)
    return buf[:-1].view(target.shape)


def set_drop(target: torch.Tensor, idx: Sequence[torch.Tensor], values
             ) -> torch.Tensor:
    """Out-of-place ``target.at[idx].set(values, mode="drop")`` where
    ``idx`` indexes every dimension of ``target``."""
    return _scatter(target, idx, values, add=False)


def add_drop(target: torch.Tensor, idx: Sequence[torch.Tensor], values
             ) -> torch.Tensor:
    """Out-of-place ``target.at[idx].add(values, mode="drop")``."""
    return _scatter(target, idx, values, add=True)
