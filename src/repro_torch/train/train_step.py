"""The training step: gradient accumulation over microbatches, remat,
optional gradient compression (port of :mod:`repro.train.train_step`).

:func:`make_train_step` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``.  ``params`` is the family's LM with gradients
turned on (``params.requires_grad_(True)``; serving keeps them off) and
is updated in place.  The JAX package's ``lax.scan`` over microbatches is
a loop here: each microbatch's gradients are summed in f32, then divided
by ``grad_accum``; compression and the AdamW update follow.  The metrics
are the loss (and, without accumulation, the unmasked token count) and
the global gradient norm, as tensors on the parameters' device.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from ..configs.base import ArchConfig
from ..distributed.compression import CompressionConfig, compress_decompress
from ..distributed.hints import ShardingHints, use_hints
from ..distributed.sharding import replicated
from ..models.model_zoo import loss_fn
from .optimizer import AdamW, AdamWState


def _split_microbatches(batch: Mapping, accum: int, hints=None
                        ) -> list[dict]:
    """``accum`` microbatches of the leading batch axis, in order (the JAX
    package's ``reshape(accum, b // accum, ...)``, then ``hints
    .microbatches``)."""
    for k, x in batch.items():
        if x.shape[0] % accum:
            raise ValueError(f"batch {x.shape[0]} of {k!r} not divisible by "
                             f"accum {accum}")

    def split(x):
        # a batch sharded over its rows regroups them: whole, then split
        x = replicated(x).reshape(accum, x.shape[0] // accum, *x.shape[1:])
        return hints.microbatches(x) if hints is not None else x
    mbs = {k: split(x) for k, x in batch.items()}
    return [{k: x[i] for k, x in mbs.items()} for i in range(accum)]


def make_train_step(cfg: ArchConfig, optimizer: AdamW, grad_accum: int = 1,
                    remat: bool = True,
                    compression: Optional[CompressionConfig] = None,
                    hints: Optional[ShardingHints] = None):
    """``hints`` run the step on ``DTensor`` parameters, optimizer state
    and batch placed by :mod:`repro_torch.distributed.sharding`, with the
    hints ambient (the MoE dispatch reads them)."""
    def grads_of(params, named, mb):
        for _, p in named:
            p.grad = None
        loss, metrics = loss_fn(params, cfg, mb, remat=remat, hints=hints)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in named}
        for _, p in named:
            p.grad = None
        return loss.detach(), metrics, grads

    def train_step(params, opt_state: AdamWState, batch: Mapping):
        with use_hints(hints):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state: AdamWState, batch: Mapping):
        named = list(params.named_parameters())
        if grad_accum == 1:
            loss, metrics, grads = grads_of(params, named, batch)
            metrics = dict(metrics, loss=loss)
        else:
            acc = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in named}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=named[0][1].device)
            for mb in _split_microbatches(batch, grad_accum, hints):
                l, _, g = grads_of(params, named, mb)
                for n in acc:
                    acc[n] += g[n].float()
                lsum = lsum + l
                del g
            grads = {n: a / grad_accum for n, a in acc.items()}
            del acc
            metrics = {"loss": lsum / grad_accum}
        if compression is not None and compression.enabled:
            grads, opt_state = compress_decompress(grads, opt_state,
                                                   compression)
        opt_state, gnorm = optimizer.update(grads, opt_state, params)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step
