"""Gradient compression with error feedback (port of
:mod:`repro.distributed.compression`).

int8 block-quantized gradients, quantized and straight back to f32: the
numerical effect of a compressed data-parallel all-reduce.  An error
feedback accumulator (Karimireddy et al.) carries each quantization's
residual into the next one.  Bit for bit with the JAX package: the
arithmetic is IEEE f32 division, multiplication and round half to even in
both.
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import torch
import torch.nn.functional as F

from ..models.model_zoo import STACKED, jax_leaves

F32 = torch.float32


class CompressionConfig(NamedTuple):
    enabled: bool = False
    bits: int = 8
    block: int = 256            # per-block scales


class ErrorFeedback(NamedTuple):
    residual: Any               # {parameter name: f32 tensor}


def init_error_feedback(params) -> ErrorFeedback:
    """Zero residuals for every parameter of ``params`` (the LM)."""
    return ErrorFeedback(residual={
        n: torch.zeros(p.shape, dtype=F32, device=p.device)
        for n, p in params.named_parameters()})


def _quantize_dequantize(g: torch.Tensor, bits: int, block: int
                         ) -> torch.Tensor:
    """Symmetric per-block int quantization, straight back to f32."""
    qmax = 2.0 ** (bits - 1) - 1
    flat = g.reshape(-1)
    n = flat.shape[0]
    flat = F.pad(flat, (0, (-n) % block)).reshape(-1, block)
    scale = flat.abs().amax(dim=1, keepdim=True) / qmax
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(flat / scale), -qmax, qmax)
    return (q * scale).reshape(-1)[:n].reshape(g.shape)


def compress_decompress(grads: Mapping[str, torch.Tensor], opt_state,
                        cfg: CompressionConfig):
    """Quantize -> dequantize every gradient, with error feedback carried
    in ``opt_state.ef`` where the state has one (an :class:`ErrorFeedback`);
    without it the path is stateless, as in the JAX package (whose
    ``AdamWState`` has no ``ef``).  Returns ``(grads, opt_state)``.

    The blocks run over each leaf of the JAX tree, so a stacked leaf's
    layers are quantized as one array (a block may span two layers), as
    in the JAX package."""
    ef = getattr(opt_state, "ef", None)
    new, resid = {}, {}
    for path, names in jax_leaves(grads).items():
        def leaf(d):
            return torch.stack([d[n] for n in names]) \
                if path[0] in STACKED else d[names[0]]
        # "+ 0.0" without a residual, as the JAX function: -0.0 -> +0.0
        g32 = leaf(grads).to(F32) + (leaf(ef.residual) if ef is not None
                                     else 0.0)
        deq = _quantize_dequantize(g32, cfg.bits, cfg.block)
        for src, out in ((deq, new), (g32 - deq, resid)):
            parts = src.unbind(0) if path[0] in STACKED else (src,)
            out.update(zip(names, parts))
    if ef is None:
        return new, opt_state
    return new, opt_state._replace(ef=ErrorFeedback(residual=resid))
