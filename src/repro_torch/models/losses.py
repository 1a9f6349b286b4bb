"""Memory-efficient cross entropy (port of :mod:`repro.models.losses`).

``log_softmax`` + a gather would hold f32 ``[B, S, V]`` buffers: at
gemma3-1b's 262144-word vocabulary and 8 x 1024 tokens one such buffer is
8.6 GB.  :class:`SoftmaxCrossEntropy` keeps the logits in their own dtype
end to end and works over row chunks:

  forward : nll = logsumexp(logits) - logits[label]   (f32 per chunk)
  backward: d_logits = (softmax(logits) - onehot) * g (f32 per chunk, then
            the logits' dtype; the one-hot is a subtraction at the label,
            by index)

so neither pass holds more than one chunk of rows in f32.  The arithmetic is
the JAX custom VJP's, row for row.

Sharded logits (a ``DTensor`` on a mesh: rows over the data axes, the
vocabulary over ``model``) are one chunk, each rank holding its slice,
and the label's logit and the one-hot are selected by a mask rather than
indexed, so that no rank gathers the vocabulary.
"""
from __future__ import annotations

import torch

from ..distributed.sharding import is_dtensor

#: f32 elements of one chunk of rows (256 MiB): 256 rows at a 262144-word
#: vocabulary, the whole batch at a small one
CHUNK_ELEMENTS = 1 << 26


def _chunk_rows(n_rows: int, vocab: int, chunk_rows) -> int:
    rows = chunk_rows or max(1, CHUNK_ELEMENTS // vocab)
    return max(1, min(rows, n_rows))


class SoftmaxCrossEntropy(torch.autograd.Function):
    """``(logits [..., V], labels [...] int, chunk_rows) -> nll [...] f32``;
    the gradient flows to the logits only."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, labels: torch.Tensor,
                chunk_rows=None):
        V = logits.shape[-1]
        flat = logits.reshape(-1, V)
        lab = labels.reshape(-1).long()
        if is_dtensor(flat):
            rows = flat.shape[0]
            lse = torch.logsumexp(flat.float(), dim=-1)
            gold = torch.where(_is_label(flat, lab), flat.float(),
                               0.0).sum(-1)
        else:
            rows = _chunk_rows(flat.shape[0], V, chunk_rows)
            lse = torch.empty(flat.shape[0], dtype=torch.float32,
                              device=logits.device)
            for s in range(0, flat.shape[0], rows):
                lse[s:s + rows] = torch.logsumexp(flat[s:s + rows].float(),
                                                  dim=-1)
            gold = flat.gather(1, lab[:, None])[:, 0].float()
        ctx.save_for_backward(flat, lab, lse)
        ctx.rows = rows
        ctx.shape = logits.shape
        return (lse - gold).reshape(labels.shape)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        flat, lab, lse = ctx.saved_tensors
        g = g.reshape(-1).float()
        if is_dtensor(flat):
            p = torch.exp(flat.float() - lse[:, None])
            p = torch.where(_is_label(flat, lab), p - 1.0, p)
            return (p * g[:, None]).to(flat.dtype).reshape(ctx.shape), \
                None, None
        d = torch.empty_like(flat)
        rows = ctx.rows
        for s in range(0, flat.shape[0], rows):
            e = min(s + rows, flat.shape[0])
            p = torch.exp(flat[s:e].float() - lse[s:e, None])
            p[torch.arange(e - s, device=p.device), lab[s:e]] -= 1.0
            d[s:e] = (p * g[s:e, None]).to(d.dtype)
        return d.reshape(ctx.shape), None, None


def _is_label(flat: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
    """``[rows, V]`` bool: column == the row's label."""
    cols = torch.arange(flat.shape[-1], device=flat.device)
    return cols[None, :] == lab[:, None]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          chunk_rows=None) -> torch.Tensor:
    """logits ``[..., V]`` (any float dtype), labels ``[...]`` int -> nll
    ``[...]`` f32.  ``chunk_rows`` sets the rows a chunk holds in f32
    (default: ``CHUNK_ELEMENTS // V``)."""
    return SoftmaxCrossEntropy.apply(logits, labels, chunk_rows)
