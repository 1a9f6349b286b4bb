"""Plain PyTorch versions of paged decode attention.

* :func:`paged_attention_ref` -- port of the JAX oracle
  ``repro.kernels.paged_attention.ref.paged_attention_ref``: the current
  token is already in the cache, positions ``seq_len - window < pos <=
  seq_len`` are valid.
* :func:`paged_attention_plain` -- the kernel's plain version with the
  op's arguments: :func:`paged_attention_ref`, or in the self mode the
  serving decode's attention over the gathered pages,
  :func:`repro_torch.models.decode.paged_decode_attention` (cached slots
  ``pos < seq_len`` plus the token's own K/V as an appended self column,
  inactive lanes give zeros, the chunked scan of ``mea_attention``, as
  the JAX decode does).
* :func:`paged_attention_split` -- the kernel's split-and-merge
  arithmetic in plain PyTorch: per-chunk softmax states ``(m, l, acc)``
  in f32, merged in split order (both modes).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...core.packets import NO_BLOCK
from ...models.attention import NEG_INF


def paged_attention_ref(
    q: torch.Tensor,             # [B, KV, G, hd]
    k_pages: torch.Tensor,       # [num_pages, ps, KV, hd]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, P] int32 (invalid slots clamped to 0)
    seq_lens: torch.Tensor,      # [B] int32 (self token already in cache)
    window: int,
) -> torch.Tensor:
    """Returns ``[B, KV, G, hd]`` in q's dtype."""
    B, KV, G, hd = q.shape
    ps = k_pages.shape[1]
    P = block_tables.shape[1]
    idx = block_tables.long()
    k = k_pages[idx].permute(0, 3, 1, 2, 4).reshape(B, KV, P * ps, hd)
    v = v_pages[idx].permute(0, 3, 1, 2, 4).reshape(B, KV, P * ps, hd)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bkgd,bksd->bkgs", q.float() * scale, k.float())
    pos = torch.arange(P * ps, dtype=torch.int32, device=q.device)[None, :]
    valid = (pos <= seq_lens[:, None]) & (pos > seq_lens[:, None] - window)
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return out.to(q.dtype)


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor
                 ) -> torch.Tensor:
    """``[B, P * ps, KV, hd]``: each lane's pages in table order, a
    ``NO_BLOCK`` slot read as page 0 (``pages`` is ``[num_pages, ps, KV,
    hd]``, e.g. one layer's view of a pool)."""
    B, P = block_tables.shape
    safe = torch.where(block_tables == NO_BLOCK, 0, block_tables).long()
    return pages[safe].reshape(B, P * pages.shape[1], *pages.shape[2:])


def paged_attention_plain(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    block_tables: torch.Tensor, seq_lens: torch.Tensor, window: int,
    k_self: Optional[torch.Tensor] = None,
    v_self: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """What the kernel computes, on any device: ``[B, H, hd]``; the self
    mode when ``k_self``/``v_self``/``active`` are given."""
    if k_self is not None:
        # models.decode imports the op above this module: bind at call time
        from ...models.decode import paged_decode_attention
        return paged_decode_attention(
            q, gather_pages(k_pages, block_tables),
            gather_pages(v_pages, block_tables), k_self, v_self, seq_lens,
            active, window)
    B, H, hd = q.shape
    KV = k_pages.shape[2]
    tables = torch.where(block_tables == NO_BLOCK, 0, block_tables)
    out = paged_attention_ref(q.reshape(B, KV, H // KV, hd), k_pages,
                              v_pages, tables, seq_lens, window)
    return out.reshape(B, H, hd)


def paged_attention_split(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    block_tables: torch.Tensor, seq_lens: torch.Tensor, window: int,
    chunk: int, k_self: Optional[torch.Tensor] = None,
    v_self: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[B, H, hd]`` as the kernel computes it with chunks of ``chunk``
    live positions.

    A lane's live index ``t`` runs over the cached positions ``lo + t``
    for ``lo <= pos <= hi`` and then, in the self mode, the self position;
    chunk ``s`` takes ``s * chunk <= t < (s + 1) * chunk``, for as many
    chunks as :func:`.ops.plan_splits` covers the longest span with.
    Each chunk gives its max ``m``, denominator ``l`` and accumulator in
    f32 (``m = -inf``, ``l = 0`` when empty); the merge takes the max over
    the chunks and sums the rescaled states in chunk order."""
    B, H, hd = q.shape
    ps, KV = k_pages.shape[1], k_pages.shape[2]
    P = block_tables.shape[1]
    S = P * ps
    self_mode = k_self is not None
    k = gather_pages(k_pages, block_tables).float()        # [B, S, KV, hd]
    v = gather_pages(v_pages, block_tables).float()
    seq = seq_lens.long()[:, None]
    pos = torch.arange(S, device=q.device)[None, :]
    lo = (seq - window + 1).clamp(min=0)
    hi = (seq - 1 if self_mode else seq).clamp(max=S - 1)
    valid = (pos >= lo) & (pos <= hi)                       # [B, S]
    t = pos - lo
    if self_mode:
        k = torch.cat([k, k_self[:, None].float()], dim=1)
        v = torch.cat([v, v_self[:, None].float()], dim=1)
        n_cache = (hi - lo + 1).clamp(min=0)
        valid = torch.cat([valid, torch.full_like(n_cache, window > 0,
                                                  dtype=torch.bool)], dim=1)
        t = torch.cat([t, n_cache], dim=1)
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, KV, H // KV, hd) * scale
    s = torch.einsum("bkgd,bskd->bkgs", qg, k)              # [B, KV, G, S']
    span = max(1, min(window, S) + 1)
    m_all, l_all, acc_all = [], [], []
    for split in range(-(-span // chunk)):
        mask = (valid & (t // chunk == split))[:, None, None, :]
        sm = torch.where(mask, s, -math.inf)
        m = sm.amax(dim=-1, keepdim=True)                   # [B, KV, G, 1]
        p = torch.where(mask, torch.exp(sm - m), 0.0)
        m_all.append(m)
        l_all.append(p.sum(dim=-1, keepdim=True))
        acc_all.append(torch.einsum("bkgs,bskd->bkgd", p, v))
    mx = torch.stack(m_all).amax(dim=0)
    den = torch.zeros_like(l_all[0])
    num = torch.zeros_like(acc_all[0])
    for m, l, acc in zip(m_all, l_all, acc_all):
        f = torch.where(l > 0, torch.exp(m - mx), 0.0)
        den = den + l * f
        num = num + acc * f
    out = (num / den.clamp(min=1e-30)).reshape(B, H, hd)
    if active is not None:
        out = torch.where(active[:, None, None], out, 0.0)
    return out.to(q.dtype)
