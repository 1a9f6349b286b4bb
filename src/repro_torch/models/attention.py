"""Attention in plain PyTorch (port of :mod:`repro.models.attention`).

``mea_attention`` scans KV in chunks with a running (max, denominator,
accumulator) carry in f32, GQA grouped without repeating KV heads -- the
same arithmetic as the JAX function, so the two agree to f32 rounding.  It
is the CPU path of prefill and decode; on the card those go through the
hand-written kernels of :mod:`repro_torch.kernels`.  ``naive_attention``
is the O(Tq * Tk) oracle behind the flash kernel's plain version.  Neither
is ``scaled_dot_product_attention``: the port calls no library attention.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
FULL_WINDOW = 1 << 30   # "no window" sentinel


def _mask_chunk(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """Boolean ``[Tq, ck]`` mask: True = attend."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def mea_attention(
    q: torch.Tensor,            # [B, Tq, H, hd]
    k: torch.Tensor,            # [B, Tk, KV, hd]
    v: torch.Tensor,            # [B, Tk, KV, hd]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,                          # absolute position of q[0]
    kv_valid: Optional[torch.Tensor] = None,   # [B, Tk] bool
    chunk: int = 512,
) -> torch.Tensor:
    """Chunked online-softmax attention; returns ``[B, Tq, H, hd]``.  Query
    row i sits at absolute position ``q_offset + i``, key j at ``j``."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    chunk = min(chunk, Tk)
    n_chunks = (Tk + chunk - 1) // chunk
    if kv_valid is None:
        kv_valid = torch.ones((B, Tk), dtype=torch.bool, device=dev)
    pad = n_chunks * chunk - Tk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_valid = torch.nn.functional.pad(kv_valid, (0, pad))

    qg = q.reshape(B, Tq, KV, G, hd).float() * scale
    q_pos = q_offset + torch.arange(Tq, dtype=torch.int32, device=dev)
    m_run = torch.full((B, Tq, KV, G), NEG_INF, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((B, Tq, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Tq, KV, G, hd), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        kch, vch = k[:, sl].float(), v[:, sl].float()
        k_pos = torch.arange(ci * chunk, (ci + 1) * chunk, dtype=torch.int32,
                             device=dev)
        s = torch.einsum("btkgd,bckd->btkgc", qg, kch)
        mask = _mask_chunk(q_pos, k_pos, causal, window)
        mask = mask[None, :, None, None, :] & kv_valid[:, sl][:, None, None,
                                                              None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("btkgc,bckd->btkgd", p,
                                                    vch)
        m_run = m_new
    out = acc / l_run.clamp(min=1e-30)[..., None]
    return out.reshape(B, Tq, H, hd).to(q.dtype)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """O(Tq * Tk) oracle; ``[B, Tq, H, hd]``, query row i at absolute
    position ``q_offset + i``.  Rows with no valid key give zeros."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Tq, KV, G, hd).float()
    s = torch.einsum("btkgd,bskd->btkgs", qg, k.float()) * scale
    q_pos = q_offset + torch.arange(Tq, dtype=torch.int32, device=dev)
    k_pos = torch.arange(Tk, dtype=torch.int32, device=dev)
    mask = _mask_chunk(q_pos, k_pos, causal, window)[None, :, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("btkgs,bskd->btkgd", p, v.float())
    return out.reshape(B, Tq, H, hd).to(q.dtype)


def decode_attention(
    q: torch.Tensor,            # [B, H, hd], one new token a lane
    k: torch.Tensor,            # [B, S, KV, hd], the gathered cache
    v: torch.Tensor,            # [B, S, KV, hd]
    kv_valid: torch.Tensor,     # [B, S] bool
    *,
    window: Optional[int] = None,
    seq_lens: Optional[torch.Tensor] = None,  # [B], for the window mask
    chunk: int = 2048,
) -> torch.Tensor:
    """Single-token attention over a masked cache; returns ``[B, H, hd]``."""
    if window is not None and seq_lens is not None:
        pos = torch.arange(k.shape[1], dtype=torch.int32,
                           device=k.device)[None, :]
        kv_valid = kv_valid & (pos > seq_lens[:, None] - 1 - window)
    out = mea_attention(q[:, None], k, v, causal=False, window=None,
                        kv_valid=kv_valid, chunk=chunk)
    return out[:, 0]
