"""Single-token decode over the paged KV cache (port of the attention-family
branch of :mod:`repro.models.decode`).

Each layer reads its page-mapped KV through the block tables -- the only
data-path read of allocator-managed storage -- and the step returns the
new token's K/V for every layer, which ``paged_kv.decode_append`` then
writes with ONE support-core burst.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..core.paged_kv import PagedKVConfig, PagedKVState, gather_kv
from .attention import mea_attention
from .layers import apply_rope, mlp_apply, out_project, rmsnorm
from .transformer import FULL_WINDOW, DenseLM


def paged_decode_attention(
    q: torch.Tensor,          # [B, H, hd] new token queries
    k_gath: torch.Tensor,     # [B, S, KV, hd] gathered pages
    v_gath: torch.Tensor,
    k_new: torch.Tensor,      # [B, KV, hd] this token's K (not yet in cache)
    v_new: torch.Tensor,
    seq_lens: torch.Tensor,   # [B] tokens already in cache
    active: torch.Tensor,     # [B] bool
    window: int,
) -> torch.Tensor:
    """Attention of each lane's new token over its cached slots
    ``pos < seq_len`` plus an appended self column at ``pos == seq_len``."""
    B, S = k_gath.shape[:2]
    dev = q.device
    k = torch.cat([k_gath, k_new[:, None]], dim=1)
    v = torch.cat([v_gath, v_new[:, None]], dim=1)
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    pos = torch.cat([pos, seq_lens[:, None]], dim=1)              # [B, S+1]
    is_self = torch.arange(S + 1, device=dev) == S
    valid = torch.where(is_self[None, :], True, pos < seq_lens[:, None])
    valid = valid & (pos > seq_lens[:, None] - window)
    valid = valid & active[:, None]
    out = mea_attention(q[:, None], k, v, causal=False, window=None,
                        kv_valid=valid, chunk=2048)
    return out[:, 0]


def decode_hidden(
    params: DenseLM,
    cfg: ArchConfig,
    kvcfg: PagedKVConfig,
    paged: PagedKVState,
    tokens: torch.Tensor,               # [B] int32
):
    """Run the layer stack for one token per lane.

    Returns ``(hidden [B, d], (new_k, new_v))`` with K/V ``[B, L, KV, hd]``.
    """
    hd = cfg.resolved_head_dim
    x = params.embed[tokens.long()]
    positions = paged.seq_lens
    B = x.shape[0]
    ks, vs = [], []
    for li, lp in enumerate(params.layers):
        h = rmsnorm(lp.ln_attn, x)
        q = (h @ lp.wq).reshape(B, cfg.num_heads, hd)
        k = (h @ lp.wk).reshape(B, cfg.num_kv_heads, hd)
        v = (h @ lp.wv).reshape(B, cfg.num_kv_heads, hd)
        q = apply_rope(q[:, None], positions[:, None], cfg.rope_theta)[:, 0]
        k = apply_rope(k[:, None], positions[:, None], cfg.rope_theta)[:, 0]
        k_gath, v_gath, _ = gather_kv(kvcfg, paged, li)
        attn = paged_decode_attention(q, k_gath, v_gath, k, v, paged.seq_lens,
                                      paged.active, FULL_WINDOW)
        x = x + out_project(lp.wo, attn[:, None])[:, 0]
        x = x + mlp_apply(lp.w_in, lp.w_out, rmsnorm(lp.ln_mlp, x))
        ks.append(k)
        vs.append(v)
    return x, (torch.stack(ks, dim=1), torch.stack(vs, dim=1))


def decode_logits(params: DenseLM, hidden: torch.Tensor) -> torch.Tensor:
    return params.logits(hidden)
