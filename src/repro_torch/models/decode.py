"""Single-token decode over the paged KV cache (port of the attention-family
branch of :mod:`repro.models.decode`).

Each layer reads its page-mapped KV through the block tables -- the only
data-path read of allocator-managed storage -- with its own window
(:func:`repro_torch.models.transformer.layer_windows`), and the step
returns the new token's K/V for every layer, which
``paged_kv.decode_append`` then writes with ONE support-core burst.  The
read is :func:`repro_torch.kernels.paged_attention.ops
.paged_decode_attention_op` in its self mode: on the card the paged
kernel reads the layer's pages in place; on the CPU the plain version
gathers them and runs ``mea_attention``, as the JAX decode does.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..core.paged_kv import PagedKVState
from ..kernels.paged_attention.ops import paged_decode_attention_op
from .layers import apply_rope, mlp_apply, out_project, rmsnorm
from .transformer import DenseLM, layer_windows


def decode_hidden(
    params: DenseLM,
    cfg: ArchConfig,
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
    for li, (lp, window) in enumerate(zip(params.layers, layer_windows(cfg))):
        h = rmsnorm(lp.ln_attn, x)
        q = (h @ lp.wq).reshape(B, cfg.num_heads, hd)
        k = (h @ lp.wk).reshape(B, cfg.num_kv_heads, hd)
        v = (h @ lp.wv).reshape(B, cfg.num_kv_heads, hd)
        q = apply_rope(q[:, None], positions[:, None], cfg.rope_theta)[:, 0]
        k = apply_rope(k[:, None], positions[:, None], cfg.rope_theta)[:, 0]
        attn = paged_decode_attention_op(
            q, paged.k_pages[:, li], paged.v_pages[:, li], paged.block_tables,
            paged.seq_lens, window, k_self=k, v_self=v, active=paged.active)
        x = x + out_project(lp.wo, attn[:, None])[:, 0]
        x = x + mlp_apply(lp.w_in, lp.w_out, rmsnorm(lp.ln_mlp, x), cfg.act)
        ks.append(k)
        vs.append(v)
    return x, (torch.stack(ks, dim=1), torch.stack(vs, dim=1))


def decode_logits(params: DenseLM, hidden: torch.Tensor) -> torch.Tensor:
    return params.logits(hidden)
