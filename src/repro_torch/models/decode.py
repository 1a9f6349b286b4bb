"""Single-token decode over the paged KV cache (port of the dense and
hybrid branches of :mod:`repro.models.decode`).

Each attention layer reads its page-mapped KV through the block tables --
the only data-path read of allocator-managed storage -- with its own
window (:func:`repro_torch.models.transformer.layer_windows`), and the
step returns the new token's K/V for every KV layer, which
``paged_kv.decode_append`` then writes with ONE support-core burst.  The
read is :func:`repro_torch.kernels.paged_attention.ops
.paged_decode_attention_op` in its self mode: on the card the paged
kernel reads the layer's pages in place; on the CPU the plain version
gathers them and runs ``mea_attention``, as the JAX decode does.

The hybrid family (zamba2) runs a Mamba2 step on every layer, carrying
the lanes' :class:`RecurrentState`, and the shared attention block on the
flagged layers only, each application reading and returning its own KV
layer (:func:`~repro_torch.models.transformer.hybrid_kv_slots`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..configs.base import ArchConfig
from ..core.paged_kv import PagedKVState
from ..kernels.paged_attention.ops import paged_decode_attention_op
from . import mamba2 as m2
from .attention import FULL_WINDOW
from .layers import apply_rope, mlp_apply, out_project, qkv_project, rmsnorm
from .transformer import (AttnBlock, hybrid_attn_flags, hybrid_kv_slots,
                          layer_windows)


class RecurrentState(NamedTuple):
    """The lanes' per-layer recurrent state (hybrid family)."""

    ssm: torch.Tensor      # [L, B, h, n, hd] f32
    conv: torch.Tensor     # [L, B, K-1, conv_dim] model dtype


def init_recurrent_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                         device: torch.device) -> Optional[RecurrentState]:
    """Zero state for ``batch`` lanes; ``None`` for attention families."""
    if cfg.family != "hybrid":
        return None
    spec = m2.make_spec(cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim)
    L = cfg.num_layers
    return RecurrentState(
        ssm=torch.zeros((L, batch, spec.heads, spec.n_state, spec.head_dim),
                        dtype=torch.float32, device=device),
        conv=torch.zeros((L, batch, m2.CONV_K - 1, spec.conv_dim),
                         dtype=dtype, device=device))


def _attn_layer_step(cfg: ArchConfig, lp: AttnBlock, x: torch.Tensor,
                     paged: PagedKVState, kv_layer: int, window: int):
    """One attention block for one new token per lane; returns ``(x, k,
    v)`` with the token's K/V ``[B, KV, hd]``."""
    hd = cfg.resolved_head_dim
    positions = paged.seq_lens
    h = rmsnorm(lp.ln_attn, x)
    q, k, v = qkv_project(lp.wq, lp.wk, lp.wv, h, cfg.num_heads,
                          cfg.num_kv_heads, hd, lp.bq, lp.bk, lp.bv)
    q = apply_rope(q[:, None], positions[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], positions[:, None], cfg.rope_theta)[:, 0]
    attn = paged_decode_attention_op(
        q, paged.k_pages[:, kv_layer], paged.v_pages[:, kv_layer],
        paged.block_tables, paged.seq_lens, window, k_self=k, v_self=v,
        active=paged.active)
    x = x + out_project(lp.wo, attn[:, None])[:, 0]
    x = x + mlp_apply(lp.w_in, lp.w_out, rmsnorm(lp.ln_mlp, x), cfg.act)
    return x, k, v


def decode_hidden(params, cfg: ArchConfig, paged: PagedKVState,
                  tokens: torch.Tensor,             # [B] int32
                  rec: Optional[RecurrentState] = None):
    """Run the layer stack for one token per lane.

    Returns ``(hidden [B, d], (new_k, new_v), new_rec)`` with K/V ``[B,
    L_kv, KV, hd]``; ``new_rec`` is ``None`` for attention families.
    """
    x = params.embed[tokens.long()]
    ks, vs = [], []
    if cfg.family == "hybrid":
        ssms, convs = [], []
        for li, (layer, flag, slot) in enumerate(zip(
                params.layers, hybrid_attn_flags(cfg), hybrid_kv_slots(cfg))):
            y, st = m2.mamba2_decode_step(
                layer.mamba, params.spec, rmsnorm(layer.ln, x),
                m2.Mamba2DecodeState(conv=rec.conv[li], ssm=rec.ssm[li]))
            x = x + y
            ssms.append(st.ssm)
            convs.append(st.conv)
            if flag:
                x, k, v = _attn_layer_step(cfg, params.shared_attn, x, paged,
                                           slot, FULL_WINDOW)
                ks.append(k)
                vs.append(v)
        new_rec = RecurrentState(ssm=torch.stack(ssms),
                                 conv=torch.stack(convs))
    else:
        for li, (lp, window) in enumerate(zip(params.layers,
                                              layer_windows(cfg))):
            x, k, v = _attn_layer_step(cfg, lp, x, paged, li, window)
            ks.append(k)
            vs.append(v)
        new_rec = None
    return x, (torch.stack(ks, dim=1), torch.stack(vs, dim=1)), new_rec


def decode_logits(params, hidden: torch.Tensor) -> torch.Tensor:
    return params.logits(hidden)
