"""Single-token decode over the paged KV cache (port of
:mod:`repro.models.decode`, every family the port serves).

Each attention layer reads its page-mapped KV through the block tables --
the only data-path read of allocator-managed storage -- with its own
window (:func:`repro_torch.models.transformer.layer_windows`), and the
step returns the new token's K/V for every KV layer, which
``paged_kv.decode_append`` then writes with ONE support-core burst.  The
read is :func:`repro_torch.kernels.paged_attention.ops
.paged_decode_attention_op` in its self mode: on the card the paged
kernel reads the layer's pages in place; on the CPU the plain version
gathers them and runs ``mea_attention``, as the JAX decode does.  The
moe family routes every lane's row, inactive lanes' too, through its MoE
layer as one dispatch group (capacity over ``max_lanes`` tokens), as the
JAX decode does.  On a split cache (``PagedKVState.win``) each windowed
layer reads its window tenant's pool and tables, each global layer
``kv_pages``, and the step returns the global layers' K/V first; a
global layer of a YaRN config rotates with YaRN
(:func:`~repro_torch.models.transformer.layer_yarns`).

The hybrid family (zamba2) runs a Mamba2 step on every layer, carrying
the lanes' :class:`RecurrentState`, and the shared attention block on the
flagged layers only, each application reading and returning its own KV
layer (:func:`~repro_torch.models.transformer.hybrid_kv_slots`).

The ssm family (rwkv6) is attention-free: every layer runs the RWKV6
time- and channel-mix steps on the lanes' state (``ssm`` is then the wkv
state, ``tm_prev``/``cm_prev`` each mix's last input) and the step
returns no K/V.  The audio family (whisper) adds the learned decoder
position of each lane's token, reads its own K/V through the paged
kernel as the dense family does, with no RoPE, and after every layer
attends over the lane's encoder output (``enc_out``), projecting its
cross K/V anew every step, as the JAX decode does; that attention is the
flash kernel (one query, causal off) on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..configs.base import ArchConfig
from ..core.paged_kv import PagedKVState
from ..kernels.paged_attention.ops import paged_decode_attention_op
from . import mamba2 as m2
from . import rwkv6 as rw
from .attention import FULL_WINDOW, mea_attention
from .layers import apply_norm, apply_rope, embed, out_project, qkv_project
from .transformer import (AttnBlock, cross_residual, hybrid_attn_flags,
                          hybrid_kv_slots, layer_windows, layer_yarns,
                          mlp_residual)


class RecurrentState(NamedTuple):
    """The lanes' per-layer recurrent state (hybrid and ssm families)."""

    ssm: torch.Tensor      # hybrid [L, B, h, n, hd] | rwkv6 [L, B, H, hd, hd] f32
    conv: Optional[torch.Tensor] = None     # hybrid [L, B, K-1, conv_dim]
    tm_prev: Optional[torch.Tensor] = None  # rwkv6 [L, B, 1, d]
    cm_prev: Optional[torch.Tensor] = None  # rwkv6 [L, B, 1, d]


def init_recurrent_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                         device: torch.device) -> Optional[RecurrentState]:
    """Zero state for ``batch`` lanes (f32 ``ssm``, the rest in
    ``dtype``); ``None`` for attention families."""
    L = cfg.num_layers
    if cfg.family == "hybrid":
        st = m2.init_decode_state(
            m2.make_spec(cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim),
            batch, dtype, device)
        return RecurrentState(ssm=torch.stack([st.ssm] * L),
                              conv=torch.stack([st.conv] * L))
    if cfg.family == "ssm":
        st = rw.init_decode_state(
            rw.RWKV6Spec(cfg.d_model, cfg.d_ff, cfg.resolved_head_dim),
            batch, dtype, device)
        return RecurrentState(ssm=torch.stack([st.wkv] * L),
                              tm_prev=torch.stack([st.tm_prev] * L),
                              cm_prev=torch.stack([st.cm_prev] * L))
    return None


def paged_decode_attention(
    q: torch.Tensor,          # [B, H, hd] new token queries
    k_gath: torch.Tensor,     # [B, S, KV, hd] gathered pages
    v_gath: torch.Tensor,
    k_new: torch.Tensor,      # [B, KV, hd] this token's K (not yet in cache)
    v_new: torch.Tensor,
    seq_lens: torch.Tensor,   # [B] tokens already in cache
    active: torch.Tensor,     # [B] bool
    window: int,              # FULL_WINDOW = none
    pos: Optional[torch.Tensor] = None,             # [B, S] (default arange)
    gathered_valid: Optional[torch.Tensor] = None,  # [B, S] (windowed gather)
) -> torch.Tensor:
    """Attention of each lane's new token over its cached slots
    ``pos < seq_len`` plus an appended self column at ``pos == seq_len``;
    inactive lanes give zeros.  The paged kernel's plain version in its
    self mode, on the gathered pages."""
    B, S = k_gath.shape[:2]
    dev = q.device
    k = torch.cat([k_gath, k_new[:, None]], dim=1)
    v = torch.cat([v_gath, v_new[:, None]], dim=1)
    if pos is None:
        pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    pos = torch.cat([pos, seq_lens[:, None]], dim=1)              # [B, S+1]
    is_self = torch.arange(S + 1, device=dev) == S
    valid = torch.where(is_self[None, :], True, pos < seq_lens[:, None])
    if gathered_valid is not None:
        valid = valid & torch.cat(
            [gathered_valid, torch.ones((B, 1), dtype=torch.bool,
                                        device=dev)], dim=1)
    valid = valid & (pos > seq_lens[:, None] - window)
    valid = valid & active[:, None]
    out = mea_attention(q[:, None], k, v, causal=False, window=None,
                        kv_valid=valid, chunk=2048)
    return out[:, 0]


def _attn_layer_step(cfg: ArchConfig, lp: AttnBlock, x: torch.Tensor,
                     paged: PagedKVState, kv_layer: int, window: int,
                     yarn=None, in_window_pool: bool = False):
    """One attention block for one new token per lane; returns ``(x, k,
    v)`` with the token's K/V ``[B, KV, hd]``.  ``kv_layer`` indexes the
    pool the layer reads: ``kv_pages``, or with ``in_window_pool`` the
    split cache's window tenant."""
    hd = cfg.resolved_head_dim
    positions = paged.seq_lens
    h = apply_norm(cfg.norm, lp.ln_attn, x)
    q, k, v = qkv_project(lp.wq, lp.wk, lp.wv, h, cfg.num_heads,
                          cfg.num_kv_heads, hd, lp.bq, lp.bk, lp.bv)
    if cfg.family != "audio":
        q = apply_rope(q[:, None], positions[:, None], cfg.rope_theta,
                       yarn)[:, 0]
        k = apply_rope(k[:, None], positions[:, None], cfg.rope_theta,
                       yarn)[:, 0]
    pool = paged.win if in_window_pool else paged
    attn = paged_decode_attention_op(
        q, pool.k_pages[:, kv_layer], pool.v_pages[:, kv_layer],
        pool.block_tables, paged.seq_lens, window, k_self=k, v_self=v,
        active=paged.active)
    x = x + out_project(lp.wo, attn[:, None])[:, 0]
    return mlp_residual(cfg, lp, x), k, v


def _rwkv6_step(params, x: torch.Tensor, rec: RecurrentState):
    wkvs, tms, cms = [], [], []
    for li, layer in enumerate(params.layers):
        y, wkv, tm = rw.rwkv6_time_mix_step(
            layer.tm, params.spec, apply_norm("layernorm", layer.ln1, x),
            rw.RWKV6DecodeState(wkv=rec.ssm[li], tm_prev=rec.tm_prev[li],
                                cm_prev=rec.cm_prev[li]))
        x = x + y
        y, cm = rw.rwkv6_channel_mix_step(
            layer.cm, apply_norm("layernorm", layer.ln2, x), rec.cm_prev[li])
        x = x + y
        wkvs.append(wkv)
        tms.append(tm)
        cms.append(cm)
    return x, RecurrentState(ssm=torch.stack(wkvs), tm_prev=torch.stack(tms),
                             cm_prev=torch.stack(cms))


def decode_hidden(params, cfg: ArchConfig, paged: PagedKVState,
                  tokens: torch.Tensor,             # [B] int32
                  rec: Optional[RecurrentState] = None,
                  enc_out: Optional[torch.Tensor] = None, hints=None):
    """Run the layer stack for one token per lane.

    Returns ``(hidden [B, d], (new_k, new_v) or None, new_rec)`` with K/V
    ``[B, L_kv, KV, hd]`` (``None`` for the attention-free ssm family; on
    a split cache the global layers first, then the windowed ones);
    ``new_rec`` is ``None`` for attention families.  The audio family
    reads ``enc_out [B, F, d]``.  ``hints`` puts the embedded lanes over
    the data axes (the gathered KV's hint is the paged read's, ambient).
    """
    x = embed(params.embed, tokens)
    if hints is not None:
        x = hints.lanes(x)
    if cfg.family == "ssm":
        x, new_rec = _rwkv6_step(params, x, rec)
        return x, None, new_rec
    ks, vs = [], []
    if cfg.family == "hybrid":
        ssms, convs = [], []
        for li, (layer, flag, slot) in enumerate(zip(
                params.layers, hybrid_attn_flags(cfg), hybrid_kv_slots(cfg))):
            y, st = m2.mamba2_decode_step(
                layer.mamba, params.spec, apply_norm(cfg.norm, layer.ln, x),
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
        if cfg.family == "audio":
            x = x + params.dec_pos[paged.seq_lens.long()].to(x.dtype)
        split = paged.win is not None
        wks, wvs = [], []
        for li, (lp, window, yarn) in enumerate(zip(
                params.layers, layer_windows(cfg), layer_yarns(cfg))):
            windowed = split and window != FULL_WINDOW
            slot = len(wks) if windowed else len(ks)
            x, k, v = _attn_layer_step(cfg, lp, x, paged, slot if split
                                       else li, window, yarn, windowed)
            if cfg.family == "audio":
                x = cross_residual(cfg, params.cross_layers[li], x[:, None],
                                   enc_out)[:, 0]
            (wks if windowed else ks).append(k)
            (wvs if windowed else vs).append(v)
        ks, vs = ks + wks, vs + wvs
        new_rec = None
    return x, (torch.stack(ks, dim=1), torch.stack(vs, dim=1)), new_rec


def decode_logits(params, hidden: torch.Tensor) -> torch.Tensor:
    return params.logits(hidden)
