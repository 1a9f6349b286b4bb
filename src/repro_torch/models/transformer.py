"""Dense LM backbone as an ``nn.Module`` (port of the dense family of
:mod:`repro.models.transformer`).

Parameters keep the JAX tree's names and layouts, one :class:`AttnBlock`
per layer (the JAX package stacks them for ``scan``):

    embed [V, d]   final_norm [d]   unembed [d, V]
    layers[i]: ln_attn [d], wq [d, H*hd], wk/wv [d, KV*hd], wo [H*hd, d],
               ln_mlp [d], w_in [d, 2*ff], w_out [ff, d]

Serving holds the parameters without gradients.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attention_op
from .attention import FULL_WINDOW, mea_attention
from .layers import (apply_rope, dense_init, init_embedding, mlp_apply,
                     out_project, qkv_project, rmsnorm)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def layer_windows(cfg: ArchConfig) -> list[int]:
    """Attention window of each layer (``FULL_WINDOW`` = none).  Under
    ``local_global`` every ``local_per_global + 1``-th layer is global and
    the others see ``cfg.window`` tokens (gemma3's 5:1 pattern)."""
    n = cfg.num_attn_layers
    if cfg.attn_pattern == "full":
        return [FULL_WINDOW] * n
    if cfg.attn_pattern == "local_global":
        period = cfg.local_per_global + 1
        return [FULL_WINDOW if i % period == cfg.local_per_global
                else cfg.window for i in range(n)]
    raise NotImplementedError(
        f"attention pattern {cfg.attn_pattern!r} waits for a later slice "
        f"(ROADMAP.md, Queue 1)")


class AttnBlock(nn.Module):
    """Pre-norm attention + gated MLP block."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator]):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        H, KV, ff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff

        def w(shape):
            if gen is None:
                return _param(torch.empty(shape, dtype=dtype, device=device))
            return _param(dense_init(shape, dtype, device, gen))

        self.ln_attn = _param(torch.zeros((d,), dtype=dtype, device=device))
        self.wq = w((d, H * hd))
        self.wk = w((d, KV * hd))
        self.wv = w((d, KV * hd))
        self.wo = w((H * hd, d))
        self.ln_mlp = _param(torch.zeros((d,), dtype=dtype, device=device))
        self.w_in = w((d, 2 * ff))
        self.w_out = w((ff, d))


class DenseLM(nn.Module):
    """The dense decoder LM.  ``gen=None`` leaves the weights uninitialized
    for a caller that loads them (:func:`repro_torch.models.model_zoo
    .params_from_numpy`)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != "dense" \
                or cfg.attn_pattern not in ("full", "local_global") \
                or cfg.qkv_bias or cfg.act not in ("swiglu", "geglu") \
                or cfg.norm != "rmsnorm":
            raise NotImplementedError(
                f"repro_torch serves the dense RMSNorm family with full or "
                f"local:global attention and a gated MLP so far; "
                f"{cfg.name!r} needs a later slice (ROADMAP.md, Queue 1)")
        self.cfg = cfg
        d, V = cfg.d_model, cfg.vocab_size
        if gen is None:
            self.embed = _param(torch.empty((V, d), dtype=dtype, device=device))
        else:
            self.embed = _param(init_embedding(V, d, dtype, device, gen))
        self.final_norm = _param(torch.zeros((d,), dtype=dtype, device=device))
        if not cfg.tie_embeddings:
            self.unembed = _param(
                torch.empty((d, V), dtype=dtype, device=device) if gen is None
                else dense_init((d, V), dtype, device, gen))
        self.layers = nn.ModuleList(
            AttnBlock(cfg, dtype, device, gen) for _ in range(cfg.num_layers))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + vocab projection."""
        x = rmsnorm(self.final_norm, x)
        if self.cfg.tie_embeddings:
            return x @ self.embed.T
        return x @ self.unembed

    def forward(self, tokens: torch.Tensor, return_kv: bool = False,
                prefix_kv=None, pos_offset: int = 0):
        """Full-sequence logits ``[B, S, V]``; with ``return_kv`` also the
        per-layer ``(k, v)``, each ``[num_layers, B, S, KV, hd]``.

        ``prefix_kv`` = (pk, pv), each ``[num_layers, B, P, KV, hd]``: cached
        K/V of absolute positions ``[0, P)`` (roped there when written),
        with ``pos_offset == P``.  ``tokens`` then continue the sequence
        from position P, and logits and K/V come back for them alone (the
        prefix cache's prefill skip)."""
        x = self.embed[tokens.long()]
        ks, vs = [], []
        for li, (lp, window) in enumerate(zip(self.layers,
                                              layer_windows(self.cfg))):
            pkv = None if prefix_kv is None \
                else (prefix_kv[0][li], prefix_kv[1][li])
            x, (k, v) = _attn_block_seq(self.cfg, lp, x, window,
                                        q_offset=pos_offset, prefix_kv=pkv)
            if return_kv:
                ks.append(k)
                vs.append(v)
        logits = self.logits(x)
        if return_kv:
            return logits, (torch.stack(ks), torch.stack(vs))
        return logits


def _attn_block_seq(cfg: ArchConfig, lp: AttnBlock, x: torch.Tensor,
                    window: int, q_offset: int = 0, prefix_kv=None):
    """One block over a full sequence; returns ``(x, (k, v))``.

    The sequence sits at absolute positions ``[q_offset, q_offset + T)``
    (RoPE is applied there); ``prefix_kv`` = (pk, pv), each ``[B, P, KV,
    hd]``, holds the cached keys of positions ``[0, P)`` with ``P ==
    q_offset``, which the queries attend over before their own.  The
    returned ``(k, v)`` cover the sequence alone.

    Causal attention goes through the flash kernel for CUDA tensors and
    through ``mea_attention`` -- the JAX prefill's own arithmetic, which
    keeps the CPU path within f32 rounding of the JAX package -- for CPU
    tensors."""
    hd = cfg.resolved_head_dim
    h = rmsnorm(lp.ln_attn, x)
    q, k, v = qkv_project(lp.wq, lp.wk, lp.wv, h, cfg.num_heads,
                          cfg.num_kv_heads, hd)
    positions = q_offset + torch.arange(x.shape[1], dtype=torch.int32,
                                        device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if prefix_kv is not None:
        k_all = torch.cat([prefix_kv[0].to(k.dtype), k], dim=1)
        v_all = torch.cat([prefix_kv[1].to(v.dtype), v], dim=1)
    else:
        k_all, v_all = k, v
    if x.device.type == "cuda":
        attn = flash_attention_op(q, k_all, v_all, causal=True, window=window,
                                  q_offset=q_offset)
    else:
        attn = mea_attention(q, k_all, v_all, causal=True, window=window,
                             q_offset=q_offset)
    x = x + out_project(lp.wo, attn)
    h = rmsnorm(lp.ln_mlp, x)
    return x + mlp_apply(lp.w_in, lp.w_out, h, cfg.act), (k, v)


def init_lm_params(cfg: ArchConfig, gen: torch.Generator,
                   dtype: torch.dtype = torch.bfloat16,
                   device: torch.device | str = "cpu") -> DenseLM:
    """A :class:`DenseLM` with weights drawn from ``gen`` on ``device``."""
    return DenseLM(cfg, dtype, torch.device(device), gen)


def forward(params: DenseLM, tokens: torch.Tensor, return_kv: bool = False,
            prefix_kv=None, pos_offset: int = 0):
    """Full-sequence logits (and per-layer K/V with ``return_kv``); see
    :meth:`DenseLM.forward` for the cached prefix."""
    return params(tokens, return_kv=return_kv, prefix_kv=prefix_kv,
                  pos_offset=pos_offset)
