"""LM backbones as ``nn.Module``s (port of the dense and hybrid families of
:mod:`repro.models.transformer`).

Parameters keep the JAX tree's names and layouts, one module per layer
(the JAX package stacks them for ``scan``):

    embed [V, d]   final_norm [d]   unembed [d, V]
    AttnBlock: ln_attn [d], wq [d, H*hd], wk/wv [d, KV*hd], wo [H*hd, d],
               (with ``qkv_bias``) bq [H*hd], bk/bv [KV*hd],
               ln_mlp [d], w_in [d, 2*ff], w_out [ff, d]

:class:`DenseLM` has one :class:`AttnBlock` per layer; it also serves the
vlm family (phi-3-vision), whose forward takes the patch embeddings as a
prefix of rows ahead of the tokens' (``prefix_embeds``).  :class:`HybridLM`
(zamba2) has one :class:`HybridLayer` (``ln`` and a
:class:`~repro_torch.models.mamba2.Mamba2`) per layer and ONE
``shared_attn`` block, applied after every ``attn_every``-th layer with
the same weights each time; each application is one KV layer of the paged
cache (:func:`hybrid_kv_slots`).

Serving holds the parameters without gradients.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attention_op
from . import mamba2 as m2
from .attention import FULL_WINDOW, mea_attention
from .layers import (apply_rope, bias_init, dense_init, init_embedding,
                     mlp_apply, out_project, qkv_project, rmsnorm)


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
    """Pre-norm attention + gated MLP block.  Without ``cfg.qkv_bias`` the
    biases ``bq``/``bk``/``bv`` are ``None``."""

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
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            self.register_parameter(name, None if not cfg.qkv_bias else _param(
                torch.empty((n,), dtype=dtype, device=device) if gen is None
                else bias_init(n, d, dtype, device, gen)))
        self.wo = w((H * hd, d))
        self.ln_mlp = _param(torch.zeros((d,), dtype=dtype, device=device))
        self.w_in = w((d, 2 * ff))
        self.w_out = w((ff, d))


class _LM(nn.Module):
    """Embedding, final norm and vocab projection, shared by the families."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator]):
        super().__init__()
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

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + vocab projection."""
        x = rmsnorm(self.final_norm, x)
        if self.cfg.tie_embeddings:
            return x @ self.embed.T
        return x @ self.unembed


def _check_attention(cfg: ArchConfig, families: tuple, patterns: tuple
                     ) -> None:
    if cfg.family not in families or cfg.attn_pattern not in patterns \
            or cfg.act not in ("swiglu", "geglu") or cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"repro_torch serves the dense and vlm RMSNorm families with "
            f"full or local:global attention and the hybrid family with full "
            f"attention, each with a gated MLP, so far; sliding-window "
            f"attention, MoE, the ssm and audio families, LayerNorm and "
            f"plain GELU wait for later slices, so {cfg.name!r} does too "
            f"(ROADMAP.md, Queue 1)")


class DenseLM(_LM):
    """The dense decoder LM (also the vlm family's backbone).  ``gen=None``
    leaves the weights uninitialized for a caller that loads them
    (:func:`repro_torch.models.model_zoo.params_from_numpy`)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator] = None):
        _check_attention(cfg, ("dense", "vlm"), ("full", "local_global"))
        super().__init__(cfg, dtype, device, gen)
        self.layers = nn.ModuleList(
            AttnBlock(cfg, dtype, device, gen) for _ in range(cfg.num_layers))

    def forward(self, tokens: torch.Tensor, return_kv: bool = False,
                prefix_kv=None, pos_offset: int = 0, prefix_embeds=None):
        """Full-sequence logits ``[B, S, V]``; with ``return_kv`` also the
        per-layer ``(k, v)``, each ``[num_layers, B, S, KV, hd]``.

        ``prefix_embeds [B, P, d]`` (vlm): patch embeddings that take
        positions ``[0, P)`` ahead of the tokens; S then counts them too.

        ``prefix_kv`` = (pk, pv), each ``[num_layers, B, P, KV, hd]``: cached
        K/V of absolute positions ``[0, P)`` (roped there when written),
        with ``pos_offset == P``.  ``tokens`` then continue the sequence
        from position P, and logits and K/V come back for them alone (the
        prefix cache's prefill skip); not with ``prefix_embeds``, as in
        the JAX package."""
        if (prefix_kv is not None or pos_offset) and prefix_embeds is not None:
            raise ValueError("prefix_kv/pos_offset prefill-skip supports only "
                             "plain attention families without vlm/encoder "
                             f"prefixes (family={self.cfg.family!r})")
        x = self.embed[tokens.long()]
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
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


def hybrid_attn_flags(cfg: ArchConfig) -> list[bool]:
    """Whether the shared block runs after layer i: ``i % every ==
    every - 1``."""
    every = max(cfg.attn_every, 1)
    return [i % every == every - 1 for i in range(cfg.num_layers)]


def hybrid_kv_slots(cfg: ArchConfig) -> list[int]:
    """Layer i's KV layer in the paged cache, ``cumsum(flags) - flags``
    (meaningful on flagged layers only)."""
    slots, seen = [], 0
    for f in hybrid_attn_flags(cfg):
        slots.append(seen)
        seen += f
    return slots


class HybridLayer(nn.Module):
    """A pre-norm Mamba2 layer: ``ln`` and the block's parameters."""

    def __init__(self, cfg: ArchConfig, spec: m2.Mamba2Spec,
                 dtype: torch.dtype, device: torch.device,
                 gen: Optional[torch.Generator]):
        super().__init__()
        self.ln = _param(torch.zeros((cfg.d_model,), dtype=dtype,
                                     device=device))
        self.mamba = m2.Mamba2(spec, dtype, device, gen)


class HybridLM(_LM):
    """zamba2: stacked Mamba2 layers and ONE shared attention block, run
    after every ``attn_every``-th layer with the same weights."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator] = None):
        _check_attention(cfg, ("hybrid",), ("full",))
        super().__init__(cfg, dtype, device, gen)
        self.spec = m2.make_spec(cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim)
        self.layers = nn.ModuleList(
            HybridLayer(cfg, self.spec, dtype, device, gen)
            for _ in range(cfg.num_layers))
        self.shared_attn = AttnBlock(cfg, dtype, device, gen)

    def forward(self, tokens: torch.Tensor, return_kv: bool = False,
                prefix_kv=None, pos_offset: int = 0):
        """Full-sequence logits ``[B, S, V]``; with ``return_kv`` also the
        shared block's ``(k, v)`` of each application, each ``[L_kv, B, S,
        KV, hd]``.  A recurrent state has no prefix cache: ``prefix_kv``
        and ``pos_offset`` raise, as in the JAX package."""
        if prefix_kv is not None or pos_offset:
            raise ValueError("prefix_kv/pos_offset prefill-skip supports only "
                             "plain attention families (family='hybrid')")
        x, kv, _ = self._run(tokens)
        logits = self.logits(x)
        return (logits, kv) if return_kv else logits

    def prefill(self, tokens: torch.Tensor):
        """The serving prefill's outputs, without the vocab projection:
        ``(k, v)`` as :meth:`forward` gives them, and the per-layer
        ``(ssm [L, B, h, n, hd], conv [L, B, K-1, conv_dim])`` a decode
        continues from."""
        _, kv, states = self._run(tokens)
        return kv, states

    def _run(self, tokens: torch.Tensor):
        x = self.embed[tokens.long()]
        ks, vs, ssms, convs = [], [], [], []
        for layer, flag in zip(self.layers, hybrid_attn_flags(self.cfg)):
            y, ssm, conv = m2.mamba2_forward_with_state(
                layer.mamba, self.spec, rmsnorm(layer.ln, x))
            x = x + y
            ssms.append(ssm)
            convs.append(conv)
            if flag:
                x, (k, v) = _attn_block_seq(self.cfg, self.shared_attn, x,
                                            FULL_WINDOW)
                ks.append(k)
                vs.append(v)
        return (x, (torch.stack(ks), torch.stack(vs)),
                (torch.stack(ssms), torch.stack(convs)))


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
                          cfg.num_kv_heads, hd, lp.bq, lp.bk, lp.bv)
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


def lm_class(cfg: ArchConfig) -> type:
    """The module class of ``cfg``'s family."""
    return HybridLM if cfg.family == "hybrid" else DenseLM


def init_lm_params(cfg: ArchConfig, gen: torch.Generator,
                   dtype: torch.dtype = torch.bfloat16,
                   device: torch.device | str = "cpu") -> _LM:
    """The family's LM with weights drawn from ``gen`` on ``device``."""
    return lm_class(cfg)(cfg, dtype, torch.device(device), gen)


def forward(params: _LM, tokens: torch.Tensor, return_kv: bool = False,
            prefix_kv=None, pos_offset: int = 0, prefix_embeds=None):
    """Full-sequence logits (and per-layer K/V with ``return_kv``); see
    :meth:`DenseLM.forward` for the cached prefix and the vlm patch
    prefix (``prefix_embeds``, which the hybrid family does not take)."""
    extra = {} if prefix_embeds is None else {"prefix_embeds": prefix_embeds}
    return params(tokens, return_kv=return_kv, prefix_kv=prefix_kv,
                  pos_offset=pos_offset, **extra)
