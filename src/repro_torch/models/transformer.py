"""LM backbones as ``nn.Module``s (port of every family of
:mod:`repro.models.transformer`).

Parameters keep the JAX tree's names and layouts, one module per layer
(the JAX package stacks them for ``scan``):

    embed [V, d]   final_norm   unembed [d, V]
    AttnBlock: ln_attn, wq [d, H*hd], wk/wv [d, KV*hd], wo [H*hd, d],
               (with ``qkv_bias``) bq [H*hd], bk/bv [KV*hd],
               ln_mlp, w_in [d, 2*ff], w_out [ff, d]
               (plain GELU MLP: w_in [d, ff], b_in [ff], w_out, b_out [d])
               (moe family: moe.router [d, E] f32, moe.w_in [E, d, 2*ff],
               moe.w_out [E, ff, d] in place of the MLP)

A norm is an RMSNorm's scale ``[d]`` or a
:class:`~repro_torch.models.layers.LayerNorm` (``scale``, ``bias``), as
``cfg.norm`` says.

:class:`DenseLM` has one :class:`AttnBlock` per layer; it also serves the
vlm family (phi-3-vision), whose forward takes the patch embeddings as a
prefix of rows ahead of the tokens' (``prefix_embeds``), and the moe
family (mixtral, phi3.5-moe), whose blocks route each token through
:func:`repro_torch.models.moe.moe_apply` in place of the MLP.
:class:`HybridLM` (zamba2) has one :class:`HybridLayer` (``ln`` and a
:class:`~repro_torch.models.mamba2.Mamba2`) per layer and ONE
``shared_attn`` block, applied after every ``attn_every``-th layer with
the same weights each time; each application is one KV layer of the paged
cache (:func:`hybrid_kv_slots`).  :class:`RWKV6LM` (rwkv6) has one
:class:`RWKV6Layer` (``ln1``, a time mix, ``ln2``, a channel mix) per
layer and no attention.  :class:`WhisperLM` (whisper) adds to the decoder
layers an encoder of :class:`AttnBlock`s over the request's frame
embeddings (bidirectional, learned positions ``enc_pos``), its
``enc_final_norm``, one :class:`CrossBlock` after every decoder layer, and
learned decoder positions ``dec_pos``; the audio family has no RoPE.

Attention goes through the flash kernel for CUDA tensors and through
``mea_attention`` -- the JAX package's own arithmetic, which keeps the CPU
path within f32 rounding of it -- for CPU tensors (:func:`attention`).

Serving holds the parameters without gradients.  The training forward
(:func:`repro_torch.models.model_zoo.forward_train`) passes
``differentiable=True``, which sends every attention call site (self, the
whisper encoder, cross, the hybrid's shared block) to ``mea_attention`` on
either device -- the function the JAX package trains through; the flash
kernel is forward-only -- and ``remat=True``, which runs each layer under
``torch.utils.checkpoint`` as the JAX package wraps each scanned layer in
``jax.checkpoint`` (whisper's encoder layers are not rematted there
either).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..distributed.hints import current_hints, use_hints
from ..distributed.sharding import heads_local, linear
from ..kernels.flash_attention.ops import flash_attention_op
from . import mamba2 as m2
from . import moe as mo
from . import rwkv6 as rw
from .attention import FULL_WINDOW, mea_attention
from .layers import (YaRN, LayerNorm, apply_norm, apply_rope, bias_init,
                     dense_init, embed, init_embedding, init_norm, mlp_apply,
                     out_project, qkv_project, unembed)

#: rows of whisper's learned decoder positions, as in the JAX tree (sized
#: for a 32k decode; the deployed decoder context is 448)
DEC_POS_ROWS = 32768 + 8


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, differentiable: bool = False
              ) -> torch.Tensor:
    """``[B, Tq, H, hd]`` attention at one call site: the flash kernel for
    CUDA tensors, ``mea_attention`` for CPU tensors and, with
    ``differentiable``, on either device (the kernel has no backward).
    ``window=None`` is no window.  On a mesh each rank attends over its
    lanes and KV heads (:func:`~repro_torch.distributed.sharding
    .heads_local`)."""
    if q.device.type == "cuda" and not differentiable:
        return flash_attention_op(
            q, k, v, causal=causal,
            window=FULL_WINDOW if window is None else window,
            q_offset=q_offset)
    return heads_local(partial(mea_attention, causal=causal, window=window,
                               q_offset=q_offset), q, k, v)


def _run_block(remat: bool, fn, x: torch.Tensor):
    """``fn(x)``; with ``remat`` under activation checkpointing, so that the
    backward recomputes the block from ``x`` (``fn`` binds its layer by
    value: the recomputation runs after the loop has moved on)."""
    return checkpoint(fn, x, use_reentrant=False) if remat else fn(x)


def layer_windows(cfg: ArchConfig) -> list[int]:
    """Attention window of each layer (``FULL_WINDOW`` = none).  Under
    ``swa`` every layer sees ``cfg.window`` tokens (mixtral); under
    ``local_global`` every ``local_per_global + 1``-th layer is global and
    the others see ``cfg.window`` tokens (gemma3's 5:1 pattern)."""
    n = cfg.num_attn_layers
    if cfg.attn_pattern == "swa":
        return [cfg.window] * n
    if cfg.attn_pattern == "local_global":
        period = cfg.local_per_global + 1
        return [FULL_WINDOW if i % period == cfg.local_per_global
                else cfg.window for i in range(n)]
    return [FULL_WINDOW] * n


def layer_yarns(cfg: ArchConfig) -> list[Optional[YaRN]]:
    """Each attention layer's YaRN stretch of its RoPE: where the config
    sets ``yarn_factor``, the global layers' (``FULL_WINDOW`` in
    :func:`layer_windows`; the windowed layers keep plain RoPE at the same
    theta), else ``None`` on every layer."""
    if not cfg.yarn_factor:
        return [None] * cfg.num_attn_layers
    yarn = YaRN(cfg.yarn_factor, cfg.yarn_original_max_position,
                cfg.yarn_beta_fast, cfg.yarn_beta_slow,
                cfg.yarn_attention_factor)
    return [yarn if w == FULL_WINDOW else None for w in layer_windows(cfg)]


def recycle_window(cfg: ArchConfig) -> Optional[int]:
    """The window past which ONE paged pool recycles its pages:
    ``cfg.window`` when every attention layer is windowed (``swa``), else
    ``None``.  A ``local_global`` model whose cache splits
    (``PagedKVConfig.split_window``) recycles its windowed layers' pages in
    a pool of their own, past ``cfg.window``, and keeps its global layers'
    pages all live."""
    if cfg.attn_pattern == "swa" and cfg.window:
        return cfg.window
    return None


class AttnBlock(nn.Module):
    """Pre-norm attention + MLP block.  Without ``cfg.qkv_bias`` the
    biases ``bq``/``bk``/``bv`` are ``None``; a gated MLP has no
    ``b_in``/``b_out``.  The JAX init has zero MLP biases; with ``gen``
    they are drawn like the QKV biases, so a run on the card uses them.
    A block of the moe family has ``moe`` (:class:`~repro_torch.models.moe
    .MoE`) and no ``w_in``/``w_out``."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator]):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        H, KV, ff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff

        def w(shape):
            if gen is None:
                return _param(torch.empty(shape, dtype=dtype, device=device))
            return _param(dense_init(shape, dtype, device, gen))

        self.ln_attn = init_norm(cfg.norm, d, dtype, device, gen)
        self.wq = w((d, H * hd))
        self.wk = w((d, KV * hd))
        self.wv = w((d, KV * hd))
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            self.register_parameter(name, None if not cfg.qkv_bias else _param(
                torch.empty((n,), dtype=dtype, device=device) if gen is None
                else bias_init(n, d, dtype, device, gen)))
        self.wo = w((H * hd, d))
        self.ln_mlp = init_norm(cfg.norm, d, dtype, device, gen)
        if cfg.family == "moe":
            self.moe = mo.MoE(mo.spec_of(cfg), dtype, device, gen)
            return
        gelu = cfg.act == "gelu"
        self.w_in = w((d, ff if gelu else 2 * ff))
        self.w_out = w((ff, d))
        for name, n, fan_in in (("b_in", ff, d), ("b_out", d, ff)):
            self.register_parameter(name, None if not gelu else _param(
                torch.empty((n,), dtype=dtype, device=device) if gen is None
                else bias_init(n, fan_in, dtype, device, gen)))


def mlp_residual(cfg: ArchConfig, lp: AttnBlock, x: torch.Tensor
                 ) -> torch.Tensor:
    """``x + mlp(norm(x))`` of one block, ``x [B, S, d]`` or, at decode,
    ``[B, d]``.  The moe family's MLP is :func:`~repro_torch.models.moe
    .moe_apply`, over every row of ``x`` as one dispatch group (at decode
    every lane, inactive ones too, as in the JAX decode)."""
    h = apply_norm(cfg.norm, lp.ln_mlp, x)
    if cfg.family == "moe":
        y = mo.moe_apply(lp.moe, mo.spec_of(cfg),
                         h.reshape(h.shape[0], -1, h.shape[-1]))
        return x + y.reshape(x.shape)
    return x + mlp_apply(lp.w_in, lp.w_out, h, cfg.act, lp.b_in, lp.b_out)


def moe_layer_aux(cfg: ArchConfig, lp: AttnBlock, x: torch.Tensor
                  ) -> torch.Tensor:
    """One MoE layer's load-balance aux loss over ``x [B, S, d]`` (the
    router recomputed on the normed input)."""
    h = apply_norm(cfg.norm, lp.ln_mlp, x)
    return mo.moe_aux_loss(lp.moe, mo.spec_of(cfg), h)


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
        self.final_norm = init_norm(cfg.norm, d, dtype, device, gen)
        if not cfg.tie_embeddings:
            self.unembed = _param(
                torch.empty((d, V), dtype=dtype, device=device) if gen is None
                else dense_init((d, V), dtype, device, gen))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + vocab projection."""
        x = apply_norm(self.cfg.norm, self.final_norm, x)
        tied = self.cfg.tie_embeddings
        return unembed(self.embed if tied else self.unembed, x, tied)


def _check_family(cfg: ArchConfig, families: tuple,
                  patterns: tuple = ("full",)) -> None:
    if cfg.family not in families or cfg.attn_pattern not in patterns:
        raise NotImplementedError(
            f"{cfg.name!r}: the {cfg.family} family with "
            f"{cfg.attn_pattern!r} attention is not built by this module "
            f"class (the dense, vlm and moe families take full, "
            f"local:global or sliding-window attention; the hybrid, ssm and "
            f"audio families full attention)")


class DenseLM(_LM):
    """The dense decoder LM (also the vlm family's backbone and the moe
    family's, whose blocks carry a :class:`~repro_torch.models.moe.MoE`
    in place of the MLP).  ``gen=None`` leaves the weights uninitialized
    for a caller that loads them
    (:func:`repro_torch.models.model_zoo.params_from_numpy`)."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator] = None):
        _check_family(cfg, ("dense", "vlm", "moe"),
                      ("full", "local_global", "swa"))
        super().__init__(cfg, dtype, device, gen)
        self.layers = nn.ModuleList(
            AttnBlock(cfg, dtype, device, gen) for _ in range(cfg.num_layers))

    def forward(self, tokens: torch.Tensor, return_kv: bool = False,
                prefix_kv=None, pos_offset: int = 0, prefix_embeds=None,
                differentiable: bool = False, remat: bool = False):
        """Full-sequence logits ``[B, S, V]``; with ``return_kv`` also the
        per-layer ``(k, v)``, each ``[num_layers, B, S, KV, hd]``.
        ``differentiable`` and ``remat``: the training forward (module
        docstring).

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
        x = embed(self.embed, tokens)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        ks, vs = [], []
        hints = current_hints()
        for li, (lp, window, yarn) in enumerate(zip(
                self.layers, layer_windows(self.cfg),
                layer_yarns(self.cfg))):
            pkv = None if prefix_kv is None \
                else (prefix_kv[0][li], prefix_kv[1][li])
            x = hints.residual(x)
            x, (k, v) = _run_block(remat, partial(
                _attn_block_seq, self.cfg, lp, window=window,
                q_offset=pos_offset, prefix_kv=pkv,
                differentiable=differentiable, yarn=yarn), x)
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
        self.ln = init_norm(cfg.norm, cfg.d_model, dtype, device, gen)
        self.mamba = m2.Mamba2(spec, dtype, device, gen)


class HybridLM(_LM):
    """zamba2: stacked Mamba2 layers and ONE shared attention block, run
    after every ``attn_every``-th layer with the same weights."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator] = None):
        _check_family(cfg, ("hybrid",))
        super().__init__(cfg, dtype, device, gen)
        self.spec = m2.make_spec(cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim)
        self.layers = nn.ModuleList(
            HybridLayer(cfg, self.spec, dtype, device, gen)
            for _ in range(cfg.num_layers))
        self.shared_attn = AttnBlock(cfg, dtype, device, gen)

    def forward(self, tokens: torch.Tensor, return_kv: bool = False,
                prefix_kv=None, pos_offset: int = 0,
                differentiable: bool = False, remat: bool = False):
        """Full-sequence logits ``[B, S, V]``; with ``return_kv`` also the
        shared block's ``(k, v)`` of each application, each ``[L_kv, B, S,
        KV, hd]``.  A recurrent state has no prefix cache: ``prefix_kv``
        and ``pos_offset`` raise, as in the JAX package."""
        if prefix_kv is not None or pos_offset:
            raise ValueError("prefix_kv/pos_offset prefill-skip supports only "
                             "plain attention families (family='hybrid')")
        x, kv, _ = self._run(tokens, differentiable, remat)
        logits = self.logits(x)
        return (logits, kv) if return_kv else logits

    def prefill(self, tokens: torch.Tensor):
        """The serving prefill's outputs, without the vocab projection:
        ``(k, v)`` as :meth:`forward` gives them, and the per-layer
        ``(ssm [L, B, h, n, hd], conv [L, B, K-1, conv_dim])`` a decode
        continues from."""
        _, kv, states = self._run(tokens)
        return kv, states

    def _run(self, tokens: torch.Tensor, differentiable: bool = False,
             remat: bool = False):
        x = embed(self.embed, tokens)
        ks, vs, ssms, convs = [], [], [], []
        hints = current_hints()
        for layer, flag in zip(self.layers, hybrid_attn_flags(self.cfg)):
            x = hints.residual(x)
            x, kv, ssm, conv = _run_block(remat, partial(
                _hybrid_layer, self.cfg, self.spec, layer,
                self.shared_attn if flag else None,
                differentiable=differentiable), x)
            ssms.append(ssm)
            convs.append(conv)
            if flag:
                ks.append(kv[0])
                vs.append(kv[1])
        return (x, (torch.stack(ks), torch.stack(vs)),
                (torch.stack(ssms), torch.stack(convs)))


def _hybrid_layer(cfg: ArchConfig, spec: m2.Mamba2Spec, layer: HybridLayer,
                  shared: Optional[AttnBlock], x: torch.Tensor,
                  differentiable: bool = False):
    """One hybrid layer: the Mamba2 block, then the shared attention block
    where ``shared`` is given; ``(x, (k, v) or None, ssm, conv)``."""
    y, ssm, conv = m2.mamba2_forward_with_state(
        layer.mamba, spec, apply_norm(cfg.norm, layer.ln, x))
    x = x + y
    kv = None
    if shared is not None:
        x, kv = _attn_block_seq(cfg, shared, x, FULL_WINDOW,
                                differentiable=differentiable)
    return x, kv, ssm, conv


def _attn_block_seq(cfg: ArchConfig, lp: AttnBlock, x: torch.Tensor,
                    window: int, q_offset: int = 0, prefix_kv=None,
                    causal: bool = True, differentiable: bool = False,
                    yarn: Optional[YaRN] = None):
    """One block over a full sequence; returns ``(x, (k, v))``.

    The sequence sits at absolute positions ``[q_offset, q_offset + T)``
    (RoPE is applied there, but for the audio family, whose positions are
    learned); ``prefix_kv`` = (pk, pv), each ``[B, P, KV, hd]``, holds the
    cached keys of positions ``[0, P)`` with ``P == q_offset``, which the
    queries attend over before their own.  The returned ``(k, v)`` cover
    the sequence alone.  ``causal=False`` is whisper's bidirectional
    encoder block.  ``differentiable``: :func:`attention`'s; ``yarn``: the
    layer's RoPE stretch (:func:`layer_yarns`)."""
    hd = cfg.resolved_head_dim
    h = apply_norm(cfg.norm, lp.ln_attn, x)
    q, k, v = qkv_project(lp.wq, lp.wk, lp.wv, h, cfg.num_heads,
                          cfg.num_kv_heads, hd, lp.bq, lp.bk, lp.bv)
    if cfg.family != "audio":
        positions = q_offset + torch.arange(x.shape[1], dtype=torch.int32,
                                            device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta, yarn)
        k = apply_rope(k, positions, cfg.rope_theta, yarn)
    if prefix_kv is not None:
        k_all = torch.cat([prefix_kv[0].to(k.dtype), k], dim=1)
        v_all = torch.cat([prefix_kv[1].to(v.dtype), v], dim=1)
    else:
        k_all, v_all = k, v
    attn = attention(q, k_all, v_all, causal=causal,
                     window=window if causal else None, q_offset=q_offset,
                     differentiable=differentiable)
    x = x + out_project(lp.wo, attn)
    return mlp_residual(cfg, lp, x), (k, v)


class RWKV6Layer(nn.Module):
    """``ln1``, the time mix ``tm``, ``ln2`` and the channel mix ``cm``
    (the JAX tree's ``init_rwkv_block``)."""

    def __init__(self, cfg: ArchConfig, spec: rw.RWKV6Spec,
                 dtype: torch.dtype, device: torch.device,
                 gen: Optional[torch.Generator]):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, dtype, device, gen)
        self.ln2 = LayerNorm(cfg.d_model, dtype, device, gen)
        self.tm = rw.TimeMix(spec, dtype, device, gen)
        self.cm = rw.ChannelMix(spec, dtype, device, gen)


class RWKV6LM(_LM):
    """rwkv6: stacked RWKV6 layers, attention-free: no K/V, no paged
    cache, a recurrent state per lane."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator] = None):
        _check_family(cfg, ("ssm",))
        super().__init__(cfg, dtype, device, gen)
        self.spec = rw.RWKV6Spec(cfg.d_model, cfg.d_ff, cfg.resolved_head_dim)
        self.layers = nn.ModuleList(
            RWKV6Layer(cfg, self.spec, dtype, device, gen)
            for _ in range(cfg.num_layers))

    def forward(self, tokens: torch.Tensor, return_kv: bool = False,
                prefix_kv=None, pos_offset: int = 0,
                differentiable: bool = False, remat: bool = False):
        """Full-sequence logits ``[B, S, V]``.  The family has no K/V and
        no prefix cache: ``return_kv``, ``prefix_kv`` and ``pos_offset``
        raise.  It has no attention either: ``differentiable`` changes
        nothing."""
        if return_kv or prefix_kv is not None or pos_offset:
            raise ValueError("rwkv6 has no K/V: no return_kv and no "
                             "prefix_kv/pos_offset prefill-skip "
                             "(family='ssm')")
        return self.logits(self._run(tokens, remat)[0])

    def prefill(self, tokens: torch.Tensor):
        """The serving prefill's outputs, without the vocab projection: the
        per-layer ``(wkv [L, B, H, hd, hd] f32, tm_prev [L, B, 1, d],
        cm_prev [L, B, 1, d])`` a decode continues from (each mix's last
        normalised input)."""
        return self._run(tokens)[1]

    def _run(self, tokens: torch.Tensor, remat: bool = False):
        x = embed(self.embed, tokens)
        wkvs, tms, cms = [], [], []
        hints = current_hints()
        for layer in self.layers:
            x = hints.residual(x)
            x, wkv, tm_last, cm_last = _run_block(
                remat, partial(_rwkv6_layer, self.spec, layer), x)
            wkvs.append(wkv)
            tms.append(tm_last)
            cms.append(cm_last)
        return x, (torch.stack(wkvs), torch.stack(tms), torch.stack(cms))


def _rwkv6_layer(spec: rw.RWKV6Spec, layer: RWKV6Layer, x: torch.Tensor):
    """One RWKV6 layer: ``(x, wkv, tm_prev, cm_prev)`` (each mix's last
    normalised input)."""
    tm_in = apply_norm("layernorm", layer.ln1, x)
    y, wkv = rw.rwkv6_time_mix(layer.tm, spec, tm_in)
    x = x + y
    cm_in = apply_norm("layernorm", layer.ln2, x)
    x = x + rw.rwkv6_channel_mix(layer.cm, cm_in)
    return x, wkv, tm_in[:, -1:], cm_in[:, -1:]


class CrossBlock(nn.Module):
    """whisper's cross-attention after a decoder layer: ``ln``, ``wq [d,
    H*hd]``, ``wk``/``wv [d, KV*hd]`` (projecting the encoder output) and
    ``wo``; no bias."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator]):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        H, KV = cfg.num_heads, cfg.num_kv_heads

        def w(shape):
            if gen is None:
                return _param(torch.empty(shape, dtype=dtype, device=device))
            return _param(dense_init(shape, dtype, device, gen))
        self.ln = init_norm(cfg.norm, d, dtype, device, gen)
        self.wq = w((d, H * hd))
        self.wk = w((d, KV * hd))
        self.wv = w((d, KV * hd))
        self.wo = w((H * hd, d))


def cross_kv(cfg: ArchConfig, cp: CrossBlock, enc_out: torch.Tensor):
    """The encoder output's cross K/V, each ``[B, F, KV, hd]``."""
    hd = cfg.resolved_head_dim
    lead = enc_out.shape[:-1]
    return (linear(enc_out, cp.wk).reshape(*lead, cfg.num_kv_heads, hd),
            linear(enc_out, cp.wv).reshape(*lead, cfg.num_kv_heads, hd))


def cross_residual(cfg: ArchConfig, cp: CrossBlock, x: torch.Tensor,
                   enc_out: torch.Tensor, differentiable: bool = False
                   ) -> torch.Tensor:
    """``x [B, T, d]`` plus its non-causal attention over ``enc_out [B,
    F, d]``.  ``differentiable``: :func:`attention`'s."""
    h = apply_norm(cfg.norm, cp.ln, x)
    q = linear(h, cp.wq).reshape(*h.shape[:-1], cfg.num_heads,
                                 cfg.resolved_head_dim)
    k, v = cross_kv(cfg, cp, enc_out)
    return x + out_project(cp.wo, attention(q, k, v, causal=False,
                                            differentiable=differentiable))


class WhisperLM(_LM):
    """whisper: a bidirectional encoder over the request's frame
    embeddings (the conv frontend is a stub, as in the JAX package), a
    decoder of :class:`AttnBlock`s each followed by a :class:`CrossBlock`
    over the encoder's output, learned positions on both sides."""

    def __init__(self, cfg: ArchConfig, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator] = None):
        _check_family(cfg, ("audio",))
        super().__init__(cfg, dtype, device, gen)
        d = cfg.d_model
        self.layers = nn.ModuleList(
            AttnBlock(cfg, dtype, device, gen) for _ in range(cfg.num_layers))
        self.enc_layers = nn.ModuleList(
            AttnBlock(cfg, dtype, device, gen)
            for _ in range(cfg.encoder_layers))
        self.enc_final_norm = init_norm(cfg.norm, d, dtype, device, gen)
        self.cross_layers = nn.ModuleList(
            CrossBlock(cfg, dtype, device, gen)
            for _ in range(cfg.num_layers))
        # positions N(0, 0.02) in f32 (the JAX init draws enc_pos so and
        # zeros dec_pos; drawn here, a run on the card uses them)
        self.enc_pos, self.dec_pos = (_param(
            torch.empty((n, d), dtype=torch.float32, device=device).normal_(
                0.0, 0.02, generator=gen).to(dtype) if gen is not None
            else torch.empty((n, d), dtype=dtype, device=device))
            for n in (cfg.encoder_seq_len, DEC_POS_ROWS))

    def encode(self, frames: torch.Tensor, differentiable: bool = False
               ) -> torch.Tensor:
        """``frames [B, F, d]`` (the stub frontend's output) -> the encoder
        output ``[B, F, d]``."""
        x = frames + self.enc_pos[:frames.shape[1]].to(frames.dtype)
        for lp in self.enc_layers:
            x, _ = _attn_block_seq(self.cfg, lp, x, FULL_WINDOW, causal=False,
                                   differentiable=differentiable)
        return apply_norm(self.cfg.norm, self.enc_final_norm, x)

    def forward(self, tokens: torch.Tensor, return_kv: bool = False,
                prefix_kv=None, pos_offset: int = 0, encoder_frames=None,
                differentiable: bool = False, remat: bool = False):
        """Full-sequence logits ``[B, S, V]`` of ``tokens`` over
        ``encoder_frames [B, F, d]``; with ``return_kv`` also the decoder's
        per-layer ``(k, v)``, each ``[L, B, S, KV, hd]``.  No prefix cache:
        ``prefix_kv`` and ``pos_offset`` raise, as in the JAX package."""
        if prefix_kv is not None or pos_offset:
            raise ValueError("prefix_kv/pos_offset prefill-skip supports only "
                             "plain attention families without vlm/encoder "
                             "prefixes (family='audio')")
        logits, kv = self._decode(
            tokens, self.encode(encoder_frames, differentiable),
            differentiable, remat)
        return (logits, kv) if return_kv else logits

    def prefill(self, tokens: torch.Tensor, frames: torch.Tensor):
        """The serving prefill: ``(logits, (k, v), enc_out)``, the encoder
        run once (the JAX prefill runs it twice: ROADMAP.md, Queue 3)."""
        enc_out = self.encode(frames)
        logits, kv = self._decode(tokens, enc_out)
        return logits, kv, enc_out

    def _decode(self, tokens: torch.Tensor, enc_out: torch.Tensor,
                differentiable: bool = False, remat: bool = False):
        x = embed(self.embed, tokens)
        x = x + self.dec_pos[:x.shape[1]].to(x.dtype)
        ks, vs = [], []
        hints = current_hints()
        for lp, cp in zip(self.layers, self.cross_layers):
            x = hints.residual(x)
            x, (k, v) = _run_block(remat, partial(
                _whisper_decoder_layer, self.cfg, lp, cp, enc_out=enc_out,
                differentiable=differentiable), x)
            ks.append(k)
            vs.append(v)
        return self.logits(x), (torch.stack(ks), torch.stack(vs))


def _whisper_decoder_layer(cfg: ArchConfig, lp: AttnBlock, cp: CrossBlock,
                           x: torch.Tensor, enc_out: torch.Tensor,
                           differentiable: bool = False):
    """One decoder layer with its cross block: ``(x, (k, v))``."""
    x, kv = _attn_block_seq(cfg, lp, x, FULL_WINDOW,
                            differentiable=differentiable)
    return cross_residual(cfg, cp, x, enc_out, differentiable), kv


def lm_class(cfg: ArchConfig) -> type:
    """The module class of ``cfg``'s family."""
    return {"hybrid": HybridLM, "ssm": RWKV6LM,
            "audio": WhisperLM}.get(cfg.family, DenseLM)


def init_lm_params(cfg: ArchConfig, gen: torch.Generator,
                   dtype: torch.dtype = torch.bfloat16,
                   device: torch.device | str = "cpu") -> _LM:
    """The family's LM with weights drawn from ``gen`` on ``device``."""
    return lm_class(cfg)(cfg, dtype, torch.device(device), gen)


def forward(params: _LM, tokens: torch.Tensor, return_kv: bool = False,
            prefix_kv=None, pos_offset: int = 0, prefix_embeds=None,
            encoder_frames=None, differentiable: bool = False,
            remat: bool = False, hints=None):
    """Full-sequence logits (and per-layer K/V with ``return_kv``); see
    :meth:`DenseLM.forward` for the cached prefix and the vlm patch
    prefix (``prefix_embeds``, which only the dense and vlm families
    take) and :meth:`WhisperLM.forward` for ``encoder_frames``.
    ``differentiable`` and ``remat`` make it the training forward (module
    docstring).  ``hints`` (else the ambient ones) put each layer's input
    residual stream in sequence-sharded layout on a mesh."""
    extra = {} if prefix_embeds is None else {"prefix_embeds": prefix_embeds}
    if encoder_frames is not None:
        extra["encoder_frames"] = encoder_frames
    with use_hints(hints if hints is not None else current_hints()):
        return params(tokens, return_kv=return_kv, prefix_kv=prefix_kv,
                      pos_offset=pos_offset, differentiable=differentiable,
                      remat=remat, **extra)
