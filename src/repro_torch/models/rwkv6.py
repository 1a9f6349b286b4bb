"""RWKV6 (Finch) block, rwkv6-7b's layer (port of :mod:`repro.models.rwkv6`).

Time mix: a token shift interpolates each token with its predecessor
(``mix[0..4]``) to feed the r/k/v/g projections and a decay LoRA (d -> 64
-> d), so the per-channel decay ``w_t = exp(-exp(base + tanh(wx A) B))``
depends on the data.  The wkv recurrence ``S_t = diag(w_t) S_{t-1} + k_t
v_t^T``, read out as ``r_t (S_{t-1} + diag(u) k_t v_t^T)``, runs on the
chunked linear-attention engine with ``strict``, ``shifted`` and the bonus
``u``; its output goes through ``ln_out`` (a LayerNorm over all of d) and
a SiLU gate.  Channel mix: a token shift, a squared-ReLU MLP and a sigmoid
receptance.

Decode carries ``wkv [B, H, hd, hd]`` (f32 in every model dtype) and the
last normalised input of each mix, ``tm_prev``/``cm_prev [B, 1, d]``
(model dtype).  There is no kernel: the JAX package computes the
recurrence in ``jnp`` too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import fit_split, grad_fit, linear
from .layers import LayerNorm, dense_init, layernorm
from .linear_attention import (chunked_linear_attention,
                               linear_attention_decode_step)

DECAY_LORA = 64
F32 = torch.float32

#: parameters kept in f32 whatever the model dtype (as in the JAX tree)
F32_PARAMS = ("decay_base", "bonus_u")


class RWKV6Spec(NamedTuple):
    d_model: int
    d_ff: int
    head_dim: int

    @property
    def heads(self) -> int:
        return self.d_model // self.head_dim


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _weight(shape, dtype: torch.dtype, device: torch.device,
            gen: Optional[torch.Generator]) -> nn.Parameter:
    """A projection; ``gen=None`` leaves it uninitialized for a caller
    that loads it."""
    if gen is None:
        return _param(torch.empty(shape, dtype=dtype, device=device))
    return _param(dense_init(shape, dtype, device, gen))


def _mix_weights(rows: int, d: int, dtype: torch.dtype, device: torch.device,
                 gen: Optional[torch.Generator]) -> nn.Parameter:
    """``[rows, d]`` interpolation weights, uniform in [0, 1) drawn in f32,
    as the JAX init."""
    m = torch.empty((rows, d), dtype=F32, device=device)
    if gen is not None:
        m.uniform_(0.0, 1.0, generator=gen)
    return _param(m.to(dtype))


class TimeMix(nn.Module):
    """``mix [5, d]``, ``wr/wk/wv/wg/wo [d, d]``, ``decay_lora_a [d, 64]``,
    ``decay_lora_b [64, d]``, ``decay_base [d]`` (f32, -4), ``bonus_u [H,
    hd]`` (f32) and ``ln_out``.  The JAX init has a zero bonus; with
    ``gen`` it is drawn uniform in [0, 1), so a run on the card uses it."""

    def __init__(self, spec: RWKV6Spec, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator]):
        super().__init__()
        d = spec.d_model
        mk = (dtype, device, gen)
        self.mix = _mix_weights(5, d, *mk)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, _weight((d, d), *mk))
        self.decay_lora_a = _weight((d, DECAY_LORA), *mk)
        self.decay_lora_b = _weight((DECAY_LORA, d), *mk)
        self.decay_base = _param(torch.full((d,), -4.0, dtype=F32,
                                            device=device))
        bonus = torch.zeros((spec.heads, spec.head_dim), dtype=F32,
                            device=device)
        if gen is not None:
            bonus.uniform_(0.0, 1.0, generator=gen)
        self.bonus_u = _param(bonus)
        self.ln_out = LayerNorm(d, dtype, device, gen)


class ChannelMix(nn.Module):
    """``mix [2, d]``, ``wk [d, ff]``, ``wv [ff, d]``, ``wr [d, d]``."""

    def __init__(self, spec: RWKV6Spec, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator]):
        super().__init__()
        d, ff = spec.d_model, spec.d_ff
        mk = (dtype, device, gen)
        self.mix = _mix_weights(2, d, *mk)
        self.wk = _weight((d, ff), *mk)
        self.wv = _weight((ff, d), *mk)
        self.wr = _weight((d, d), *mk)


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """x shifted one token right; position 0 receives ``prev`` (or
    zeros)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, shifted: torch.Tensor, m: torch.Tensor
         ) -> torch.Tensor:
    return x + (shifted - x) * m.to(x.dtype)


def _projections(tm: TimeMix, x: torch.Tensor, xs: torch.Tensor):
    """r, k, v, g and the f32 log-decay ``-exp(base + tanh(wx A) B)``
    (< 0) of the mixed inputs."""
    m = tm.mix
    r = linear(_mix(x, xs, m[0]), tm.wr)
    k = linear(_mix(x, xs, m[1]), tm.wk)
    v = linear(_mix(x, xs, m[2]), tm.wv)
    g = linear(_mix(x, xs, m[3]), tm.wg)
    lora = linear(torch.tanh(linear(_mix(x, xs, m[4]), tm.decay_lora_a)),
                  tm.decay_lora_b)
    log_decay = -torch.exp(tm.decay_base.float() + lora.float())
    return r, k, v, g, log_decay


def _out(tm: TimeMix, y: torch.Tensor, g: torch.Tensor, dtype) -> torch.Tensor:
    y = layernorm(tm.ln_out, y.to(dtype))
    return linear(y * F.silu(g), tm.wo)


def rwkv6_time_mix(tm: TimeMix, spec: RWKV6Spec, x: torch.Tensor,
                   initial_state: Optional[torch.Tensor] = None,
                   shift_prev: Optional[torch.Tensor] = None):
    """``x [B, T, d]`` -> ``(y [B, T, d], final wkv [B, H, hd, hd] f32)``."""
    B, T, d = x.shape
    h, hd = spec.heads, spec.head_dim
    r, k, v, g, log_decay = _projections(tm, x, _token_shift(x, shift_prev))
    r, k, v, log_decay = (fit_split(t, -1, h).reshape(B, T, h, hd)
                          for t in (r, k, v, log_decay))
    y, final = chunked_linear_attention(
        r, k, v, log_decay,
        strict=True, shifted=True, bonus=tm.bonus_u,
        initial_state=initial_state)
    return _out(tm, grad_fit(y.reshape(B, T, d), -1, h), g, x.dtype), final


def rwkv6_channel_mix(cm: ChannelMix, x: torch.Tensor,
                      shift_prev: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    xs = _token_shift(x, shift_prev)
    k = linear(_mix(x, xs, cm.mix[0]), cm.wk)
    r = linear(_mix(x, xs, cm.mix[1]), cm.wr)
    return torch.sigmoid(r) * linear(F.relu(k).square(), cm.wv)


class RWKV6DecodeState(NamedTuple):
    wkv: torch.Tensor       # [B, H, hd, hd] f32
    tm_prev: torch.Tensor   # [B, 1, d] the time mix's last input
    cm_prev: torch.Tensor   # [B, 1, d] the channel mix's last input


def init_decode_state(spec: RWKV6Spec, batch: int, dtype: torch.dtype,
                      device: torch.device) -> RWKV6DecodeState:
    """Zero state for ``batch`` lanes: the wkv state in f32, the two
    shifts in ``dtype``."""
    prev = torch.zeros((batch, 1, spec.d_model), dtype=dtype, device=device)
    return RWKV6DecodeState(
        wkv=torch.zeros((batch, spec.heads, spec.head_dim, spec.head_dim),
                        dtype=F32, device=device),
        tm_prev=prev, cm_prev=prev.clone())


def rwkv6_time_mix_step(tm: TimeMix, spec: RWKV6Spec, x: torch.Tensor,
                        state: RWKV6DecodeState):
    """One token ``x [B, d]``; returns ``(y [B, d], new wkv, new
    tm_prev [B, 1, d])``."""
    B, d = x.shape
    h, hd = spec.heads, spec.head_dim
    r, k, v, g, log_decay = _projections(tm, x, state.tm_prev[:, 0])
    r, k, v, log_decay = (fit_split(t, -1, h).reshape(B, h, hd)
                          for t in (r, k, v, log_decay))
    new_wkv, y = linear_attention_decode_step(
        state.wkv, r, k, v, log_decay, strict=True, bonus=tm.bonus_u)
    return _out(tm, y.reshape(B, d), g, x.dtype), new_wkv, x[:, None]


def rwkv6_channel_mix_step(cm: ChannelMix, x: torch.Tensor,
                           prev: torch.Tensor):
    """One token ``x [B, d]`` after ``prev [B, 1, d]``; returns ``(y [B,
    d], new prev)``."""
    return rwkv6_channel_mix(cm, x[:, None], prev)[:, 0], x[:, None]
