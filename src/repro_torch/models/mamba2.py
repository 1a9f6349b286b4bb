"""Mamba2 (SSD) block, zamba2's backbone layer (port of
:mod:`repro.models.mamba2`).

The input projection gives (z, x, B, C, dt); a causal depthwise conv of
width ``CONV_K`` runs over (x, B, C); the per-head decay is
``a_t = exp(dt * A)`` with ``dt = softplus(dt + dt_bias)`` in f32; the SSD
recurrence goes through the chunked linear-attention engine (q=C, k=B,
v=dt*x, one decay per head); a D skip and a gated RMSNorm close the block.
Decode carries ``conv [B, K-1, conv_dim]`` (model dtype) and ``ssm [B,
heads, n, head_dim]`` (f32 in every model dtype).

The parameters live in an :class:`Mamba2` module under the JAX tree's
names; the arithmetic is plain functions on it.  There is no kernel: the
JAX package computes the SSD in ``jnp`` too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense_init, rmsnorm
from ..distributed.sharding import (attention_axes, find_mesh, fit_split,
                                    grad_fit, linear, shard_map)
from .linear_attention import (chunked_linear_attention,
                               linear_attention_decode_step)

CONV_K = 4
F32 = torch.float32


class Mamba2Spec(NamedTuple):
    d_model: int
    d_inner: int
    n_state: int
    head_dim: int

    @property
    def heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_state


def make_spec(d_model: int, n_state: int, head_dim: int) -> Mamba2Spec:
    return Mamba2Spec(d_model=d_model, d_inner=2 * d_model, n_state=n_state,
                      head_dim=head_dim)


#: parameters kept in f32 whatever the model dtype (as in the JAX tree)
F32_PARAMS = ("A_log", "D", "dt_bias")


class Mamba2(nn.Module):
    """One block's parameters.  ``gen=None`` leaves the projections and the
    conv weight uninitialized for a caller that loads them."""

    def __init__(self, spec: Mamba2Spec, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator]):
        super().__init__()
        proj_out = 2 * spec.d_inner + 2 * spec.n_state + spec.heads

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        def w(shape):
            if gen is None:
                return param(torch.empty(shape, dtype=dtype, device=device))
            return param(dense_init(shape, dtype, device, gen))

        self.in_proj = w((spec.d_model, proj_out))
        self.out_proj = w((spec.d_inner, spec.d_model))
        conv_w = torch.empty((CONV_K, spec.conv_dim), dtype=F32, device=device)
        if gen is not None:
            conv_w.normal_(0.0, 1.0, generator=gen).mul_(0.1)
        self.conv_w = param(conv_w.to(dtype))
        self.conv_b = param(torch.zeros((spec.conv_dim,), dtype=dtype,
                                        device=device))
        self.A_log = param(torch.zeros((spec.heads,), dtype=F32,
                                       device=device))   # A = -exp(A_log)
        self.D = param(torch.ones((spec.heads,), dtype=F32, device=device))
        self.dt_bias = param(torch.zeros((spec.heads,), dtype=F32,
                                         device=device))
        self.norm_scale = param(torch.zeros((spec.d_inner,), dtype=dtype,
                                            device=device))


def _split_proj(spec: Mamba2Spec, proj: torch.Tensor):
    di = spec.d_inner
    z = proj[..., :di]
    xBC = proj[..., di:di + spec.conv_dim]
    dt = proj[..., di + spec.conv_dim:]
    assert dt.shape[-1] == spec.heads
    return z, xBC, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as ``logaddexp(x, 0)``, the form of
    ``jax.nn.softplus`` (``F.softplus`` switches to ``x`` above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(conv_w: torch.Tensor, conv_b: torch.Tensor,
                 xBC: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv (K = 4) as a sum of four shifted products in
    f32.  ``xBC [B, T, conv_dim]``; decode prepends the carried K-1 inputs.
    Returns the activated output and the last K-1 inputs (pre-activation),
    both in ``xBC``'s dtype."""
    w = conv_w.to(F32)                                # [K, conv_dim]
    x = xBC.to(F32)
    if conv_state is not None:
        x = torch.cat([conv_state.to(F32), x], dim=1)
    else:
        x = F.pad(x, (0, 0, CONV_K - 1, 0))
    T_out = xBC.shape[1]
    y = sum(x[:, i:i + T_out] * w[i] for i in range(CONV_K))
    y = F.silu(y + conv_b.to(F32))
    new_state = x[:, -(CONV_K - 1):]
    return y.to(xBC.dtype), new_state.to(xBC.dtype)


def _gated_out(p: Mamba2, spec: Mamba2Spec, y: torch.Tensor,
               xs: torch.Tensor, z: torch.Tensor, dtype: torch.dtype):
    """D skip, gated RMSNorm and the output projection; ``y`` and ``xs``
    are ``[..., heads, head_dim]``."""
    y = y + p.D.to(F32)[:, None] * xs.to(F32)
    y = grad_fit(y.reshape(*y.shape[:-2], spec.d_inner), -1, spec.heads)
    return linear(rmsnorm(p.norm_scale, y.to(dtype)) * F.silu(z), p.out_proj)


def _conv_with_tail(conv_w, conv_b, xBC_raw):
    """The prefill's conv: ``(activated xBC, the last K-1 raw inputs,
    zero-padded on the left)``."""
    T = xBC_raw.shape[1]
    tail = F.pad(xBC_raw, (0, 0, CONV_K - 1 - min(T, CONV_K - 1), 0)
                 )[:, -(CONV_K - 1):]
    return _causal_conv(conv_w, conv_b, xBC_raw)[0], tail


def mamba2_forward(
    p: Mamba2,
    spec: Mamba2Spec,
    x: torch.Tensor,                 # [B, T, d_model]
    initial_state: Optional[torch.Tensor] = None,   # [B, h, n, hd]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence SSD.  Returns ``(y [B, T, d_model], final_ssm_state
    [B, h, n, hd] f32)``."""
    y, final_state, _ = mamba2_forward_with_state(p, spec, x, initial_state)
    return y, final_state


def mamba2_forward_with_state(
    p: Mamba2,
    spec: Mamba2Spec,
    x: torch.Tensor,                 # [B, T, d_model]
    initial_state: Optional[torch.Tensor] = None,   # [B, h, n, hd]
):
    """As :func:`mamba2_forward`, and also the conv tail ``[B, K-1,
    conv_dim]``: the two states a decode continues from."""
    B, T, _ = x.shape
    h, hd, n = spec.heads, spec.head_dim, spec.n_state
    z, xBC_raw, dt = _split_proj(spec, linear(x, p.in_proj))
    conv = _conv_with_tail
    mesh = find_mesh(xBC_raw)
    if mesh is not None:   # per lane: each rank convolves its own lanes
        dp, _ = attention_axes(mesh, B, 1)
        lanes = (dp, None, None)
        conv = shard_map(conv, mesh, ((None, None), (None,), lanes), lanes)
    xBC, conv_tail = conv(p.conv_w, p.conv_b, xBC_raw)
    xs = fit_split(xBC[..., :spec.d_inner], -1, h).reshape(B, T, h, hd)
    Bmat = xBC[..., spec.d_inner:spec.d_inner + n]                  # [B, T, n]
    Cmat = xBC[..., spec.d_inner + n:]                              # [B, T, n]
    A = -torch.exp(p.A_log.to(F32))                                 # [h]
    dt = _softplus(dt.to(F32) + p.dt_bias)                          # [B, T, h]
    log_decay = (dt * A)[..., None]                                 # [B, T, h, 1]
    # SSD: q = C, k = B (shared by the heads), v = dt * x (ZOH scaling)
    q = Cmat[:, :, None].expand(B, T, h, n)
    k = Bmat[:, :, None].expand(B, T, h, n)
    v = xs.to(F32) * dt[..., None]
    y, final_state = chunked_linear_attention(
        q, k, v, log_decay, strict=False, shifted=False,
        initial_state=initial_state)
    return _gated_out(p, spec, y, xs, z, x.dtype), final_state, conv_tail


class Mamba2DecodeState(NamedTuple):
    conv: torch.Tensor   # [B, K-1, conv_dim] model dtype
    ssm: torch.Tensor    # [B, heads, n, head_dim] f32


def init_decode_state(spec: Mamba2Spec, batch: int, dtype: torch.dtype,
                      device: torch.device) -> Mamba2DecodeState:
    """Zero state for ``batch`` lanes: the conv tail in ``dtype``, the
    SSM state in f32."""
    return Mamba2DecodeState(
        conv=torch.zeros((batch, CONV_K - 1, spec.conv_dim), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, spec.heads, spec.n_state, spec.head_dim),
                        dtype=F32, device=device))


def mamba2_decode_step(
    p: Mamba2,
    spec: Mamba2Spec,
    x: torch.Tensor,                 # [B, d_model], one token
    state: Mamba2DecodeState,
) -> tuple[torch.Tensor, Mamba2DecodeState]:
    B = x.shape[0]
    h, hd, n = spec.heads, spec.head_dim, spec.n_state
    z, xBC, dt = _split_proj(spec, x[:, None] @ p.in_proj)
    xBC, new_conv = _causal_conv(p.conv_w, p.conv_b, xBC,
                                 conv_state=state.conv)
    xs = fit_split(xBC[:, 0, :spec.d_inner], -1, h).reshape(B, h, hd)
    Bmat = xBC[:, 0, spec.d_inner:spec.d_inner + n]
    Cmat = xBC[:, 0, spec.d_inner + n:]
    A = -torch.exp(p.A_log.to(F32))
    dtv = _softplus(dt[:, 0].to(F32) + p.dt_bias)                   # [B, h]
    log_decay = (dtv * A)[..., None]                                # [B, h, 1]
    q = Cmat[:, None].expand(B, h, n)
    k = Bmat[:, None].expand(B, h, n)
    v = xs.to(F32) * dtv[..., None]
    new_ssm, y = linear_attention_decode_step(state.ssm, q, k, v, log_decay)
    out = _gated_out(p, spec, y, xs, z[:, 0], x.dtype)
    return out, Mamba2DecodeState(conv=new_conv, ssm=new_ssm)
