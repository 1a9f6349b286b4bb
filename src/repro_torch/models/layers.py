"""Shared model layers (port of :mod:`repro.models.layers`): norms, RoPE,
the gated MLP, embedding and projections, as functions on tensors.

Weights keep the JAX package's layout (``x @ w`` with ``w [d_in, d_out]``)
so parameters carry across unchanged.  Initializers draw from an explicit
:class:`torch.Generator`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm in f32 with the scale stored as ``scale - 1``."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    """Inverse frequencies, shape ``[head_dim // 2]`` (f32)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotate-half RoPE; ``x [..., T, H, hd]``, ``positions [..., T]``."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * inv                  # [..., T, hd/2]
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_apply(w_in: torch.Tensor, w_out: torch.Tensor, x: torch.Tensor
              ) -> torch.Tensor:
    """SwiGLU MLP: ``silu(gate) * up`` with ``[gate | up] = x @ w_in``."""
    gate, up = (x @ w_in).chunk(2, dim=-1)
    return (F.silu(gate) * up) @ w_out


def dense_init(shape: tuple, dtype: torch.dtype, device: torch.device,
               gen: torch.Generator) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by ``1/sqrt(fan_in)`` (drawn in
    f32, then cast), as the JAX initializer."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(1.0 / math.sqrt(shape[0])).to(dtype)


def init_embedding(vocab: int, d: int, dtype: torch.dtype,
                   device: torch.device, gen: torch.Generator) -> torch.Tensor:
    w = torch.empty((vocab, d), dtype=torch.float32, device=device)
    return w.normal_(0.0, 0.02, generator=gen).to(dtype)


def qkv_project(wq, wk, wv, x: torch.Tensor, num_heads: int,
                num_kv_heads: int, head_dim: int):
    """``x [..., T, d]`` -> q ``[..., T, H, hd]``, k/v ``[..., T, KV, hd]``."""
    lead = x.shape[:-1]
    return ((x @ wq).reshape(*lead, num_heads, head_dim),
            (x @ wk).reshape(*lead, num_kv_heads, head_dim),
            (x @ wv).reshape(*lead, num_kv_heads, head_dim))


def out_project(wo: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """``attn [..., T, H, hd]`` -> ``[..., T, d]``."""
    return attn.reshape(*attn.shape[:-2], -1) @ wo
