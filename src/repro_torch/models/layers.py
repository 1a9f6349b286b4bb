"""Shared model layers (port of :mod:`repro.models.layers`): norms, RoPE,
the gated and the plain GELU MLP, embedding and projections, as functions
on tensors.  A LayerNorm's scale and bias live in a :class:`LayerNorm`
module; an RMSNorm's scale is one tensor (:func:`apply_norm` takes
either).

Weights keep the JAX package's layout (``x @ w`` with ``w [d_in, d_out]``)
so parameters carry across unchanged.  Initializers draw from an explicit
:class:`torch.Generator`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import embed_lookup, fit_split, grad_fit, linear


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm in f32 with the scale stored as ``scale - 1``."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


def layernorm(p: "LayerNorm", x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """LayerNorm in f32 with the population variance, as the JAX
    ``layernorm``."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p.scale.float() + p.bias.float()).to(dt)


class LayerNorm(nn.Module):
    """A LayerNorm's ``scale`` (ones) and ``bias`` ``[d]``.  The JAX
    package initialises the bias to zero; with ``gen`` it is drawn from
    ``N(0, 0.02)``, so that a run on the card exercises it."""

    def __init__(self, d: int, dtype: torch.dtype, device: torch.device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        bias = torch.zeros((d,), dtype=torch.float32, device=device)
        if gen is not None:
            bias.normal_(0.0, 0.02, generator=gen)
        self.scale = nn.Parameter(torch.ones((d,), dtype=dtype,
                                             device=device),
                                  requires_grad=False)
        self.bias = nn.Parameter(bias.to(dtype), requires_grad=False)


def init_norm(kind: str, d: int, dtype: torch.dtype, device: torch.device,
              gen: Optional[torch.Generator] = None):
    """An RMSNorm's scale (stored as ``scale - 1``: zeros) or a
    :class:`LayerNorm`."""
    if kind == "rmsnorm":
        return nn.Parameter(torch.zeros((d,), dtype=dtype, device=device),
                            requires_grad=False)
    return LayerNorm(d, dtype, device, gen)


def apply_norm(kind: str, p, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


class YaRN(NamedTuple):
    """YaRN's stretch of the RoPE frequencies (a global layer's, where a
    config sets ``yarn_factor``): the low frequencies are divided by
    ``factor``, the high ones kept, a linear ramp between, and cos and sin
    scaled by ``attention_factor``."""

    factor: float
    original_max_position: int
    beta_fast: float
    beta_slow: float
    attention_factor: float


def yarn_bounds(head_dim: int, theta: float, yarn: YaRN
                ) -> tuple[float, float]:
    """``(low, high)``: the frequency indices where YaRN's ramp starts and
    ends, ``floor``/``ceil`` of ``d ln(L0 / (2 pi beta)) / (2 ln theta)``
    for ``beta_fast`` and ``beta_slow``, clamped to ``[0, d - 1]`` (a
    zero-width ramp widened by 0.001)."""
    def dim(beta: float) -> float:
        return head_dim * math.log(yarn.original_max_position
                                   / (beta * 2 * math.pi)) \
            / (2 * math.log(theta))
    low = max(math.floor(dim(yarn.beta_fast)), 0)
    high = min(math.ceil(dim(yarn.beta_slow)), head_dim - 1)
    return float(low), float(high if high != low else high + 0.001)


def rope_frequencies(head_dim: int, theta: float, device: torch.device,
                     yarn: Optional[YaRN] = None) -> torch.Tensor:
    """Inverse frequencies, shape ``[head_dim // 2]`` (f32): ``theta **
    (-2i / d)``, or with ``yarn`` ramped from those (below ``low``) to
    them over ``factor`` (above ``high``)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    inv = 1.0 / (theta ** exponents)
    if yarn is None:
        return inv
    low, high = yarn_bounds(head_dim, theta, yarn)
    i = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
    ramp = ((i - low) / (high - low)).clamp(0.0, 1.0)
    return inv * (1.0 - ramp) + inv / yarn.factor * ramp


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               yarn: Optional[YaRN] = None) -> torch.Tensor:
    """Rotate-half RoPE; ``x [..., T, H, hd]``, ``positions [..., T]``;
    with ``yarn`` at its frequencies, cos and sin scaled by its
    ``attention_factor``."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, x.device, yarn)
    angles = positions[..., None].float() * inv                  # [..., T, hd/2]
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    if yarn is not None:
        sin = sin * yarn.attention_factor
        cos = cos * yarn.attention_factor
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_apply(w_in: torch.Tensor, w_out: torch.Tensor, x: torch.Tensor,
              act: str, b_in: Optional[torch.Tensor] = None,
              b_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gated MLP ``act(gate) * up`` with ``[gate | up] = x @ w_in``:
    ``swiglu`` takes SiLU, ``geglu`` the tanh form of GELU (the default of
    ``jax.nn.gelu``; the exact GELU would be a silent mismatch).  ``gelu``
    is the plain MLP with biases (whisper): ``gelu(x @ w_in + b_in) @
    w_out + b_out``, GELU in its tanh form too."""
    if act == "gelu":
        h = linear(x, w_in)
        if b_in is not None:
            h = h + b_in
        y = linear(F.gelu(h, approximate="tanh"), w_out)
        return y if b_out is None else y + b_out
    gate, up = linear(x, w_in).chunk(2, dim=-1)
    if act == "swiglu":
        g = F.silu(gate)
    elif act == "geglu":
        g = F.gelu(gate, approximate="tanh")
    else:
        raise NotImplementedError(f"gated MLP activation {act!r}")
    return linear(g * up, w_out)


def dense_init(shape: tuple, dtype: torch.dtype, device: torch.device,
               gen: torch.Generator) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by ``1/sqrt(fan_in)`` (drawn in
    f32, then cast), as the JAX initializer."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(1.0 / math.sqrt(shape[0])).to(dtype)


def bias_init(n: int, fan_in: int, dtype: torch.dtype, device: torch.device,
              gen: torch.Generator) -> torch.Tensor:
    """A projection bias ``[n]`` drawn like one row of that projection's
    weight.  The JAX package initialises QKV biases to zero; random ones
    make a run on the card exercise the bias."""
    w = torch.empty((n,), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def init_embedding(vocab: int, d: int, dtype: torch.dtype,
                   device: torch.device, gen: torch.Generator) -> torch.Tensor:
    w = torch.empty((vocab, d), dtype=torch.float32, device=device)
    return w.normal_(0.0, 0.02, generator=gen).to(dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table [V, d]`` for ``tokens`` (on a mesh each rank
    looks up its own rows: :func:`~repro_torch.distributed.sharding
    .embed_lookup`)."""
    return embed_lookup(table, tokens)


def unembed(table_or_head: torch.Tensor, x: torch.Tensor, tied: bool
            ) -> torch.Tensor:
    """Logits of ``x [..., d]``: over the embedding table ``[V, d]`` when
    ``tied``, else over the head ``[d, V]``."""
    return linear(x, table_or_head.T if tied else table_or_head)


def qkv_project(wq, wk, wv, x: torch.Tensor, num_heads: int,
                num_kv_heads: int, head_dim: int, bq=None, bk=None, bv=None):
    """``x [..., T, d]`` -> q ``[..., T, H, hd]``, k/v ``[..., T, KV, hd]``.
    A bias (qwen2's ``bq [H*hd]``, ``bk``/``bv [KV*hd]``) is added to its
    product, before any RoPE, as in the JAX package."""
    lead = x.shape[:-1]

    def proj(w, b, heads):
        y = linear(x, w)
        if b is not None:
            y = y + b
        return fit_split(y, -1, heads).reshape(*lead, heads, head_dim)
    return (proj(wq, bq, num_heads), proj(wk, bk, num_kv_heads),
            proj(wv, bv, num_kv_heads))


def out_project(wo: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """``attn [..., T, H, hd]`` -> ``[..., T, d]``."""
    return linear(grad_fit(attn.reshape(*attn.shape[:-2], -1), -1,
                           attn.shape[-2]), wo)
