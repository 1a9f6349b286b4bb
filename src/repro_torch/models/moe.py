"""Mixture-of-Experts layer with capacity-based scatter dispatch (port of
:mod:`repro.models.moe`).

Top-k routing into a static-capacity ``[E, C, d]`` buffer: each (token,
k) pair is ranked within its chosen expert by arrival order (the
support core's batched-assignment idiom,
:func:`repro_torch.core.hmq.round_robin_rank`), pairs ranked at or past
the capacity ``C`` drop to the residual path, the experts' gated MLPs run
as two batched products over the buffer, and the kept outputs are
combined back weighted by the renormalised router probabilities.

The JAX package splits the tokens into dispatch groups, one per data
shard of its mesh; without a mesh that is one group, which is what the
port runs.  The buffer goes through plain ``torch.bmm``: the reference
computes it outside any Pallas kernel.

The router weight ``[d, E]`` is f32 in any model dtype and the logits are
``x.float() @ router``, as in the JAX package.  ``jax.lax.top_k`` breaks
ties toward the lower expert index; so does the stable descending sort
used here (``torch.topk`` promises no order among ties).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.hmq import round_robin_rank
from .layers import dense_init


class MoESpec(NamedTuple):
    d_model: int
    d_ff: int
    num_experts: int
    experts_per_token: int
    capacity_factor: float = 1.25
    act: str = "swiglu"


def spec_of(cfg) -> MoESpec:
    """The MoE layer's spec from an ``ArchConfig`` of the moe family."""
    return MoESpec(cfg.d_model, cfg.d_ff, cfg.num_experts,
                   cfg.experts_per_token,
                   capacity_factor=cfg.moe_capacity_factor, act=cfg.act)


class MoE(nn.Module):
    """``router [d, E]`` (f32), ``w_in [E, d, 2*ff]`` (``[E, d, ff]`` for
    a plain GELU), ``w_out [E, ff, d]``: the JAX tree's ``moe`` leaves,
    drawn from ``gen`` as the JAX ``init_moe`` draws them (``gen=None``
    leaves them uninitialized)."""

    def __init__(self, spec: MoESpec, dtype: torch.dtype,
                 device: torch.device, gen: Optional[torch.Generator]):
        super().__init__()
        E, d, ff = spec.num_experts, spec.d_model, spec.d_ff
        gated = spec.act in ("swiglu", "geglu")

        def w(shape, dt):
            if gen is None:
                t = torch.empty(shape, dtype=dt, device=device)
            else:
                t = dense_init(shape, dt, device, gen)
            return nn.Parameter(t, requires_grad=False)
        self.router = w((d, E), torch.float32)
        self.w_in = w((E, d, (2 if gated else 1) * ff), dtype)
        self.w_out = w((E, ff, d), dtype)


def expert_capacity(spec: MoESpec, num_tokens: int) -> int:
    """Slots per expert: ``ceil(N * K * cf / E)``, at least 8, rounded up
    to a multiple of 8."""
    c = int(math.ceil(num_tokens * spec.experts_per_token
                      * spec.capacity_factor / spec.num_experts))
    return max(8, -(-c // 8) * 8)


def route(params: MoE, spec: MoESpec, xf: torch.Tensor):
    """Routing of ``xf [N, d]``: ``(top_w [N, K] f32 renormalised, top_e
    [N, K], rank [N*K] int32, keep [N*K] bool, C)``."""
    N = xf.shape[0]
    K = spec.experts_per_token
    C = expert_capacity(spec, N)
    gates = torch.softmax(xf.float() @ params.router, dim=-1)      # [N, E]
    top_w, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :K], top_e[:, :K]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    choice_e = top_e.reshape(-1)
    rank = round_robin_rank(choice_e, torch.ones_like(choice_e,
                                                      dtype=torch.bool))
    return top_w, top_e, rank, rank < C, C


def moe_apply(params: MoE, spec: MoESpec, x: torch.Tensor) -> torch.Tensor:
    """``x [B, S, d] -> [B, S, d]``: top-k routed, capacity-dropped, over
    one dispatch group of all ``B * S`` tokens."""
    B, S, d = x.shape
    E, K = spec.num_experts, spec.experts_per_token
    xf = x.reshape(B * S, d)
    top_w, top_e, rank, keep, C = route(params, spec, xf)
    pos = top_e.reshape(-1).long() * C + rank.long()     # row in [E * C]
    tok = torch.arange(B * S, device=x.device).repeat_interleave(K)
    # scatter kept pairs into the buffer; dropped pairs go to a sink row
    buf = x.new_zeros((E * C + 1, d))
    buf[torch.where(keep, pos, E * C)] = xf[tok]
    buf = buf[:E * C].reshape(E, C, d)

    h = torch.bmm(buf, params.w_in)
    if spec.act in ("swiglu", "geglu"):
        gate, up = h.chunk(2, dim=-1)
        g = F.silu(gate) if spec.act == "swiglu" \
            else F.gelu(gate, approximate="tanh")
        h = g * up
    else:
        h = F.gelu(h, approximate="tanh")
    out_buf = torch.bmm(h, params.w_out).reshape(E * C, d)

    # combine: each kept pair's output weighted by its router probability,
    # summed per token in k order from zero in f32 (JAX's scatter-add)
    gathered = out_buf[torch.where(keep, pos, 0)]
    w = (top_w.reshape(-1) * keep).float()[:, None]
    contrib = (gathered.float() * w).reshape(B * S, K, d)
    out = torch.zeros((B * S, d), dtype=torch.float32, device=x.device)
    for k in range(K):
        out = out + contrib[:, k]
    return out.reshape(B, S, d).to(x.dtype)


def moe_aux_loss(params: MoE, spec: MoESpec, x: torch.Tensor
                 ) -> torch.Tensor:
    """Switch-style load-balance loss: ``E * sum(fraction routed top-1 x
    mean gate)``."""
    N = x.shape[0] * x.shape[1]
    gates = torch.softmax(x.reshape(N, -1).float() @ params.router, dim=-1)
    top1 = gates.argmax(dim=-1)
    frac = F.one_hot(top1, spec.num_experts).float().mean(0)
    return spec.num_experts * (frac * gates.mean(0)).sum()
