"""Mixture-of-Experts layer with capacity-based scatter dispatch (port of
:mod:`repro.models.moe`).

Top-k routing into a static-capacity ``[E, C, d]`` buffer: each (token,
k) pair is ranked within its chosen expert by arrival order (the
support core's batched-assignment idiom,
:func:`repro_torch.core.hmq.round_robin_rank`), pairs ranked at or past
the capacity ``C`` drop to the residual path, the experts' gated MLPs run
as two batched products over the buffer, and the kept outputs are
combined back weighted by the renormalised router probabilities.

The tokens split into dispatch groups, one per data shard of the mesh
(:func:`moe_apply`); without a mesh that is one group.  The buffer goes
through plain ``torch.bmm``: the reference computes it outside any Pallas
kernel.

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
from ..tracing import span
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
    """Routing of ``xf [N, d]`` as one group: ``(top_w [N, K] f32
    renormalised, top_e [N, K], rank [N*K] int32, keep [N*K] bool, C)``."""
    C = expert_capacity(spec, xf.shape[0])
    gates = torch.softmax(xf.float() @ params.router, dim=-1)      # [N, E]
    top_w, top_e, rank, keep = _route(gates[None], spec.experts_per_token,
                                      C)
    return top_w[0], top_e[0], rank[0], keep[0], C


def _route(gates: torch.Tensor, K: int, C: int):
    """Top-k routing of ``gates [g, n, E]`` (f32) per group: ``(top_w [g,
    n, K] renormalised, top_e [g, n, K], rank [g, n*K] int32, keep [g,
    n*K])``.  Each (token, k) pair is ranked within its (group, expert)
    by arrival order; pairs ranked at or past ``C`` drop."""
    g, n, E = gates.shape
    top_w, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :K], top_e[..., :K]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    grp = torch.arange(g, device=gates.device).repeat_interleave(n * K)
    choice = top_e.reshape(-1) + grp * E          # (group, expert) keys
    rank = round_robin_rank(choice, torch.ones_like(choice,
                                                    dtype=torch.bool))
    return top_w, top_e, rank.reshape(g, n * K), (rank < C).reshape(g, n * K)


def _dispatch(xf: torch.Tensor, gates: torch.Tensor, K: int, C: int):
    """Group-local routing and dispatch of ``xf [g, n, d]`` by ``gates [g,
    n, E]``: ``(buf [g, E, C, d], top_w [g, n, K], pos [g, n*K] (each
    pair's row in ``[g*E*C]``), keep [g, n*K])``."""
    g, n, d = xf.shape
    E = gates.shape[-1]
    top_w, top_e, rank, keep = _route(gates, K, C)
    grp = torch.arange(g, device=xf.device)[:, None]
    pos = ((top_e.reshape(g, n * K) + grp * E) * C + rank.long()).reshape(-1)
    tok = (grp * n + torch.arange(n, device=xf.device).repeat_interleave(K)
           ).reshape(-1)
    keep_f = keep.reshape(-1)
    # scatter kept pairs into the buffer; dropped pairs go to a sink row
    buf = xf.new_zeros((g * E * C + 1, d))
    buf[torch.where(keep_f, pos, g * E * C)] = xf.reshape(g * n, d)[tok]
    return (buf[:g * E * C].reshape(g, E, C, d), top_w,
            pos.reshape(g, n * K), keep)


def _combine(out_buf: torch.Tensor, top_w: torch.Tensor, pos: torch.Tensor,
             keep: torch.Tensor) -> torch.Tensor:
    """Group-local combine: each kept pair's output row weighted by its
    router probability, summed per token in k order from zero in f32
    (JAX's scatter-add); ``[g, n, d]`` f32."""
    g, E, C, d = out_buf.shape
    n, K = top_w.shape[1:]
    pos, keep = pos.reshape(-1), keep.reshape(-1)
    gathered = out_buf.reshape(g * E * C, d)[torch.where(keep, pos, 0)]
    w = (top_w.reshape(-1) * keep).float()[:, None]
    contrib = (gathered.float() * w).reshape(g * n, K, d)
    out = torch.zeros((g * n, d), dtype=torch.float32,
                      device=out_buf.device)
    for k in range(K):
        out = out + contrib[:, k]
    return out.reshape(g, n, d)


def _experts(params: MoE, spec: MoESpec, buf: torch.Tensor) -> torch.Tensor:
    """The experts' MLPs over ``buf [G, E, C, d]`` as two batched products
    over ``[E, G*C, d]``."""
    G, E, C, d = buf.shape
    h = torch.bmm(buf.transpose(0, 1).reshape(E, G * C, d), params.w_in)
    if spec.act in ("swiglu", "geglu"):
        gate, up = h.chunk(2, dim=-1)
        act = F.silu(gate) if spec.act == "swiglu" \
            else F.gelu(gate, approximate="tanh")
        h = act * up
    else:
        h = F.gelu(h, approximate="tanh")
    out = torch.bmm(h, params.w_out)                      # [E, G*C, d]
    return out.reshape(E, G, C, d).transpose(0, 1)


def moe_apply(params: MoE, spec: MoESpec, x: torch.Tensor) -> torch.Tensor:
    """``x [B, S, d] -> [B, S, d]``: top-k routed, capacity-dropped.

    Dispatch is grouped: the ``B * S`` tokens split into G groups (G =
    ``current_hints().moe_groups()``, the data axes' size on a mesh, 1
    without one; 1 when G does not divide the tokens), each with its own
    capacity ``expert_capacity(spec, N // G)`` and its own slice of the
    ``[G, E, C, d]`` buffer, which the hints place over the groups and
    experts (``expert_buffer``; with ``moe_local_dispatch`` it is pinned
    dp-local on both sides of the experts first).  On a mesh the routing,
    scatter and combine run on each rank over its own groups
    (:func:`repro_torch.distributed.sharding.group_local`).  The layer is
    one ``moe`` span, its routing (router, top-k, dispatch) a
    ``moe.route`` span inside it."""
    with span("moe"):
        return _moe_apply(params, spec, x)


def _moe_apply(params: MoE, spec: MoESpec, x: torch.Tensor) -> torch.Tensor:
    from ..distributed.hints import current_hints
    from ..distributed.sharding import flat_ready, grad_flat, group_local
    hints = current_hints()
    x = flat_ready(x)
    B, S, d = x.shape
    N = B * S
    G = hints.moe_groups()
    if N % G:
        G = 1
    n = N // G
    C = expert_capacity(spec, n)
    xf = x.reshape(G, n, d)
    with span("moe.route"):
        gates = torch.softmax(xf.float() @ params.router, dim=-1)  # [G,n,E]
        buf, top_w, pos, keep = group_local(_dispatch, G)(
            xf, gates, spec.experts_per_token, C)
    if hints.moe_local_dispatch:
        buf = hints.expert_buffer_local(buf)
    buf = hints.expert_buffer(buf)
    out_buf = hints.expert_buffer(_experts(params, spec, buf))
    if hints.moe_local_dispatch:
        out_buf = hints.expert_buffer_local(out_buf)
    out = group_local(_combine, G)(out_buf, top_w, pos, keep)
    return grad_flat(out.reshape(B, S, d)).to(x.dtype)


def moe_aux_loss(params: MoE, spec: MoESpec, x: torch.Tensor
                 ) -> torch.Tensor:
    """Switch-style load-balance loss: ``E * sum(fraction routed top-1 x
    mean gate)``."""
    N = x.shape[0] * x.shape[1]
    gates = torch.softmax(x.reshape(N, -1).float() @ params.router, dim=-1)
    top1 = gates.argmax(dim=-1)
    frac = F.one_hot(top1, spec.num_experts).float().mean(0)
    return spec.num_experts * (frac * gates.mean(0)).sum()
