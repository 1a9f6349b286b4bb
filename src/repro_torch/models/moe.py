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

**Dropless grouped products.**  Where the capacity factor drops no token
at any batch (``capacity_factor * K >= E``, :func:`dropless`) the buffer
would pad every expert to all ``N`` tokens: ``E / K`` times the expert
work.  One group without gradients then takes the grouped path instead
(:func:`_grouped_apply`) -- on the card where the buffer would hold more
than :data:`GROUPED_MIN_ROWS` rows (a decode step of a few experts keeps
the buffer) --: the (token, k) pairs sorted by expert, each of
the two expert products run once over the rows each expert received
(``torch._grouped_mm`` with device-side offsets on the card in bf16, so a
CUDA graph captures it; a loop over the experts on the CPU), and the
results combined as the buffer's are.  Its numbers are the buffer's
where the buffer drops nothing; the capacity path stays below that
factor, on a mesh, on ``meta`` and for a gradient (the JAX package's
arithmetic).  :data:`~repro_torch.tracing.COUNTERS` counts the rows the
router assigned to real tokens (``moe.rows_routed``; inside
:func:`real_rows` only those of the tokens its mask marks: a decode
step's active lanes, a prefill's prompt tokens) and every row the
products computed (``moe.rows_computed``, padding and idle lanes
included).

The router weight ``[d, E]`` is f32 in any model dtype and the logits are
``x.float() @ router``, as in the JAX package.  ``jax.lax.top_k`` breaks
ties toward the lower expert index; so does the stable descending sort
used here (``torch.topk`` promises no order among ties).
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.hmq import round_robin_rank
from ..tracing import COUNTERS, span
from .layers import dense_init


#: on the card, the capacity buffer's rows (``E * C``) at and below which
#: the buffer's batched products, bound by the experts' weight reads there,
#: run as fast as the grouped ones (H100, as CUDA graph replays: mixtral's
#: experts at 32 tokens 1086 us a layer against 1191 grouped, at 128 tokens
#: 1240 against 1214, at 256 tokens 1428 against 1231; mellum2's at 64
#: tokens, 4096 rows, 502 against 481)
GROUPED_MIN_ROWS = 1024


#: the open :func:`real_rows` scopes, innermost last: ``[mask, K summed
#: over the MoE calls inside]``
_REAL_ROWS: list = []


@contextlib.contextmanager
def real_rows(mask: torch.Tensor):
    """Inside, a MoE layer over as many tokens as ``mask`` has (bool,
    ``[B]`` or ``[B, S]``) counts as routed only the rows of the tokens it
    marks: a decode step's active lanes, a prefill's prompt tokens.  The
    count is added on the device once, at the scope's end, for every MoE
    call inside, so that a CUDA graph replay of the scope counts it too.
    Nothing is scoped on a mesh or ``meta`` (the layers count every row)."""
    from ..distributed.sharding import is_dtensor
    if is_dtensor(mask) or mask.device.type == "meta":
        yield
        return
    scope = [mask.reshape(-1), 0]
    _REAL_ROWS.append(scope)
    try:
        yield
    finally:
        _REAL_ROWS.pop()
    if scope[1]:
        COUNTERS.add_device(("moe.rows_routed",),
                            scope[0].sum(dtype=torch.int64)[None] * scope[1])


def _count_rows(routed: int, k: int, computed: int) -> None:
    """A MoE call's counts: ``routed`` tokens of ``k`` rows each (their
    real ones where a :func:`real_rows` scope covers them) and
    ``computed`` rows of the expert products."""
    scope = _REAL_ROWS[-1] if _REAL_ROWS else None
    if scope is not None and scope[0].numel() == routed:
        scope[1] += k
    else:
        COUNTERS.add("moe.rows_routed", routed * k)
    COUNTERS.add("moe.rows_computed", computed)


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


def dropless(spec: MoESpec) -> bool:
    """Whether the capacity keeps every (token, k) pair at any batch: a
    token picks ``K`` distinct experts, so ``ceil(N K cf / E) >= N``."""
    return spec.capacity_factor * spec.experts_per_token >= spec.num_experts


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
    out = torch.bmm(_expert_act(spec, h), params.w_out)   # [E, G*C, d]
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
    ``moe.route`` span and the experts' products a ``moe.experts`` span
    inside it.  A dropless spec without a mesh or a gradient takes the
    grouped path (module docstring)."""
    with span("moe"):
        if _grouped_engages(params, spec, x):
            return _grouped_apply(params, spec, x)
        return _moe_apply(params, spec, x)


def _grouped_engages(params: MoE, spec: MoESpec, x: torch.Tensor) -> bool:
    from ..distributed.hints import current_hints
    from ..distributed.sharding import is_dtensor
    hints = current_hints()
    if not dropless(spec) or x.device.type == "meta" or is_dtensor(x) \
            or hints.moe_groups() != 1 or hints.moe_local_dispatch:
        return False
    if any(t.requires_grad for t in (x, params.w_in, params.w_out,
                                     params.router)):
        return False
    if x.device.type == "cpu":
        return True
    rows = spec.num_experts * expert_capacity(spec, x.shape[0] * x.shape[1])
    return x.dtype == params.w_in.dtype == torch.bfloat16 \
        and rows > GROUPED_MIN_ROWS


def _grouped_apply(params: MoE, spec: MoESpec, x: torch.Tensor
                   ) -> torch.Tensor:
    """``x [B, S, d]`` through every token's top-k experts with no
    capacity: the pairs sorted by expert (ties in (token, k) order), the
    experts' MLPs over the rows each received (:func:`_grouped_experts`),
    each pair's output weighted and summed per token in k order from zero
    in f32, as :func:`_combine` sums."""
    B, S, d = x.shape
    N, K, E = B * S, spec.experts_per_token, spec.num_experts
    xf = x.reshape(N, d)
    with span("moe.route"):
        gates = torch.softmax(xf.float() @ params.router, dim=-1)   # [N, E]
        top_w, top_e = torch.sort(gates, dim=-1, descending=True,
                                  stable=True)
        top_w, top_e = top_w[:, :K], top_e[:, :K]
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
        flat_e = top_e.reshape(-1)                                  # [N*K]
        order = torch.argsort(flat_e, stable=True)
        # each expert's end row in the sorted pairs, on the device
        ends = torch.searchsorted(
            flat_e[order], torch.arange(E, device=x.device), right=True)
        rows = xf[order // K]                                       # [N*K, d]
    with span("moe.experts"):
        out_rows = _grouped_experts(params, spec, rows, ends)
    _count_rows(N, K, out_rows.shape[0])
    pairs = torch.empty_like(out_rows)
    pairs[order] = out_rows                          # back to (token, k)
    pairs = pairs.reshape(N, K, d)
    out = torch.zeros((N, d), dtype=torch.float32, device=x.device)
    for k in range(K):
        out = out + pairs[:, k].float() * top_w[:, k:k + 1]
    return out.reshape(B, S, d).to(x.dtype)


def _grouped_experts(params: MoE, spec: MoESpec, rows: torch.Tensor,
                     ends: torch.Tensor) -> torch.Tensor:
    """The experts' MLPs over ``rows [M, d]`` sorted by expert, expert
    ``e`` owning rows ``[ends[e-1], ends[e])``: two grouped products
    (``torch._grouped_mm``, offsets read on the device) on the card, a
    loop over the experts' slices on the CPU."""
    if rows.device.type == "cuda":
        offs = ends.to(torch.int32)
        h = torch._grouped_mm(rows, params.w_in, offs=offs)
        return torch._grouped_mm(_expert_act(spec, h), params.w_out,
                                 offs=offs)
    out = rows.new_empty((rows.shape[0], params.w_out.shape[-1]))
    start = 0
    for e, end in enumerate(ends.tolist()):
        if end > start:
            h = rows[start:end] @ params.w_in[e]
            out[start:end] = _expert_act(spec, h) @ params.w_out[e]
        start = end
    return out


def _expert_act(spec: MoESpec, h: torch.Tensor) -> torch.Tensor:
    """An expert's activation on its first product's output: the gated
    ``act(gate) * up`` or the plain tanh GELU."""
    if spec.act in ("swiglu", "geglu"):
        gate, up = h.chunk(2, dim=-1)
        act = F.silu(gate) if spec.act == "swiglu" \
            else F.gelu(gate, approximate="tanh")
        return act * up
    return F.gelu(h, approximate="tanh")


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
    with span("moe.experts"):
        out_buf = hints.expert_buffer(_experts(params, spec, buf))
    _count_rows(N, spec.experts_per_token, G * spec.num_experts * C)
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
