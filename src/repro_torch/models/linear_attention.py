"""Chunked linear attention with data-dependent decay (port of
:mod:`repro.models.linear_attention`): the engine behind Mamba2's SSD, and
behind RWKV6 once that family is ported.

Both are linear recurrences over an outer-product state
``S_t = diag(w_t) S_{t-1} + k_t v_t^T`` read out by a query:

  Mamba2 : y_t = q_t · S_t              (decay per head, scalar; q=C, k=B, v=x)
  RWKV6  : y_t = q_t · (S_{t-1} + diag(u) k_t v_t^T)   (decay per channel)

The prefill form splits T into chunks of ``DEFAULT_CHUNK`` tokens: within a
chunk a masked quadratic term, across chunks only the ``[dk, dv]`` state.
Every decay ratio is ``exp`` of a difference of WITHIN-chunk log-decay
cumsums in f32, centered per (chunk, head, channel), so the exponent stays
below ``chunk * |LOG_DECAY_MIN|`` and ``exp`` stays finite.  The carry
across chunks is a sequential loop, in the JAX package's order.

Two flags give the two conventions:
  strict   -- mask j < i (RWKV6: the current token is read after the update)
  shifted  -- the query-side decay uses lp_{i-1} (RWKV6), not lp_i (Mamba2)

Everything here is plain PyTorch on either device: the JAX package has no
Pallas kernel for it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed.sharding import attention_axes, find_mesh, shard_map

LOG_DECAY_MIN = -8.0   # w >= e^-8 ~= 3.4e-4 per step
DEFAULT_CHUNK = 16     # exponent bound: 16 * 8 = 128 < log(f32 max) when centered

F32 = torch.float32


def _decay(log_decay: torch.Tensor, shape) -> torch.Tensor:
    return log_decay.to(F32).clamp(LOG_DECAY_MIN, 0.0).expand(shape)


def chunked_linear_attention(
    q: torch.Tensor,            # [B, T, H, dk]
    k: torch.Tensor,            # [B, T, H, dk]
    v: torch.Tensor,            # [B, T, H, dv]
    log_decay: torch.Tensor,    # [B, T, H, dk] or [B, T, H, 1] (<= 0)
    *,
    strict: bool = False,
    shifted: bool = False,
    bonus: Optional[torch.Tensor] = None,          # [H, dk] RWKV6 "u"
    initial_state: Optional[torch.Tensor] = None,  # [B, H, dk, dv]
    chunk: int = DEFAULT_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y [B, T, H, dv] f32, final_state [B, H, dk, dv] f32)``.
    On a mesh each rank runs it over its lanes and heads."""
    mesh = find_mesh((q, k, v, log_decay, bonus, initial_state))
    if mesh is not None:
        dp, m = attention_axes(mesh, q.shape[0], q.shape[2])
        seq, st = (dp, None, m, None), (dp, m, None, None)
        return shard_map(
            lambda q, k, v, ld, u, s0: chunked_linear_attention(
                q, k, v, ld, strict=strict, shifted=shifted, bonus=u,
                initial_state=s0, chunk=chunk), mesh,
            (seq, seq, seq, seq, (m, None), st), [seq, st])(
                q, k, v, log_decay, bonus, initial_state)
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    orig_T = T
    C = min(chunk, T)
    n = (T + C - 1) // C
    pad = n * C - T
    if pad:
        q, k, v, log_decay = (F.pad(x, (0, 0, 0, 0, 0, pad))
                              for x in (q, k, v, log_decay))
        T = n * C
    q, k, v = q.to(F32), k.to(F32), v.to(F32)
    lw = _decay(log_decay, (B, T, H, dk))

    qc = q.reshape(B, n, C, H, dk)
    kc = k.reshape(B, n, C, H, dk)
    vc = v.reshape(B, n, C, H, dv)
    lwc = lw.reshape(B, n, C, H, dk)

    lp = torch.cumsum(lwc, dim=2)                  # inclusive within-chunk cumsum
    lp_total = lp[:, :, -1]                        # [B, n, H, dk]
    lq = lp - lwc if shifted else lp               # query-side exponent
    # center the exponents per (chunk, head, channel)
    mid = 0.5 * (lq.amax(dim=2, keepdim=True) + lp.amin(dim=2, keepdim=True))
    qd = qc * torch.exp(lq - mid)
    kd_in = kc * torch.exp(mid - lp)
    kd_out = kc * torch.exp(lp_total[:, :, None] - lp)

    i = torch.arange(C, device=q.device)[:, None]
    j = torch.arange(C, device=q.device)[None, :]
    mask = (j < i) if strict else (j <= i)
    scores = torch.einsum("bnihd,bnjhd->bnhij", qd, kd_in)
    scores = torch.where(mask, scores, 0.0)
    y_intra = torch.einsum("bnhij,bnjhd->bnihd", scores, vc)
    if bonus is not None:                          # RWKV6 diag(u) k_t v_t^T
        diag = torch.einsum("bnihd,hd,bnihd->bnih", qc, bonus.to(F32), kc)
        y_intra = y_intra + diag[..., None] * vc

    kv_per_chunk = torch.einsum("bnihk,bnihv->bnhkv", kd_out, vc)
    state = initial_state.to(F32) if initial_state is not None \
        else torch.zeros((B, H, dk, dv), dtype=F32, device=q.device)
    decay_total = torch.exp(lp_total)[..., None]   # [B, n, H, dk, 1]
    entry = []                                     # state entering each chunk
    for c in range(n):
        entry.append(state)
        state = state * decay_total[:, c] + kv_per_chunk[:, c]
    entry_states = torch.stack(entry, dim=1)       # [B, n, H, dk, dv]

    y_inter = torch.einsum("bnihk,bnhkv->bnihv", qd * torch.exp(mid),
                           entry_states)
    y = (y_intra + y_inter).reshape(B, T, H, dv)
    return y[:, :orig_T], state


def linear_attention_ref(
    q, k, v, log_decay, *, strict=False, shifted=False, bonus=None,
    initial_state=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token scan oracle (slow, exact semantics).  ``shifted`` is a
    property of the chunked form only; the scan reads it off ``strict``."""
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    w = torch.exp(_decay(log_decay, (B, T, H, dk)))
    s = initial_state.to(F32) if initial_state is not None \
        else torch.zeros((B, H, dk, dv), dtype=F32, device=q.device)
    ys = []
    for t in range(T):
        qt, kt, vt, wt = (x[:, t].to(F32) for x in (q, k, v, w))
        kv = kt[..., None] * vt[..., None, :]
        if strict:          # RWKV6: read S_{t-1} (+ bonus), then update
            read = s
            if bonus is not None:
                read = read + (bonus.to(F32) * kt)[..., None] * vt[..., None, :]
            ys.append(torch.einsum("bhk,bhkv->bhv", qt, read))
            s = s * wt[..., None] + kv
        else:               # Mamba2: update, then read S_t
            s = s * wt[..., None] + kv
            ys.append(torch.einsum("bhk,bhkv->bhv", qt, s))
    return torch.stack(ys, dim=1), s


def linear_attention_decode_step(
    state: torch.Tensor,        # [B, H, dk, dv] f32
    q: torch.Tensor,            # [B, H, dk]
    k: torch.Tensor,
    v: torch.Tensor,            # [B, H, dv]
    log_decay: torch.Tensor,    # [B, H, dk] or [B, H, 1]
    *,
    strict: bool = False,
    bonus: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence (the serving path).  Returns ``(new_state,
    y [B, H, dv])``.  On a mesh each rank runs it over its lanes and
    heads."""
    mesh = find_mesh((state, q, k, v, log_decay, bonus))
    if mesh is not None:
        dp, m = attention_axes(mesh, q.shape[0], q.shape[1])
        st, row = (dp, m, None, None), (dp, m, None)
        return shard_map(
            lambda *a: linear_attention_decode_step(*a[:5], strict=strict,
                                                    bonus=a[5]), mesh,
            (st, row, row, row, row, (m, None)), [st, row])(
                state, q, k, v, log_decay, bonus)
    q, k, v = q.to(F32), k.to(F32), v.to(F32)
    w = torch.exp(_decay(log_decay, k.shape))
    kv = k[..., None] * v[..., None, :]
    if strict:
        read = state
        if bonus is not None:
            read = read + (bonus.to(F32) * k)[..., None] * v[..., None, :]
        y = torch.einsum("bhk,bhkv->bhv", q, read)
        state = state * w[..., None] + kv
    else:
        state = state * w[..., None] + kv
        y = torch.einsum("bhk,bhkv->bhv", q, state)
    return state, y
