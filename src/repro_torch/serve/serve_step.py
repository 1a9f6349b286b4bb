"""Serving steps: decode (one token per lane per step) and prefill (port of
:mod:`repro.serve.serve_step`, dense, vlm and hybrid families).

The decode step reads paged KV through the block tables (the paged
attention kernel on the card) and ends with exactly ONE support-core burst
(``decode_append``); the prefill's attention is the flash kernel on the
card.  The hybrid family also threads the lanes' recurrent state
(``ServeState.rec``) through both.

Each shard of a multi-engine deployment builds its own decode step from
its own tenant set.  The JAX package shares one step across shards (class
ids as a traced operand) so that they share one compiled executable;
PyTorch runs eagerly and compiles nothing, so there is nothing to share:
the JAX package's ``CountingJit`` and its ``decode_compiles`` /
``decode_compile_us`` counters have no counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..configs.base import ArchConfig
from ..core.paged_kv import (PagedKVConfig, PagedKVState, PagedTenants,
                             decode_append, init_paged_kv)
from ..models.decode import (RecurrentState, decode_hidden, decode_logits,
                             init_recurrent_state)
from ..models.transformer import forward

I32 = torch.int32


class ServeState(NamedTuple):
    paged: PagedKVState
    tokens: torch.Tensor                 # [lanes] last sampled token
    rec: Optional[RecurrentState] = None  # hybrid: the lanes' recurrent state


def init_serve_state(
    cfg: ArchConfig,
    kvcfg: PagedKVConfig,
    lanes: int,
    tenants: PagedTenants,
    prefilled_len: int = 0,
) -> ServeState:
    """A serving state with ``lanes`` active sequences of ``prefilled_len``
    tokens, allocator metadata set up as if prefill had admitted them (the
    JAX package's decode dry-run/benchmark state; the real admission path
    is :class:`repro_torch.serve.engine.ServingEngine`).  The hybrid
    family's recurrent state starts at zero in ``kvcfg.dtype``."""
    paged = init_paged_kv(kvcfg, tenants)
    dev = paged.seq_lens.device
    ps = kvcfg.page_size
    N = kvcfg.num_pages
    n_pages = (prefilled_len + ps) // ps   # incl. page for the next token
    lane_ids = torch.arange(lanes, dtype=I32, device=dev)
    page_grid = torch.arange(kvcfg.max_pages_per_lane, dtype=I32, device=dev)
    live_per_lane = N // lanes
    n_live = min(n_pages, live_per_lane)
    rank = page_grid[None, :]
    live = (rank < n_live) & (page_grid[None, :] < n_pages)
    tbl = torch.where(live, lane_ids[:, None] * live_per_lane + rank, -1)

    pid = torch.arange(N, dtype=I32, device=dev)
    owner_lane = pid // live_per_lane
    used_mask = (owner_lane < lanes) & ((pid % live_per_lane) < n_live)
    used0 = used_mask.sum(dtype=I32)
    order = torch.argsort(used_mask.to(I32), stable=True)   # free ids first
    alloc = paged.alloc
    stack, top = alloc.free_stack.clone(), alloc.free_top.clone()
    owner, refc = alloc.owner.clone(), alloc.refcount.clone()
    used, peak = alloc.used.clone(), alloc.peak_used.clone()
    stack[0] = pid[order]
    top[0] = N - used0
    owner[0] = torch.where(used_mask, owner_lane, -1)
    refc[0] = used_mask.to(I32)
    used[0] = used0
    peak[0] = used0
    alloc = alloc._replace(free_stack=stack, free_top=top, owner=owner,
                           refcount=refc, used=used, peak_used=peak)
    paged = paged._replace(
        alloc=alloc, block_tables=tbl.to(I32),
        seq_lens=torch.full((lanes,), prefilled_len, dtype=I32, device=dev),
        active=torch.ones((lanes,), dtype=torch.bool, device=dev))
    return ServeState(paged=paged,
                      tokens=torch.zeros((lanes,), dtype=I32, device=dev),
                      rec=init_recurrent_state(cfg, lanes, kvcfg.dtype, dev))


def make_decode_step(cfg: ArchConfig, kvcfg: PagedKVConfig,
                     tenants: PagedTenants, defer_refill: bool = False):
    """Returns ``serve_step(params, state) -> (state, logits,
    DecodeStats)``, plus the step's
    :class:`~repro_torch.core.paged_kv.PendingDecodeOps` with
    ``defer_refill``.

    The step's one allocator burst goes through ``tenants.service``: the
    CUDA kernel when the state lives on the card.
    """
    def serve_step(params, state: ServeState):
        hidden, (new_k, new_v), rec = decode_hidden(
            params, cfg, state.paged, state.tokens, state.rec)
        logits = decode_logits(params, hidden)
        next_tokens = logits.argmax(dim=-1).to(I32)
        paged, *rest = decode_append(kvcfg, state.paged, new_k, new_v,
                                     tenants, defer_refill=defer_refill)
        return (ServeState(paged=paged, tokens=next_tokens, rec=rec), logits,
                *rest)

    return serve_step


class PrefillResult(NamedTuple):
    """Output of the prefill: ``last_logits [B, V]`` at each sequence's
    last real position (``None`` for the hybrid family), ``kv`` = (k, v),
    each ``[B, L_kv, T, KV, hd]``, and the hybrid family's per-layer
    ``states`` (``[L, B, ...]``, else ``None``)."""

    last_logits: Optional[torch.Tensor]
    kv: Optional[tuple]
    states: Optional[RecurrentState] = None


def make_family_prefill(cfg: ArchConfig):
    """Returns ``prefill(params, batch) -> PrefillResult`` for a batch of
    right-padded ``tokens [B, T]`` with real ``lengths [B]`` (causal
    masking keeps the padding invisible to the real positions).

    A vlm batch adds ``patches [B, P, d]``: they take positions ``[0, P)``,
    the tokens follow, the K/V cover all ``P + T`` rows and the last
    logits are row ``P + lengths - 1``.

    The hybrid family folds every token into its state, so its batches
    must be exact-length (the scheduler's exact buckets); it returns the
    states a decode continues from and no logits: the engine seeds a
    hybrid decode with the last prompt token (the JAX engine's
    ``recurrent_logits=False``).

    A prefix-cache hit adds ``prefix_k`` / ``prefix_v``, each ``[B, L, P,
    KV, hd]``: the cached K/V of absolute positions ``[0, P)``.  ``tokens``
    are then the uncached suffix, ``lengths`` count suffix tokens, and
    logits and K/V come back for the suffix alone."""

    def prefill(params, batch: dict) -> PrefillResult:
        toks = batch["tokens"]
        if cfg.family == "hybrid":
            (ks, vs), (ssm, conv) = params.prefill(toks)
            return PrefillResult(None, (ks.transpose(0, 1),
                                        vs.transpose(0, 1)),
                                 RecurrentState(ssm=ssm, conv=conv))
        pk = batch.get("prefix_k")
        last = batch["lengths"].long() - 1
        if cfg.family == "vlm" and batch.get("patches") is not None:
            logits, (ks, vs) = forward(params, toks, return_kv=True,
                                       prefix_embeds=batch["patches"])
            last = last + batch["patches"].shape[1]
        elif pk is None:
            logits, (ks, vs) = forward(params, toks, return_kv=True)
        else:
            logits, (ks, vs) = forward(
                params, toks, return_kv=True,
                prefix_kv=(pk.transpose(0, 1),
                           batch["prefix_v"].transpose(0, 1)),
                pos_offset=pk.shape[2])
        rows = torch.arange(toks.shape[0], device=toks.device)
        return PrefillResult(logits[rows, last],
                             (ks.transpose(0, 1), vs.transpose(0, 1)))

    return prefill
