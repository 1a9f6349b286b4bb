"""Serving steps: decode (one token per lane per step) and prefill (port of
:mod:`repro.serve.serve_step`, dense family).

The decode step reads paged KV through the block tables (the paged
attention kernel on the card) and ends with exactly ONE support-core burst
(``decode_append``); the prefill's attention is the flash kernel on the
card.  PyTorch runs eagerly, so there is no compiled executable to count:
the JAX package's ``CountingJit`` has no counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..configs.base import ArchConfig
from ..core.paged_kv import (PagedKVConfig, PagedKVState, PagedTenants,
                             decode_append, init_paged_kv)
from ..models.decode import decode_hidden, decode_logits
from ..models.transformer import DenseLM, forward

I32 = torch.int32


class ServeState(NamedTuple):
    paged: PagedKVState
    tokens: torch.Tensor                 # [lanes] last sampled token


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
    is :class:`repro_torch.serve.engine.ServingEngine`)."""
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
                      tokens=torch.zeros((lanes,), dtype=I32, device=dev))


def make_decode_step(cfg: ArchConfig, kvcfg: PagedKVConfig,
                     tenants: PagedTenants):
    """Returns ``serve_step(params, state) -> (state, logits, DecodeStats)``.

    The step's one allocator burst goes through ``tenants.service``: the
    CUDA kernel when the state lives on the card.
    """
    def serve_step(params: DenseLM, state: ServeState):
        hidden, (new_k, new_v) = decode_hidden(
            params, cfg, state.paged, state.tokens)
        logits = decode_logits(params, hidden)
        next_tokens = logits.argmax(dim=-1).to(I32)
        paged, stats = decode_append(kvcfg, state.paged, new_k, new_v,
                                     tenants)
        return ServeState(paged=paged, tokens=next_tokens), logits, stats

    return serve_step


class PrefillResult(NamedTuple):
    """Output of the prefill: ``last_logits [B, V]`` at each sequence's
    last real position and ``kv`` = (k, v), each ``[B, L, T, KV, hd]``."""

    last_logits: torch.Tensor
    kv: Optional[tuple]


def make_family_prefill(cfg: ArchConfig):
    """Returns ``prefill(params, batch) -> PrefillResult`` for a batch of
    right-padded ``tokens [B, T]`` with real ``lengths [B]`` (causal
    masking keeps the padding invisible to the real positions)."""

    def prefill(params: DenseLM, batch: dict) -> PrefillResult:
        toks = batch["tokens"]
        lengths = batch["lengths"].long()
        logits, (ks, vs) = forward(params, toks, return_kv=True)
        rows = torch.arange(toks.shape[0], device=toks.device)
        last = logits[rows, lengths - 1]
        return PrefillResult(last, (ks.transpose(0, 1), vs.transpose(0, 1)))

    return prefill
