"""Serving steps: decode (one token per lane per step) and prefill (port of
:mod:`repro.serve.serve_step`, every family the port serves).

The decode step reads paged KV through the block tables (the paged
attention kernel on the card) and ends with exactly ONE support-core burst
(``decode_append``), which under sliding-window attention also frees the
pages that slid out of the window (:func:`recycle_window`), and on a split
cache (``PagedKVConfig.split_window``) those of its window tenant; the
prefill's attention is the flash kernel on the card.  The hybrid and
ssm families also thread the lanes' recurrent state (``ServeState.rec``)
through both.  The ssm family (rwkv6) has no K/V: its decode step issues
no burst and only advances the active lanes' ``seq_lens``.  The audio
family (whisper) keeps each lane's encoder output
(``ServeState.enc_out``), which its prefill computes and its decode
reads.

Each shard of a multi-engine deployment builds its own decode step from
its own tenant set.  The JAX package shares one step across shards (class
ids as a traced operand) so that they share one compiled executable;
PyTorch compiles nothing, so there is nothing to share: the JAX package's
``CountingJit`` and its ``decode_compiles`` / ``decode_compile_us``
counters have no counterpart here.  On the card each engine captures its
own step as a CUDA graph (:mod:`repro_torch.serve.decode_graph`), so the
step's shapes never depend on data and it never waits for the host.

A MoE model's layers count as routed only the rows of real tokens
(:func:`~repro_torch.models.moe.real_rows`): the decode step's active
lanes, the prefill's prompt tokens.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from ..configs.base import ArchConfig
from ..core.paged_kv import (PagedKVConfig, PagedKVState, PagedTenants,
                             PendingDecodeOps, decode_append,
                             empty_decode_stats, init_paged_kv, paged_tenants)
from ..distributed.hints import ShardingHints, use_hints
from ..distributed.sharding import replicated
from ..models.decode import (RecurrentState, decode_hidden, decode_logits,
                             init_recurrent_state)
from ..models.moe import real_rows
from ..models.transformer import forward, recycle_window
from ..tracing import span

I32 = torch.int32


class ServeState(NamedTuple):
    paged: PagedKVState
    tokens: torch.Tensor                 # [lanes] last sampled token
    rec: Optional[RecurrentState] = None  # hybrid, ssm: the lanes' state
    enc_out: Optional[torch.Tensor] = None  # audio: [lanes, F, d] encoder out


def init_enc_out(cfg: ArchConfig, lanes: int, dtype: torch.dtype,
                 device: torch.device) -> Optional[torch.Tensor]:
    """Zero encoder outputs ``[lanes, F, d]`` for the audio family, else
    ``None``."""
    if cfg.family != "audio":
        return None
    return torch.zeros((lanes, cfg.encoder_seq_len, cfg.d_model),
                       dtype=dtype, device=device)


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
    is :class:`repro_torch.serve.engine.ServingEngine`).  A recurrent
    state and whisper's encoder outputs start at zero in ``kvcfg.dtype``."""
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
                      rec=init_recurrent_state(cfg, lanes, kvcfg.dtype, dev),
                      enc_out=init_enc_out(cfg, lanes, kvcfg.dtype, dev))


def abstract_serve_state(cfg: ArchConfig, kvcfg: PagedKVConfig, lanes: int,
                         prefilled_len: int) -> tuple[ServeState, PagedTenants]:
    """:func:`init_serve_state` on the ``meta`` device (the dry run: shapes
    and dtypes, no storage), with the tenants its decode step commits
    to."""
    tenants = paged_tenants(kvcfg, "meta")
    return init_serve_state(cfg, kvcfg, lanes, tenants, prefilled_len), \
        tenants


def make_decode_step(cfg: ArchConfig, kvcfg: PagedKVConfig,
                     tenants: PagedTenants, defer_refill: bool = False,
                     hints: Optional[ShardingHints] = None):
    """Returns ``serve_step(params, state) -> (state, logits,
    DecodeStats)``, plus the step's
    :class:`~repro_torch.core.paged_kv.PendingDecodeOps` with
    ``defer_refill``.

    The step's one allocator burst goes through ``tenants.service``: the
    CUDA kernel when the state lives on the card.  An attention-free step
    (rwkv6) issues none: it advances the active lanes' ``seq_lens`` and
    returns all-zero stats (and no deferred refill).  Under ``swa`` the
    burst also recycles the pages behind the window
    (:func:`recycle_window`); on a split cache it serves both KV tenants,
    the window tenant recycling past ``kvcfg.split_window``.

    ``hints`` (a :class:`~repro_torch.distributed.hints.ShardingHints`
    over a mesh) runs the step on ``DTensor`` parameters and state placed
    by :mod:`repro_torch.distributed.sharding`, with the hints ambient.
    """
    window = recycle_window(cfg)

    def serve_step(params, state: ServeState):
        with use_hints(hints):
            return _serve_step(params, state)

    def _serve_step(params, state: ServeState):
        with span("decode.forward"), real_rows(state.paged.active):
            hidden, new_kv, rec = decode_hidden(
                params, cfg, state.paged, state.tokens, state.rec,
                state.enc_out, hints=hints)
            logits = decode_logits(params, hidden)
            next_tokens = replicated(logits).argmax(dim=-1).to(I32)
        if new_kv is not None:
            with span("decode.alloc"):
                paged, *rest = decode_append(
                    kvcfg, state.paged, *new_kv, tenants,
                    defer_refill=defer_refill, window=window)
        else:
            paged = state.paged._replace(
                seq_lens=state.paged.seq_lens + state.paged.active.to(I32))
            rest = [empty_decode_stats(kvcfg, tenants)]
            if defer_refill:
                none = torch.zeros_like(paged.active)
                rest.append(PendingDecodeOps(
                    below=none, flush_mask=none,
                    flush_blocks=torch.full_like(paged.seq_lens, -1)))
        return (state._replace(paged=paged, tokens=next_tokens, rec=rec),
                logits, *rest)

    return serve_step


class PrefillResult(NamedTuple):
    """Output of the prefill: ``last_logits [B, V]`` at each sequence's
    last real position (``None`` for the recurrent families), ``kv`` =
    (k, v), each ``[B, L_kv, T, KV, hd]`` (``None`` for rwkv6), the
    recurrent families' per-layer ``states`` (``[L, B, ...]``, else
    ``None``) and whisper's ``enc_out [B, F, d]``."""

    last_logits: Optional[torch.Tensor]
    kv: Optional[tuple]
    states: Optional[RecurrentState] = None
    enc_out: Optional[torch.Tensor] = None


def make_family_prefill(cfg: ArchConfig,
                        hints: Optional[ShardingHints] = None):
    """Returns ``prefill(params, batch) -> PrefillResult`` for a batch of
    right-padded ``tokens [B, T]`` with real ``lengths [B]`` (causal
    masking keeps the padding invisible to the real positions).

    A vlm batch adds ``patches [B, P, d]``: they take positions ``[0, P)``,
    the tokens follow, the K/V cover all ``P + T`` rows and the last
    logits are row ``P + lengths - 1``.

    The recurrent families fold every token into their state, so their
    batches must be exact-length (the scheduler's exact buckets); they
    return the states a decode continues from and no logits: the engine
    seeds their decode with the last prompt token (the JAX engine's
    ``recurrent_logits=False``).  rwkv6 returns no K/V.

    An audio batch adds ``frames [B, F, d]``: the encoder runs over them
    once, the decoder's cross-attention reads its output, which comes back
    as ``enc_out``.

    A prefix-cache hit adds ``prefix_k`` / ``prefix_v``, each ``[B, L, P,
    KV, hd]``: the cached K/V of absolute positions ``[0, P)``.  ``tokens``
    are then the uncached suffix, ``lengths`` count suffix tokens, and
    logits and K/V come back for the suffix alone.

    ``hints``: :func:`make_decode_step`'s."""

    def prefill(params, batch: dict) -> PrefillResult:
        with use_hints(hints):
            return _prefill(params, batch)

    def _prefill(params, batch: dict) -> PrefillResult:
        toks = batch["tokens"]
        if cfg.family == "ssm":
            wkv, tm, cm = params.prefill(toks)
            return PrefillResult(None, None, RecurrentState(
                ssm=wkv, tm_prev=tm, cm_prev=cm))
        if cfg.family == "hybrid":
            (ks, vs), (ssm, conv) = params.prefill(toks)
            return PrefillResult(None, (ks.transpose(0, 1),
                                        vs.transpose(0, 1)),
                                 RecurrentState(ssm=ssm, conv=conv))
        with _prompt_rows(toks, batch["lengths"]):
            return _prefill_attn(params, batch)

    def _prompt_rows(toks, lengths):
        if cfg.family != "moe":
            return contextlib.nullcontext()
        pos = torch.arange(toks.shape[1], device=toks.device)
        return real_rows(pos[None, :] < lengths[:, None])

    def _prefill_attn(params, batch: dict) -> PrefillResult:
        toks = batch["tokens"]
        pk = batch.get("prefix_k")
        last = batch["lengths"].long() - 1
        enc_out = None
        if cfg.family == "audio":
            logits, (ks, vs), enc_out = params.prefill(toks, batch["frames"])
        elif cfg.family == "vlm" and batch.get("patches") is not None:
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
                             (ks.transpose(0, 1), vs.transpose(0, 1)),
                             enc_out=enc_out)

    return prefill


def make_prefill_step(cfg: ArchConfig, hints: Optional[ShardingHints] = None):
    """The dry run's prefill: ``(params, batch) -> (logits [B, 1, V] at the
    last position, (k, v) [L, B, S, KV, hd] or None)`` over
    :func:`make_family_prefill` (the JAX package's historical contract).
    A batch without ``lengths`` is full-length; the recurrent families
    return no logits (their admission reads none) and the hybrid no K/V,
    as in the JAX step."""
    fam = make_family_prefill(cfg, hints=hints)

    def prefill_step(params, batch: dict):
        if "lengths" not in batch:
            B, T = batch["tokens"].shape
            batch = dict(batch, lengths=torch.full(
                (B,), T, dtype=I32, device=batch["tokens"].device))
        res = fam(params, batch)
        kv = None
        if res.kv is not None and cfg.family != "hybrid":
            kv = (res.kv[0].transpose(0, 1), res.kv[1].transpose(0, 1))
        last = None if res.last_logits is None else res.last_logits[:, None]
        return last, kv

    return prefill_step
