"""Plain version of the allocator simulator's trace scan: the oracle of the
``sim_trace`` CUDA kernel and the CPU path of :mod:`repro_torch.sim.engine`.

It computes the JAX package's ``repro.sim.engine._run_trace`` (a
``lax.scan`` over the events with integer updates to a ``[T, C]`` state)
as an event loop over host integers:

* per (thread, class) the local tier's and the accelerator front-end's
  free counts, per class the shared tier's (initially 64);
* live, cached and peak bytes in int32 arithmetic (wrapping as JAX's
  int32 does); ``cached`` is kept as a running sum of each event's
  deltas, which equals JAX's full ``[T, C]`` reduction modulo 2**32;
* seven counters accumulated in float32 one event at a time, so past
  2**24 events a count stops growing exactly where JAX's does.

Each read is copied as JAX writes it: ``accel_push`` compares the event's
original ``accel`` (not the updated one), ``over`` reads the updated
``new_local``; an ``op`` other than 1 or 2 still subtracts its size from
the live bytes.  An event whose thread lies outside ``[0, T)`` or whose
class lies outside ``[0, C)`` raises ``ValueError`` (JAX clamps the read
and drops the write).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

_SPAN = 1 << 32
_HALF = 1 << 31


class SimCounts(NamedTuple):
    """One trace's structural counts; each a 0-d float32 tensor on the
    trace's device (host values once read back)."""

    mallocs: torch.Tensor
    frees: torch.Tensor
    fast_hits: torch.Tensor        # local cache hits (software path)
    accel_hits: torch.Tensor       # hardware front-end hits
    shared_trips: torch.Tensor     # refills/flushes touching the shared tier
    foreign_pushes: torch.Tensor   # cross-thread frees through shared metadata
    mmaps: torch.Tensor
    peak_bytes: torch.Tensor
    final_cached_bytes: torch.Tensor


def _i32(x: int) -> int:
    """``x`` wrapped to int32, as JAX's int32 arithmetic wraps."""
    return (x + _HALF) % _SPAN - _HALF


def trace_flags(policy) -> tuple[bool, bool, bool]:
    """``(central, stash_on, has_accel)``: the tier layout a policy
    selects, fixed for the whole trace."""
    central = policy.kind == "central"
    return central, central and policy.stash_cap > 0, policy.accel_cap > 0


def run_trace_plain(events, threads: int, policy,
                    sizes: Sequence[int]) -> SimCounts:
    """Scan ``events`` (``[4, E]`` int32 rows thread, op, size_class,
    foreign; a tensor or an array) under ``policy`` (a
    ``sim.policies.PolicySpec``) with ``threads`` threads and the
    per-class byte ``sizes``; the counts as 0-d float32 CPU tensors."""
    T, C = int(threads), len(sizes)
    sizes = [int(s) for s in sizes]
    rows = events.tolist()
    if len(rows) != 4:
        raise ValueError(f"events must have 4 rows, got {len(rows)}")
    rb, lcap, fkeep = policy.refill_batch, policy.local_cap, policy.flush_keep
    acap, scap = policy.accel_cap, policy.stash_cap
    central, stash_on, has_accel = trace_flags(policy)
    accel_refill = min(acap, 4)

    local = [0] * (T * C)
    accel = [0] * (T * C)
    shared = [64] * C
    live = cached = peak = 0
    one = np.float32(1.0)
    n_m = n_f = n_fast = n_accel = n_trip = n_foreign = n_mmap = \
        np.float32(0.0)
    for e, (t, op, c, fgn) in enumerate(zip(*rows)):
        if not (0 <= t < T and 0 <= c < C):
            raise ValueError(
                f"event {e}: thread {t} / size class {c} outside [0, {T}) x "
                f"[0, {C})")
        i = t * C + c
        lo, ac, sh, sz = local[i], accel[i], shared[c], sizes[c]
        is_m = op == 1
        is_f = op == 2
        if stash_on:
            # stash front-end over the central server
            local_hit = is_m and lo > 0
            miss = is_m and not local_hit
            need_mmap = accel_hit = False
            nlo = lo - 1 if local_hit else (lo + rb - 1 if miss else lo)
            nac, nsh = ac, sh
            foreign_f = is_f and fgn == 1
            own_f = is_f and not foreign_f
            push_ok = own_f and nlo < scap
            over = own_f and not push_ok
            if push_ok:
                nlo += 1
        else:
            accel_hit = is_m and has_accel and ac > 0 and not central
            local_hit = is_m and not accel_hit and lo > 0 and not central
            miss = is_m and not accel_hit and not local_hit and not central
            need_mmap = miss and sh < rb
            nsh = sh + 4 * rb if need_mmap else sh
            if miss:
                nsh -= rb
            nlo = lo - 1 if local_hit else (lo + rb - 1 if miss else lo)
            nac = ac - 1 if accel_hit else (
                accel_refill if miss and has_accel else ac)
            foreign_f = is_f and fgn == 1 and not central
            local_f = is_f and not foreign_f and not central
            accel_push = local_f and has_accel and ac < acap   # original ac
            if accel_push:
                nac += 1
            elif local_f:
                nlo += 1
            over = local_f and nlo > lcap                      # updated nlo
            if over:
                nsh += max(nlo - fkeep, 0)
            if foreign_f:
                nsh += 1
            if over:
                nlo = fkeep
        local[i], accel[i], shared[c] = nlo, nac, _i32(nsh)
        live = _i32(live + (sz if is_m else -sz))
        cached = _i32(cached + (nlo - lo + nac - ac) * sz)
        peak = max(peak, _i32(live + cached))
        if is_m:
            n_m += one
        if is_f:
            n_f += one
        if local_hit:
            n_fast += one
        if accel_hit:
            n_accel += one
        if miss or over:
            n_trip += one
        if foreign_f:
            n_foreign += one
        if need_mmap:
            n_mmap += one
    return SimCounts(*(torch.tensor(np.float32(v)) for v in (
        n_m, n_f, n_fast, n_accel, n_trip, n_foreign, n_mmap, peak, cached)))
