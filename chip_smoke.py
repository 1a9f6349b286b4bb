#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing loudly (non-zero exit, no result line):

1.  card     -- the card's name and power limit, torch and CUDA versions;
2.  build    -- compile the three CUDA kernels from the checkout's sources
               (one ``nvcc`` each, ``sm_90a``, started together), print
               each build time and every kernel's ``-Xptxas -v`` lines
               (registers, shared memory, spills); the support-core kernel
               and the tensor-core flash kernel must not spill;
3.  kernels  -- each kernel against its plain PyTorch version on the card:
               the support-core burst bit for bit (directed cases, the
               sweep shapes, a large shape, a 50-burst trace, and the
               decode, release and all-NOP bursts of card-sized gemma3-1b
               pools of 35840 and 65536 pages, gated and ungated, each
               with its path and cluster size); paged decode
               attention and flash prefill attention over the JAX sweeps in
               f32 and bf16, the serving shapes of both configurations, the
               NO_BLOCK slot, shared vs private tables (bit-identical), the
               self mode on a pool layer with inactive lanes and a page
               boundary, and a ragged Tq; bf16 flash edge cases (T, window,
               hd and G swept, queries scaled by 8 so scores reach +-30);
               paged lanes spanning no, one and every split of the context,
               against both plain versions; two identical launches of each
               kernel bit-identical (the support core on its block and
               cluster paths); then times per launch at the serving
               shapes beside the plain version, the bound and, for flash,
               ``scaled_dot_product_attention`` (causal, or with a boolean
               band mask for the window; timed here only); the
               support-core burst also at the large shape, the pool's
               three bursts and one burst on the global path (a pool of
               131072 pages), beside the launch floor (a one-element fill);
4.  serve    -- deepseek-7b at its published widths (bf16, random weights
               from a seeded generator) serves 8 synthetic requests through
               the port's scheduler and engine: every support-core burst,
               decode attention and prefill attention of that run must be
               a kernel launch, and the allocator invariants must hold with
               no live page at the end; prints the median wall time of a
               prefill pass (ending in ``torch.cuda.synchronize()``);
4b. serve    -- gemma3-1b at its published widths (26 layers, windows of
               512 on five layers in six, GQA 4:1) the same way, with
               prompts of 600-1500 tokens so the window binds;
5.  device   -- the same requests at the reduced configs in f32 (TF32 off)
               through the port on ``cuda`` and on ``cpu``, for both
               architectures: allocator state and served tokens must be
               identical;
6.  result   -- one JSON line describing the kernels, then the last line
               ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM non-tensor f32 rate, per data sheet
TENSOR_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
FULL = 1 << 30                 # "no window"
SERVE_LANES = 4
# per architecture: pool shape, prompt mix and generation length
WORKLOADS = {
    "deepseek-7b": dict(seq=256, page=8, max_prompt=128, requests=8,
                        new_tokens=16, prompt_lens=None),
    "gemma3-1b": dict(seq=2048, page=16, max_prompt=1536, requests=8,
                      new_tokens=32, prompt_lens=(600, 1500)),
}
# the reduced configs of phase 5 (gemma3: one local and one global layer)
SMALL = dict(seq=256, page=8, max_prompt=128, requests=8, new_tokens=16)
SMALL_PROMPTS = {"deepseek-7b": None, "gemma3-1b": (65, 128)}
# a card-sized page pool: make_paged_config(gemma3-1b, seq_len=2048,
# lanes=256, page_size=16) gives 35840 pages (14.2 GiB of bf16 KV) and 256
# scratch slots; warm bursts put POOL_WARM pages in use across its lanes
POOL_LANES = 256
POOL_WARM = 26000
# the JAX kernel tests' sweeps (tests/test_kernels.py)
PAGED_SWEEP = [(3, 2, 4, 32, 8, 5), (2, 1, 8, 64, 16, 4), (2, 4, 1, 128, 8, 6),
               (1, 2, 2, 16, 4, 3)]
FLASH_SWEEP = [(32, 32, 4, 2, 32, True, FULL), (64, 64, 4, 1, 64, True, 24),
               (32, 32, 2, 2, 32, False, FULL), (64, 64, 8, 2, 128, True, FULL)]
TOL = {"paged": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
       "flash": {torch.float32: 2e-5, torch.bfloat16: 3e-2}}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# --------------------------------------------------------------------------
# phase 3, support core: kernel vs plain version
# --------------------------------------------------------------------------

def random_queue(rng, Q, C, N, R, dev, ops=None, lanes=8):
    """A random burst: ``lanes`` is a lane count, or the lane ids to draw
    from."""
    from repro_torch.core.packets import (FREE_ALL, OP_FREE, OP_MALLOC,
                                          OP_MALLOC_RUN, OP_NOP, OP_REFILL,
                                          make_queue)
    ops = ops if ops is not None else rng.choice(
        [OP_MALLOC, OP_REFILL, OP_MALLOC_RUN, OP_FREE, OP_FREE, OP_NOP], Q)
    args = np.where(ops == OP_FREE,
                    np.where(rng.rand(Q) < 0.5, FREE_ALL,
                             rng.randint(0, N + 2, Q)),
                    rng.randint(0, R + 2, Q))          # incl. 0 and overwide
    ids = np.arange(lanes) if np.isscalar(lanes) else np.asarray(lanes)
    return make_queue(ops, ids[rng.randint(0, len(ids), Q)],
                      rng.randint(-1, C + 1, Q), args, device=dev)


class Parity:
    """Runs the kernel and the plain version on the same scheduled bursts
    and requires every output to be identical."""

    def __init__(self):
        self.bursts = 0
        self.max_abs_err = 0

    def step(self, state, queue, R, gated=False):
        from repro_torch.core.hmq import schedule
        return self.step_scheduled(state, schedule(queue)[0], R, gated)

    def step_scheduled(self, state, sched, R, gated=False):
        from repro_torch.core.support_core import _step_scheduled_torch
        from repro_torch.kernels.support_core.ops import support_core_burst
        want = _step_scheduled_torch(state, sched, R, gated=gated)
        got = support_core_burst(state, sched, R, gated=gated)
        pairs = list(zip(want[0], got[0])) + [(want[1], got[1]),
                                              (want[2], got[2])]
        names = list(state._fields) + ["blocks", "ok"]
        for name, (a, b) in zip(names, pairs):
            err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
            self.max_abs_err = max(self.max_abs_err, err)
            if not torch.equal(a, b):
                fail(f"kernel != plain on {name} (burst {self.bursts}, "
                     f"Q={sched.capacity} C={state.num_classes} "
                     f"N={state.max_capacity} R={R} gated={gated})")
        self.bursts += 1
        return got[0]


def card_pool(dev, pages: int, warm: int = POOL_WARM, seed: int = 11):
    """A pool of classes ``[pages, POOL_LANES]`` with about ``warm`` pages in
    use across lanes 0-255, from seeded warm bursts of up to 512 mallocs of
    1-8 pages (R = 8), as an admitted batch of ~1000-token prompts leaves
    it.  The plain version runs them, so the state does not depend on the
    kernel under test."""
    from repro_torch.core.freelist import init_freelist
    from repro_torch.core.hmq import schedule
    from repro_torch.core.packets import OP_MALLOC, make_queue
    from repro_torch.core.support_core import _step_scheduled_torch
    rng = np.random.RandomState(seed)
    wants = rng.randint(1, 9, 2 * warm // 4)
    wants = wants[:int(np.searchsorted(np.cumsum(wants), warm)) + 1]
    state = init_freelist([pages, POOL_LANES], device=dev)
    for lo in range(0, len(wants), 512):
        w = wants[lo:lo + 512]
        q = make_queue(np.full(len(w), OP_MALLOC),
                       (np.arange(len(w)) + lo) % POOL_LANES,
                       np.zeros(len(w), int), w, capacity=512, device=dev)
        state = _step_scheduled_torch(state, schedule(q)[0], 8)[0]
    return state


def pool_bursts(dev, state, seed: int = 12) -> dict:
    """The pool's three bursts, scheduled, as ``(sched, R)``: the live
    decode burst (each lane's MALLOC(1) slot live for ~1/16 of the lanes,
    its REFILL(8) slot for ~1/8, the rest NOP: Q = 512), the release burst
    (32 FREE_ALLs of distinct lanes and 32 single frees of owned pages: Q =
    64) and the all-NOP decode burst.  The live and release mixes are
    synthetic: their rates are set here, not taken from a serve (with
    16-token pages and a stash refill of 8, a lane's REFILL is due about
    once in 128 steps, so a 256-lane step would carry ~2, not ~32)."""
    from repro_torch.core.hmq import schedule
    from repro_torch.core.packets import (FREE_ALL, OP_FREE, OP_MALLOC,
                                          OP_NOP, OP_REFILL, make_queue)
    rng = np.random.RandomState(seed)
    lanes = np.repeat(np.arange(POOL_LANES), 2)
    slot = np.tile([OP_MALLOC, OP_REFILL], POOL_LANES)
    live = rng.rand(2 * POOL_LANES) < np.tile([1 / 16, 1 / 8], POOL_LANES)
    ops = np.where(live, slot, OP_NOP)
    zeros = np.zeros(2 * POOL_LANES, int)
    decode = make_queue(ops, lanes, zeros, np.where(slot == OP_MALLOC, 1, 8),
                        device=dev)
    nop = make_queue(zeros, lanes, zeros, zeros, device=dev)
    owner = state.owner[0].cpu().numpy()
    pages = rng.choice(np.flatnonzero(owner >= 0), 32, replace=False)
    fa_lanes = rng.choice(POOL_LANES, 32, replace=False)
    release = make_queue(np.full(64, OP_FREE),
                         np.concatenate([fa_lanes, owner[pages]]),
                         np.zeros(64, int),
                         np.concatenate([np.full(32, FREE_ALL), pages]),
                         device=dev)
    return {name: (schedule(q)[0], 8) for name, q in
            (("decode", decode), ("release", release), ("all_nop", nop))}


def plan_of(Q: int, C: int, N: int) -> str:
    from repro_torch.kernels.support_core.ops import card_plan
    plan = card_plan(Q, C, N)
    return f"{plan.path} path, cluster {plan.cluster} x {plan.slice} ids"


def kernel_parity(dev) -> Parity:
    from repro_torch.core.freelist import init_freelist, validate_freelist
    from repro_torch.core.packets import (FREE_ALL, OP_FREE, OP_MALLOC,
                                          OP_MALLOC_RUN, OP_NOP, OP_REFILL,
                                          make_queue)
    par = Parity()

    def trace(caps, steps, R):
        state = init_freelist(caps, device=dev)
        for reqs in steps:
            q = make_queue(*zip(*reqs), device=dev)
            state = par.step(state, q, R)
            validate_freelist(state)

    # directed corners (the JAX package's directed suites)
    trace([3, 2], [
        [(OP_MALLOC, 0, 0, 2), (OP_MALLOC, 1, 0, 4), (OP_MALLOC, 2, 0, 2),
         (OP_FREE, 0, 0, FREE_ALL)],
        [(OP_FREE, 0, 0, 2), (OP_FREE, 0, 0, 2), (OP_FREE, 3, 0, 1),
         (OP_FREE, 4, 1, FREE_ALL)],
        [(OP_MALLOC, 2, 1, 2), (OP_FREE, 2, 0, FREE_ALL),
         (OP_FREE, 2, 1, FREE_ALL)],
        [(OP_REFILL, 1, 0, 3), (OP_MALLOC, 0, 0, 1),
         (OP_FREE, 1, 0, FREE_ALL)],
        [(OP_MALLOC_RUN, 3, 1, 1), (OP_MALLOC, 3, 0, 0),
         (OP_MALLOC, 3, 0, -2), (OP_NOP, 0, 0, 0)],
    ], R=3)
    trace([4, 6], [
        [(OP_MALLOC, 0, 0, 2), (OP_MALLOC, 1, 0, 2),
         (OP_MALLOC, 0, 1, 3), (OP_MALLOC, 1, 1, 3)],
        [(OP_MALLOC, 2, 0, 1), (OP_MALLOC, 2, 1, 1)],
        [(OP_FREE, 0, 0, FREE_ALL), (OP_FREE, 1, 0, FREE_ALL),
         (OP_FREE, 0, 1, FREE_ALL), (OP_FREE, 1, 1, FREE_ALL)],
        [(OP_MALLOC, 3, 0, 4), (OP_MALLOC, 3, 1, 4)],
    ], R=4)
    trace([2], [[(OP_MALLOC, 0, 0, 2), (OP_MALLOC, 1, 0, 8)],
                [(OP_FREE, 0, 0, FREE_ALL)], [(OP_MALLOC, 1, 0, 2)]], R=8)
    # the gate: an all-NOP burst leaves everything (peak too) unchanged
    state = init_freelist([5, 3], device=dev)
    state = par.step(state, make_queue([OP_MALLOC], [0], [0], [2],
                                       device=dev), 2)
    par.step(state, make_queue([OP_NOP] * 4, [0] * 4, [0] * 4, [0] * 4,
                               device=dev), 2, gated=True)

    # the sweep shapes of the JAX kernel tests, plus the large shape
    rng = np.random.RandomState(0)
    for Q, C, N, R, scarce, steps in [
            (16, 2, 32, 4, False, 3), (64, 4, 128, 8, False, 3),
            (32, 3, 16, 4, True, 3), (256, 8, 65536, 8, False, 4)]:
        caps = [int(c) for c in (rng.randint(2, max(3, N // 4), C) if scarce
                                 else rng.randint(N // 2, N + 1, C))]
        state = init_freelist(caps, device=dev)
        warm = make_queue(np.full(Q, OP_MALLOC), rng.randint(0, 8, Q),
                          rng.randint(0, C, Q), rng.randint(1, R + 1, Q),
                          device=dev)
        state = par.step(state, warm, R)
        for _ in range(steps):
            state = par.step(state, random_queue(rng, Q, C, N, R, dev), R,
                             gated=bool(rng.rand() < 0.5))
            validate_freelist(state)
        print(f"  parity Q={Q} C={C} N={N} R={R}: ok ({plan_of(Q, C, N)})")

    # lane ids beyond 32 Q: FREE_ALL lanes by binary search, not the bitmap
    wide = rng.randint(0, 2**30, 8)
    for Q, C, N, R in ((64, 4, 128, 8), (512, 2, 35840, 8)):
        state = init_freelist([N] * C, device=dev)
        for step in range(4):
            state = par.step(state, random_queue(rng, Q, C, N, R, dev,
                                                 lanes=wide), R,
                             gated=step % 2 == 1)
            validate_freelist(state)
    print(f"  parity with lane ids up to 2**30: ok")

    # card-sized pools: each burst gated and ungated on the warm state; a
    # nearly full pool sends the decode burst down the sequential grant
    # path, and 131072 pages outgrow a cluster (the global path)
    for pages, warm in ((35840, POOL_WARM), (35840, 35700),
                        (65536, POOL_WARM), (131072, POOL_WARM)):
        state = card_pool(dev, pages, warm)
        for name, (sched, R) in pool_bursts(dev, state).items():
            for gated in (False, True):
                par.step_scheduled(state, sched, R, gated=gated)
        top = int(state.free_top[0])
        print(f"  parity pool [{pages}, {POOL_LANES}], {warm} pages in use "
              f"(top {top}): decode, release and all-NOP bursts, gated and "
              f"ungated, ok (Q=512: {plan_of(512, 2, pages)}; Q=64: "
              f"{plan_of(64, 2, pages)})")

    # 50 bursts at the serving classes (kv_pages 512, scratch 4), state
    # carried, with the admission / decode / release burst widths
    state = init_freelist([512, SERVE_LANES], device=dev)
    for _ in range(50):
        Q = int(rng.choice([8, 12, 24]))
        R = int(rng.choice([1, 7, 16]))
        state = par.step(state, random_queue(rng, Q, 2, 512, R, dev,
                                             lanes=SERVE_LANES), R,
                         gated=bool(rng.rand() < 0.5))
        validate_freelist(state)
    print(f"  parity: {par.bursts} bursts bit-identical, "
          f"max_abs_err={par.max_abs_err}")
    return par


def device_ms(fn, n: int = 100) -> float:
    """Median device time of ``fn``'s launches, from CUDA events.

    Each timed call is queued behind a GPU spin longer than the host takes
    to issue the call, so the events bracket the device work alone rather
    than the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(4 * host_s * 2e9) + 200_000
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def burst_bound_ms(Q: int, C: int, N: int, R: int) -> tuple[float, str]:
    """Least time for one burst: each input read once and each output
    written once over HBM bandwidth, against ~12 integer operations per
    metadata word over the CUDA cores' rate; the larger one."""
    words_in = 4 * Q + 3 * C * N + 6 * C
    words_out = 3 * C * N + 6 * C + Q * R + Q
    bytes_ms = 4 * (words_in + words_out) / HBM_BYTES_PER_S * 1e3
    ops_ms = (12 * C * N + 4 * Q * R) / CUDA_CORE_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def warm_burst(dev, Q, C, N, R, caps) -> tuple:
    """``(state, sched, R, gated=False)``: a random burst on a state that
    three random warm bursts (seed 1) have left."""
    from repro_torch.core.freelist import init_freelist
    from repro_torch.core.hmq import schedule
    from repro_torch.core.support_core import _step_scheduled_torch
    rng = np.random.RandomState(1)
    state = init_freelist(caps, device=dev)
    warm, _ = schedule(random_queue(rng, Q, C, N, R, dev))
    for _ in range(3):
        state = _step_scheduled_torch(state, warm, R)[0]
    sched, _ = schedule(random_queue(rng, Q, C, N, R, dev))
    return state, sched, R, False


def serve_burst(dev) -> tuple:
    """The burst at the serve's shape (Q=8 C=2 N=512 R=7)."""
    return warm_burst(dev, 2 * SERVE_LANES, 2, 512, 7, [512, SERVE_LANES])


def burst_cases(dev) -> dict:
    """The support-core bursts that are timed, as ``name: (state, sched, R,
    gated)``: the serve's shape, the large shape (Q=256 C=8 N=65536 R=8),
    the three bursts of the card-sized gemma3-1b pool (:func:`card_pool`;
    live decode and all-NOP gated, as ``decode_append`` commits them,
    release ungated) and the release burst of a pool of 131072 pages,
    which takes the global path."""
    cases = {"serve": serve_burst(dev),
             "large": warm_burst(dev, 256, 8, 65536, 8, [65536] * 8)}
    state = card_pool(dev, 35840)
    for name, (sched, R) in pool_bursts(dev, state).items():
        cases[f"pool_{name}"] = (state, sched, R, name != "release")
    state = card_pool(dev, 131072)
    cases["pool_131072_release"] = (state, *pool_bursts(dev, state)["release"],
                                    False)
    return cases


def time_burst(name, state, sched, R, gated) -> dict:
    from repro_torch.core.support_core import _step_scheduled_torch
    from repro_torch.kernels.support_core.ops import card_plan, \
        support_core_burst
    (C, N), Q = state.free_stack.shape, sched.capacity
    plan = card_plan(Q, C, N)
    ms = device_ms(lambda: support_core_burst(state, sched, R, gated=gated))
    plain_ms = device_ms(lambda: _step_scheduled_torch(state, sched, R,
                                                       gated=gated),
                         n=100 if Q <= 64 else 10)
    bound_ms, bound_by = burst_bound_ms(Q, C, N, R)
    mix = "synthetic mix, " if name.endswith(("decode", "release")) else ""
    print(f"  time {name} Q={Q} C={C} N={N} R={R} gated={gated} ({mix}"
          f"{plan.path} path, cluster {plan.cluster}): kernel "
          f"{ms * 1e3:.2f} us/launch, plain "
          f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.3f} us "
          f"({bound_by})")
    return dict(Q=Q, C=C, N=N, R=R, gated=gated, path=plan.path,
                cluster=plan.cluster, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def launch_floor_ms() -> float:
    """Device time of PyTorch's fill of one int32 word, by
    :func:`device_ms`: about what a launch costs by that clock, which no
    burst can go under."""
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    ms = device_ms(one.zero_)
    print(f"  launch floor: {ms * 1e3:.2f} us (a one-element fill)")
    return ms


# --------------------------------------------------------------------------
# phase 3, attention: kernels against their plain versions on the card
# --------------------------------------------------------------------------

class Errors:
    """Largest |kernel - plain| per kernel over every case checked."""

    def __init__(self):
        self.max = {"paged": 0.0, "flash": 0.0}

    def check(self, kind, what, got, want, dtype):
        err = float((got.float() - want.float()).abs().max())
        if not err <= TOL[kind][dtype]:        # NaN fails too
            fail(f"{kind} kernel != plain on {what}: max abs err {err:.3e} "
                 f"> {TOL[kind][dtype]}")
        self.max[kind] = max(self.max[kind], err)


def rand(rng, shape, dtype, dev):
    return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                           device=dev).to(dtype)


def paged_pool_case(rng, dev, dtype, B, KV, G, hd, ps, P, L, seq, active):
    """A port-shaped pool ``[N + 1, L, ps, KV, hd]`` (read through layer
    1's view), tables with lane i's pages granted for ``pos < seq[i]``, the
    rest NO_BLOCK, and the new tokens' queries and K/V."""
    n = B * P + 1
    pool_k = rand(rng, (n + 1, L, ps, KV, hd), dtype, dev)
    pool_v = rand(rng, (n + 1, L, ps, KV, hd), dtype, dev)
    perm = rng.permutation(n)[:B * P].reshape(B, P)
    used = np.arange(P)[None, :] * ps < np.asarray(seq)[:, None]
    tables = torch.as_tensor(np.where(used, perm, -1).astype(np.int32),
                             device=dev)
    return dict(q=rand(rng, (B, KV * G, hd), dtype, dev),
                k_pages=pool_k[:, 1], v_pages=pool_v[:, 1],
                block_tables=tables,
                seq_lens=torch.as_tensor(np.asarray(seq, np.int32),
                                         device=dev),
                k_self=rand(rng, (B, KV, hd), dtype, dev),
                v_self=rand(rng, (B, KV, hd), dtype, dev),
                active=torch.as_tensor(np.asarray(active, bool), device=dev))


def paged_args(case, window, self_mode):
    keys = ("q", "k_pages", "v_pages", "block_tables", "seq_lens")
    args = [case[k] for k in keys] + [window]
    extra = {k: case[k] for k in ("k_self", "v_self", "active")} \
        if self_mode else {}
    return args, extra


def paged_parity(dev, errs: Errors) -> None:
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention_op as op
    from repro_torch.kernels.paged_attention.ref import paged_attention_plain
    rng = np.random.RandomState(0)
    n_cases = 0
    for dt in (torch.float32, torch.bfloat16):
        for B, KV, G, hd, ps, P in PAGED_SWEEP:
            for window in (FULL, 19):
                seq = rng.randint(1, P * ps - 1, size=B)
                case = paged_pool_case(rng, dev, dt, B, KV, G, hd, ps, P, 2,
                                       seq, rng.rand(B) < 0.7)
                for self_mode in (False, True):
                    args, kw = paged_args(case, window, self_mode)
                    errs.check("paged", f"sweep B={B} KV={KV} G={G} hd={hd} "
                               f"w={window} self={self_mode} {dt}",
                               op(*args, **kw),
                               paged_attention_plain(*args, **kw), dt)
                    n_cases += 1
        # serving shapes: deepseek-7b, then gemma3-1b's local and global
        # layers; lane 1 at a page boundary, lane 2 inactive, lane 3 short
        for (KV, G, hd, ps, P, L, seq), windows in (
                ((32, 1, 128, 8, 33, 30, [119, 64, 40, 3]), (FULL,)),
                ((1, 4, 256, 16, 129, 26, [1400, 1024, 700, 611]),
                 (512, FULL))):
            case = paged_pool_case(rng, dev, dt, 4, KV, G, hd, ps, P, L, seq,
                                   [True, True, False, True])
            for window in windows:
                for self_mode in (False, True):
                    args, kw = paged_args(case, window, self_mode)
                    errs.check("paged", f"serving KV={KV} G={G} hd={hd} "
                               f"w={window} self={self_mode} {dt}",
                               op(*args, **kw),
                               paged_attention_plain(*args, **kw), dt)
                    n_cases += 1
        # tests/test_prefix_alias.py's case: position seq_len of lane 0 in
        # a NO_BLOCK slot (read as page 0); an aliased page must read
        # bit-identically to a private copy of it
        q = rand(rng, (2, 4, 32), dt, dev)
        kp, vp = rand(rng, (12, 8, 2, 32), dt, dev), rand(rng, (12, 8, 2, 32),
                                                          dt, dev)
        seq = torch.tensor([24, 22], dtype=torch.int32, device=dev)
        shared = torch.tensor([[0, 1, 2, -1], [0, 1, 3, -1]],
                              dtype=torch.int32, device=dev)
        private = torch.tensor([[0, 1, 2, -1], [10, 11, 3, -1]],
                               dtype=torch.int32, device=dev)
        kp2, vp2 = kp.clone(), vp.clone()
        kp2[10:12], vp2[10:12] = kp[0:2], vp[0:2]
        got = op(q, kp, vp, shared, seq)
        if not torch.equal(got, op(q, kp2, vp2, private, seq)):
            fail(f"paged kernel: shared and private tables differ ({dt})")
        errs.check("paged", f"NO_BLOCK slot {dt}", got,
                   paged_attention_plain(q, kp, vp, shared, seq, FULL), dt)
        n_cases += 2
    torch.cuda.synchronize()
    print(f"  paged attention: {n_cases} cases within tolerance, shared == "
          f"private bit for bit, max_abs_err={errs.max['paged']:.3e}")


def flash_parity(dev, errs: Errors) -> None:
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.RandomState(1)
    cases = [(2, *s) for s in FLASH_SWEEP] + [
        (2, 37, 37, 4, 1, 256, True, 16),          # ragged Tq, gemma heads
        (1, 100, 100, 2, 1, 16, True, FULL),       # ragged Tq
        (4, 128, 128, 32, 32, 128, True, FULL),    # deepseek-7b prefill
        (4, 1536, 1536, 4, 1, 256, True, 512),     # gemma3-1b local layer
        (4, 1536, 1536, 4, 1, 256, True, FULL)]    # gemma3-1b global layer
    for dt in (torch.float32, torch.bfloat16):
        for B, Tq, Tk, H, KV, hd, causal, window in cases:
            q = rand(rng, (B, Tq, H, hd), dt, dev)
            k = rand(rng, (B, Tk, KV, hd), dt, dev)
            v = rand(rng, (B, Tk, KV, hd), dt, dev)
            errs.check("flash", f"B={B} Tq={Tq} H={H} KV={KV} hd={hd} "
                       f"causal={causal} w={window} {dt}",
                       flash_attention_op(q, k, v, causal=causal,
                                          window=window),
                       flash_attention_ref(q, k, v, causal=causal,
                                           window=window), dt)
    torch.cuda.synchronize()
    print(f"  flash attention: {2 * len(cases)} cases within tolerance, "
          f"max_abs_err={errs.max['flash']:.3e}")


def flash_edge_parity(dev, errs: Errors) -> None:
    """The tensor-core kernel's edges in bf16: lengths around a 64-row
    tile, windows of 1, 100 and 512, every serving head width and group
    size; queries scaled by 8 so scores reach +-30 and the online softmax
    rescales with P rounded to bf16."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.RandomState(4)
    n = 0
    for T in (1, 63, 65, 200, 2048):
        for window in (1, 100, 512):
            for hd in (64, 128, 256):
                for G in (1, 4, 8):
                    q = (torch.as_tensor(rng.randn(1, T, 2 * G, hd)
                                         .astype(np.float32), device=dev)
                         * 8).to(torch.bfloat16)
                    k = rand(rng, (1, T, 2, hd), torch.bfloat16, dev)
                    v = rand(rng, (1, T, 2, hd), torch.bfloat16, dev)
                    errs.check("flash", f"edge T={T} w={window} hd={hd} "
                               f"G={G} bf16 x8",
                               flash_attention_op(q, k, v, window=window),
                               flash_attention_ref(q, k, v, window=window),
                               torch.bfloat16)
                    n += 1
    torch.cuda.synchronize()
    print(f"  flash attention: {n} bf16 edge cases within tolerance, "
          f"max_abs_err={errs.max['flash']:.3e}")


def paged_split_parity(dev, errs: Errors) -> None:
    """Lanes whose live range spans no split (inactive), one split,
    exactly one chunk, and every split, at the serving layouts, in both
    modes, against the plain version and the plain split-and-merge with
    the planner's chunk."""
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention_op as op
    from repro_torch.kernels.paged_attention.ops import plan_splits
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_plain, paged_attention_split)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.RandomState(5)
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        for KV, G, hd, ps, P in ((1, 4, 256, 16, 129), (32, 1, 128, 8, 33)):
            for window in (FULL, 512):
                splits, chunk = plan_splits(4, KV, G, P, ps, window, sms)
                seq = [5, chunk - 1, min(P * ps - 1, window + 40), 9]
                case = paged_pool_case(rng, dev, dt, 4, KV, G, hd, ps, P, 2,
                                       seq, [True, True, True, False])
                for self_mode in (False, True):
                    args, kw = paged_args(case, window, self_mode)
                    got = op(*args, **kw)
                    what = (f"split KV={KV} G={G} hd={hd} w={window} "
                            f"self={self_mode} {splits}x{chunk} {dt}")
                    errs.check("paged", what, got,
                               paged_attention_plain(*args, **kw), dt)
                    errs.check("paged", what + " (split plain)", got,
                               paged_attention_split(*args, chunk, **kw), dt)
                    n += 2
    torch.cuda.synchronize()
    print(f"  paged attention: {n} split cases within tolerance (lanes over "
          f"0, 1 and all splits), max_abs_err={errs.max['paged']:.3e}")


def determinism(dev) -> None:
    """Two identical launches of each kernel give identical bits."""
    from repro_torch.core.freelist import init_freelist
    from repro_torch.core.hmq import schedule
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention_op as op
    from repro_torch.kernels.support_core.ops import support_core_burst
    rng = np.random.RandomState(6)
    state = init_freelist([512, SERVE_LANES], device=dev)
    sched, _ = schedule(random_queue(rng, 24, 2, 512, 7, dev,
                                     lanes=SERVE_LANES))
    def burst(st, sc, R):
        new, blocks, ok = support_core_burst(st, sc, R)
        return (*new, blocks, ok)
    pool = card_pool(dev, 35840)
    psched, pR = pool_bursts(dev, pool)["decode"]
    runs = {"support core (block path)": lambda: burst(state, sched, 7),
            "support core (cluster path)": lambda: burst(pool, psched, pR)}
    case = paged_pool_case(rng, dev, torch.bfloat16, 4, 1, 4, 256, 16, 129,
                           2, [1400, 1024, 700, 611], [True] * 4)
    args, kw = paged_args(case, FULL, True)
    runs["paged"] = lambda: (op(*args, **kw),)
    q = rand(rng, (4, 1536, 4, 256), torch.bfloat16, dev)
    kv = rand(rng, (4, 1536, 1, 256), torch.bfloat16, dev)
    runs["flash"] = lambda: (flash_attention_op(q, kv, kv, window=FULL),)
    for name, fn in runs.items():
        a, b = fn(), fn()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"{name} kernel: two identical launches differ")
    print(f"  support core: {plan_of(24, 2, 512)}; "
          f"{plan_of(psched.capacity, 2, 35840)}")
    print(f"  determinism: two identical launches bit-identical for "
          f"{', '.join(runs)}")


def time_paged(dev, B, KV, G, hd, ps, P, L, seq, window) -> dict:
    """The decode call at a serving shape: bf16, self mode on one layer of
    an L-layer pool, every lane active."""
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention_op as op
    from repro_torch.kernels.paged_attention.ref import paged_attention_plain
    case = paged_pool_case(np.random.RandomState(2), dev, torch.bfloat16, B,
                           KV, G, hd, ps, P, L, seq, [True] * B)
    args, kw = paged_args(case, window, True)
    ms = device_ms(lambda: op(*args, **kw))
    plain_ms = device_ms(lambda: paged_attention_plain(*args, **kw))
    live = sum(min(s, window - 1) + 1 for s in seq)   # cached + self
    el = 2
    nbytes = (live * KV * hd * 2 + 2 * B * KV * G * hd) * el \
        + B * 4 * (1 + -(-max(seq) // ps))
    ops = 4 * hd * KV * G * live
    bound = max(nbytes / HBM_BYTES_PER_S, ops / TENSOR_BF16_OPS_PER_S) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / TENSOR_BF16_OPS_PER_S \
        else "operations"
    shape = dict(B=B, H=KV * G, KV=KV, hd=hd, ps=ps, P=P, seq_lens=list(seq),
                 window=window, live_tokens=live)
    print(f"  time paged {shape}: kernel {ms * 1e3:.2f} us/launch, plain "
          f"{plain_ms * 1e3:.1f} us, bound {bound * 1e3:.3f} us ({by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None, shape=shape)


def time_flash(dev, B, T, H, KV, hd, window) -> dict:
    """Causal bf16 prefill attention at a serving shape; the library
    yardstick is ``scaled_dot_product_attention`` (``is_causal``, or a
    boolean band mask for a window), timed here and called nowhere in the
    port."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.RandomState(3)
    q = rand(rng, (B, T, H, hd), torch.bfloat16, dev)
    k = rand(rng, (B, T, KV, hd), torch.bfloat16, dev)
    v = rand(rng, (B, T, KV, hd), torch.bfloat16, dev)
    ms = device_ms(lambda: flash_attention_op(q, k, v, causal=True,
                                              window=window), n=30)
    plain_ms = device_ms(lambda: flash_attention_ref(q, k, v, causal=True,
                                                     window=window), n=10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window >= T:
        library_ms = device_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                            enable_gqa=True), n=30)
    else:
        pos = torch.arange(T, device=dev)
        band = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - window)
        library_ms = device_ms(lambda: sdpa(qt, kt, vt, attn_mask=band,
                                            enable_gqa=True), n=30)
    pairs = sum(min(i + 1, window) for i in range(T))
    ops = 4 * hd * pairs * B * H
    nbytes = 2 * (2 * B * T * H * hd + 2 * B * T * KV * hd)
    t_ops, t_bytes = ops / TENSOR_BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    bound = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    shape = dict(B=B, T=T, H=H, KV=KV, hd=hd, window=window, pairs=pairs)
    print(f"  time flash {shape}: kernel {ms * 1e3:.2f} us/launch, plain "
          f"{plain_ms * 1e3:.1f} us, SDPA {library_ms * 1e3:.2f} us, bound "
          f"{bound * 1e3:.2f} us ({by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms, shape=shape)


# --------------------------------------------------------------------------
# phases 4 and 5: serving
# --------------------------------------------------------------------------

def make_requests(cfg, wl, prompt_lens):
    """``wl["requests"]`` requests from ``RandomState(0)``: the launcher's
    synthetic mix, or uniform prompt lengths in ``prompt_lens``."""
    from repro_torch.launch.serve import synth_requests
    from repro_torch.serve.scheduler import Request
    rng = np.random.RandomState(0)
    if prompt_lens is None:
        return synth_requests(cfg, wl["requests"], rng)
    lens = rng.randint(prompt_lens[0], prompt_lens[1] + 1, wl["requests"])
    return [Request(rid=i, tokens=rng.randint(0, cfg.vocab_size, size=int(n))
                    .astype(np.int32)) for i, n in enumerate(lens)]


def time_prefill_passes(eng, times_us: list) -> None:
    """Wrap the engine's prefill so that each pass's wall time, from a
    synchronised start to ``torch.cuda.synchronize()``, lands in
    ``times_us``."""
    inner = eng._prefill

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inner(*args, **kwargs)
        torch.cuda.synchronize()
        times_us.append((time.perf_counter() - t0) * 1e6)
        return res
    eng._prefill = timed


def serve(cfg, params, dtype, dev, wl, prompt_lens, verbose=False,
          prefill_us=None):
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import make_paged_config
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.scheduler import Scheduler, make_scheduler_config
    kvcfg = make_paged_config(cfg, seq_len=wl["seq"], lanes=SERVE_LANES,
                              page_size=wl["page"], dtype=dtype)
    scfg = make_scheduler_config(cfg, kvcfg, max_prompt_len=wl["max_prompt"])
    eng = ServingEngine(cfg, kvcfg, params, sched_cfg=scfg, device=dev)
    if prefill_us is not None:
        time_prefill_passes(eng, prefill_us)
    sched = Scheduler(scfg)
    reqs = make_requests(cfg, wl, prompt_lens)
    step_us: list = []
    steps = serve_loop(eng, sched, reqs, wl["new_tokens"], verbose=verbose,
                       step_times_us=step_us)
    return eng, sched, reqs, steps, step_us


def check_served(eng, sched, reqs) -> None:
    from repro_torch.core.paged_kv import validate_paged_kv
    if len(sched.finished) != len(reqs) or sched.failed or sched.waiting:
        fail(f"served {len(sched.finished)}/{len(reqs)} requests "
             f"({len(sched.failed)} failed, {len(sched.waiting)} waiting)")
    validate_paged_kv(eng.kvcfg, eng.state.paged, eng.tenants)
    if eng.live_pages != 0:
        fail(f"{eng.live_pages} KV pages still live after the last release")


def serve_full_width(dev, arch: str) -> dict:
    """One configuration at its published widths; returns each kernel's
    launches in that run, set to 0 just before it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import FLASH_KERNEL
    from repro_torch.kernels.paged_attention.ops import PAGED_KERNEL
    from repro_torch.kernels.support_core.ops import KERNEL
    from repro_torch.models import init_params
    cfg, wl = get_config(arch), WORKLOADS[arch]
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    print(f"  {arch}: {cfg.num_layers} layers (all), d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} KV heads x "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.attn_pattern} attention (window {cfg.window}), {cfg.act}, "
          f"bf16; weights drawn in {time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    KERNEL.launches = PAGED_KERNEL.launches = FLASH_KERNEL.launches = 0
    t0 = time.perf_counter()
    prefill_us: list = []
    eng, sched, reqs, steps, step_us = serve(cfg, params, torch.bfloat16,
                                             dev, wl, wl["prompt_lens"],
                                             verbose=True,
                                             prefill_us=prefill_us)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(support_core_burst=KERNEL.launches,
                    paged_decode_attention=PAGED_KERNEL.launches,
                    flash_attention=FLASH_KERNEL.launches)
    check_served(eng, sched, reqs)
    s, L = eng.stats, cfg.num_layers
    want = dict(support_core_burst=s.commits,
                paged_decode_attention=s.decode_steps * L,
                flash_attention=s.prefill_passes * L)
    for name, n in launches.items():
        if n <= 0 or n != want[name]:
            fail(f"{arch}: {name} launches {n} != {want[name]} expected "
                 f"from the engine's counters")
    decode_tokens = sum(len(r.output) for r in reqs) - len(reqs)
    prompts = [r.prompt_len for r in reqs]
    print(f"  served {len(sched.finished)}/{len(reqs)} requests (prompts "
          f"{min(prompts)}-{max(prompts)} tokens) in {steps} decode steps, "
          f"{wall:.2f}s wall; launches: support core {launches['support_core_burst']}"
          f" == commits ({s.hmq_admit_bursts} admit + {s.decode_steps} decode "
          f"+ {s.hmq_release_bursts} release), paged "
          f"{launches['paged_decode_attention']} == {s.decode_steps} decode "
          f"steps x {L}, flash {launches['flash_attention']} == "
          f"{s.prefill_passes} prefill passes x {L}; {s.decode_bursts} decode "
          f"bursts live")
    tps = decode_tokens / (sum(step_us) / 1e6)
    med = statistics.median(step_us) / 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    prefill_ms = statistics.median(prefill_us) / 1e3
    print(f"  decode {tps:.1f} tokens/s, median decode step {med:.2f} ms, "
          f"peak GPU memory {peak:.2f} GiB")
    print(f"  prefill: {len(prefill_us)} passes, median {prefill_ms:.2f} ms "
          f"wall (each {', '.join(f'{u / 1e3:.2f}' for u in prefill_us)} "
          f"ms)")
    for name, rep in eng.tenant_report().items():
        print(f"  {name}: {json.dumps(rep)}")
    del eng, params
    torch.cuda.empty_cache()
    return dict(launches=launches, tokens_per_s=tps, median_step_ms=med,
                peak_gib=peak, median_prefill_ms=prefill_ms)


def top2_margin(cfg, params_cpu, tokens) -> float:
    from repro_torch.models.transformer import forward
    logits = forward(params_cpu, torch.as_tensor(tokens)[None])[0, -1]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def device_vs_cpu(dev, arch: str) -> None:
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_config(arch)
    if cfg.attn_pattern == "local_global":
        cfg = dataclasses.replace(cfg, local_per_global=1)
    params_cpu = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to(dev)
    runs = {}
    for name, p, d in (("cuda", params_gpu, dev), ("cpu", params_cpu, "cpu")):
        eng, sched, reqs, steps, _ = serve(cfg, p, torch.float32, d, SMALL,
                                           SMALL_PROMPTS[arch])
        check_served(eng, sched, reqs)
        runs[name] = (eng, reqs, steps)
    (eg, rg, sg), (ec, rc, sc) = runs["cuda"], runs["cpu"]
    for a, b in zip(rg, rc):
        if a.output != b.output:
            i = next((i for i, (x, y) in enumerate(zip(a.output, b.output))
                      if x != y), min(len(a.output), len(b.output)))
            ctx = np.concatenate([b.tokens, np.asarray(b.output[:i],
                                                       np.int32)])
            fail(f"{arch}: request {a.rid} token {i} differs between cuda "
                 f"({a.output[i:i + 1]}) and cpu ({b.output[i:i + 1]}); top-2 "
                 f"logit margin on the cpu there: "
                 f"{top2_margin(cfg, params_cpu, ctx):.3e}")
    if sg != sc:
        fail(f"{arch}: {sg} decode steps on cuda, {sc} on cpu")
    ag, ac = eg.state.paged.alloc, ec.state.paged.alloc
    for field in ag._fields:
        if not torch.equal(getattr(ag, field).cpu(), getattr(ac, field)):
            fail(f"{arch}: allocator state field {field} differs between "
                 f"cuda and cpu")
    for field in ("block_tables", "seq_lens", "active", "scratch_slot"):
        if not torch.equal(getattr(eg.state.paged, field).cpu(),
                           getattr(ec.state.paged, field)):
            fail(f"{arch}: paged state field {field} differs between cuda "
                 f"and cpu")
    prompts = [r.prompt_len for r in rg]
    print(f"  {arch} ({cfg.num_layers} layers, windows "
          f"{[cfg.window] if cfg.window else 'none'}): cuda and cpu agree on "
          f"{sum(len(r.output) for r in rg)} tokens over {sg} decode steps "
          f"(prompts {min(prompts)}-{max(prompts)}), allocator state "
          f"bit-identical")


def kernel_signature(name: str) -> str:
    """A demangled kernel name without its return type, namespaces and
    parameter list: ``flash_mma_kernel<(int)256>``."""
    name = name.replace("<unnamed>::", "").replace("(anonymous namespace)::",
                                                   "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    head, sep, tail = name.removeprefix("void ").partition("<")
    return head.split("::")[-1] + sep + tail


NO_SPILL = ("flash_mma_kernel", "support_core_burst_kernel")


def print_ptxas(kernels) -> None:
    """Each kernel entry's registers, static shared memory and spills as
    ``-Xptxas -v`` printed them (demangled by the toolkit's ``cu++filt``
    when it has one); fails when the support-core kernel or the
    tensor-core flash kernel spills."""
    from repro_torch.kernels._build import _nvcc, ptxas_report
    filt = Path(_nvcc()).parent / "cu++filt"
    spills = []
    for k in kernels:
        rows = ptxas_report(k.build_log)
        if not rows:
            fail(f"{k.name}: no -Xptxas -v output in its build log")
        names = [r["name"] for r in rows]
        if filt.exists():
            res = subprocess.run([str(filt)], input="\n".join(names),
                                 capture_output=True, text=True)
            if res.returncode == 0 and len(res.stdout.splitlines()) == len(rows):
                names = res.stdout.splitlines()
        for r, name in zip(rows, names):
            short = kernel_signature(name)
            print(f"  ptxas {k.name}: {short}: {r['registers']} registers, "
                  f"{r['smem']} bytes static smem, {r['spill_stores']} / "
                  f"{r['spill_loads']} bytes spill stores / loads")
            if any(n in r["name"] for n in NO_SPILL) and (
                    r["spill_stores"] or r["spill_loads"]):
                spills.append(short)
    if spills:
        fail(f"kernels that must not spill do: {', '.join(spills)}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.flash_attention.ops import FLASH_KERNEL
    from repro_torch.kernels.paged_attention.ops import PAGED_KERNEL
    from repro_torch.kernels.support_core.ops import KERNEL

    print("== 1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    dev = torch.device("cuda")

    print("== 2. build")
    kernels = (KERNEL, PAGED_KERNEL, FLASH_KERNEL)
    build_all(kernels)
    for k in kernels:
        print(f"  built {k.so_path.name} in {k.build_seconds:.2f}s")
    print_ptxas(kernels)

    print("== 3. kernels against plain versions")
    par = kernel_parity(dev)
    t_burst = {name: time_burst(name, *case)
               for name, case in burst_cases(dev).items()}
    floor_ms = launch_floor_ms()
    errs = Errors()
    paged_parity(dev, errs)
    paged_split_parity(dev, errs)
    flash_parity(dev, errs)
    flash_edge_parity(dev, errs)
    determinism(dev)
    t_paged = {
        "deepseek-7b": time_paged(dev, 4, 32, 1, 128, 8, 33, 30,
                                  [119, 104, 87, 112], FULL),
        "gemma3-1b local": time_paged(dev, 4, 1, 4, 256, 16, 129, 26,
                                      [1400, 1024, 700, 611], 512),
        "gemma3-1b global": time_paged(dev, 4, 1, 4, 256, 16, 129, 26,
                                       [1400, 1024, 700, 611], FULL)}
    t_flash = {
        "deepseek-7b": time_flash(dev, 4, 128, 32, 32, 128, FULL),
        "gemma3-1b local": time_flash(dev, 4, 1536, 4, 1, 256, 512),
        "gemma3-1b global": time_flash(dev, 4, 1536, 4, 1, 256, FULL)}

    print("== 4. serve deepseek-7b at full width")
    served = {"deepseek-7b": serve_full_width(dev, "deepseek-7b")}
    print("== 4b. serve gemma3-1b at full width")
    served["gemma3-1b"] = serve_full_width(dev, "gemma3-1b")

    print("== 5. device against cpu")
    for arch in ("deepseek-7b", "gemma3-1b"):
        device_vs_cpu(dev, arch)

    print("== 6. result")

    def launches(name):
        by_run = {a: s["launches"][name] for a, s in served.items()}
        return dict(launches=sum(by_run.values()), launches_by_run=by_run)

    def timed(t, main_key):
        out = dict(t[main_key])
        out["other_shapes"] = {k: v for k, v in t.items() if k != main_key}
        return out

    kernels_line = [
        dict(name="support_core_burst", route="cuda",
             source="src/repro_torch/kernels/support_core/csrc/support_core.cu",
             replaces="src/repro/kernels/support_core/support_core_kernel.py:205",
             **launches("support_core_burst"), max_abs_err=par.max_abs_err,
             parity_bursts=par.bursts,
             **{k: t_burst["serve"][k] for k in ("ms", "plain_ms",
                                                 "bound_ms", "bound_by")},
             library_ms=None, launch_floor_ms=floor_ms,
             large_shape=t_burst["large"],
             pool_shapes={k: v for k, v in t_burst.items()
                          if k.startswith("pool_")}),
        dict(name="paged_decode_attention", route="cuda",
             source="src/repro_torch/kernels/paged_attention/csrc/"
                    "paged_attention.cu",
             replaces="src/repro/kernels/paged_attention/paged_attention.py:92",
             **launches("paged_decode_attention"),
             max_abs_err=errs.max["paged"],
             **timed(t_paged, "deepseek-7b")),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/flash_attention.py:83",
             **launches("flash_attention"), max_abs_err=errs.max["flash"],
             **timed(t_flash, "deepseek-7b")),
    ]
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
