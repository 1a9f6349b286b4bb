#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing loudly (non-zero exit, no result line):

1. card     -- the card's name and power limit, torch and CUDA versions;
2. build    -- compile the support-core CUDA kernel from the checkout's
               sources (``nvcc``, ``sm_90a``) and print the build time;
3. kernel   -- the kernel against its plain PyTorch version on the card,
               bit for bit: directed cases, the sweep shapes, a large shape
               that takes the kernel's global-memory path, and a 50-burst
               seeded trace with state carried; times per launch at the
               serving shape and the large shape beside the plain version
               and the byte bound;
4. serve    -- deepseek-7b at its published widths (bf16, random weights
               from a seeded generator) serves 8 synthetic requests through
               the port's scheduler and engine; every support-core burst of
               that run must be a kernel launch, and the allocator
               invariants must hold with no live page at the end;
5. device   -- the same requests at the reduced config in f32 (TF32 off)
               through the port on ``cuda`` and on ``cpu``: allocator state
               and served tokens must be identical;
6. result   -- one JSON line describing the kernels, then the last line
               ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import copy
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
SERVE_ARCH = "deepseek-7b"
SERVE_LANES, SERVE_PAGE, SERVE_SEQ = 4, 8, 256
SERVE_REQUESTS, SERVE_NEW_TOKENS = 8, 16


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# --------------------------------------------------------------------------
# phase 3 helpers: kernel vs plain version
# --------------------------------------------------------------------------

def random_queue(rng, Q, C, N, R, dev, ops=None, lanes=8):
    from repro_torch.core.packets import (FREE_ALL, OP_FREE, OP_MALLOC,
                                          OP_MALLOC_RUN, OP_NOP, OP_REFILL,
                                          make_queue)
    ops = ops if ops is not None else rng.choice(
        [OP_MALLOC, OP_REFILL, OP_MALLOC_RUN, OP_FREE, OP_FREE, OP_NOP], Q)
    args = np.where(ops == OP_FREE,
                    np.where(rng.rand(Q) < 0.5, FREE_ALL,
                             rng.randint(0, N + 2, Q)),
                    rng.randint(0, R + 2, Q))          # incl. 0 and overwide
    return make_queue(ops, rng.randint(0, lanes, Q), rng.randint(-1, C + 1, Q),
                      args, device=dev)


class Parity:
    """Runs the kernel and the plain version on the same scheduled bursts
    and requires every output to be identical."""

    def __init__(self):
        self.bursts = 0
        self.max_abs_err = 0

    def step(self, state, queue, R, gated=False):
        from repro_torch.core.hmq import schedule
        from repro_torch.core.support_core import _step_scheduled_torch
        from repro_torch.kernels.support_core.ops import support_core_burst
        sched, _ = schedule(queue)
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
                     f"Q={queue.capacity} C={state.num_classes} "
                     f"N={state.max_capacity} R={R} gated={gated})")
        self.bursts += 1
        return got[0]


def kernel_parity(dev) -> Parity:
    from repro_torch.core.freelist import init_freelist, validate_freelist
    from repro_torch.core.packets import (FREE_ALL, OP_FREE, OP_MALLOC,
                                          OP_MALLOC_RUN, OP_NOP, OP_REFILL,
                                          make_queue)
    from repro_torch.kernels.support_core.ops import KERNEL
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
        path = "shared" if KERNEL.lib.support_core_in_smem(Q, N) else "global"
        print(f"  parity Q={Q} C={C} N={N} R={R}: ok ({path}-memory path)")

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


def time_burst(dev, Q, C, N, R, caps) -> dict:
    from repro_torch.core.freelist import init_freelist
    from repro_torch.core.hmq import schedule
    from repro_torch.core.support_core import _step_scheduled_torch
    from repro_torch.kernels.support_core.ops import support_core_burst
    rng = np.random.RandomState(1)
    state = init_freelist(caps, device=dev)
    warm, _ = schedule(random_queue(rng, Q, C, N, R, dev))
    for _ in range(3):
        state, _, _ = support_core_burst(state, warm, R)
    sched, _ = schedule(random_queue(rng, Q, C, N, R, dev))
    ms = device_ms(lambda: support_core_burst(state, sched, R))
    plain_ms = device_ms(lambda: _step_scheduled_torch(state, sched, R))
    bound_ms, bound_by = burst_bound_ms(Q, C, N, R)
    print(f"  time Q={Q} C={C} N={N} R={R}: kernel {ms * 1e3:.2f} us/launch, "
          f"plain {plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.3f} us "
          f"({bound_by}; far below launch latency)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


# --------------------------------------------------------------------------
# phases 4 and 5: serving
# --------------------------------------------------------------------------

def serve(cfg, params, dtype, dev, verbose=False):
    from repro_torch.launch.serve import serve_loop, synth_requests
    from repro_torch.models import make_paged_config
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.scheduler import Scheduler, make_scheduler_config
    kvcfg = make_paged_config(cfg, seq_len=SERVE_SEQ, lanes=SERVE_LANES,
                              page_size=SERVE_PAGE, dtype=dtype)
    scfg = make_scheduler_config(cfg, kvcfg, max_prompt_len=128)
    eng = ServingEngine(cfg, kvcfg, params, sched_cfg=scfg, device=dev)
    sched = Scheduler(scfg)
    reqs = synth_requests(cfg, SERVE_REQUESTS, np.random.RandomState(0))
    step_us: list = []
    steps = serve_loop(eng, sched, reqs, SERVE_NEW_TOKENS, verbose=verbose,
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


def serve_full_width(dev) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.support_core.ops import KERNEL
    from repro_torch.models import init_params
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    print(f"  {SERVE_ARCH}: {cfg.num_layers} layers (all), d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, bf16; weights drawn in "
          f"{time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    KERNEL.launches = 0
    t0 = time.perf_counter()
    eng, sched, reqs, steps, step_us = serve(cfg, params, torch.bfloat16,
                                             dev, verbose=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = KERNEL.launches
    check_served(eng, sched, reqs)
    if launches <= 0 or launches != eng.stats.commits:
        fail(f"support-core kernel launches {launches} != engine commits "
             f"{eng.stats.commits}")
    decode_tokens = sum(len(r.output) for r in reqs) - len(reqs)
    s = eng.stats
    print(f"  served {len(sched.finished)}/{len(reqs)} requests in {steps} "
          f"decode steps, {wall:.2f}s wall; kernel launches {launches} == "
          f"commits ({s.hmq_admit_bursts} admit + {s.decode_steps} decode + "
          f"{s.hmq_release_bursts} release), {s.decode_bursts} decode bursts "
          f"live")
    print(f"  decode {decode_tokens / (sum(step_us) / 1e6):.1f} tokens/s, "
          f"median decode step {statistics.median(step_us) / 1e3:.2f} ms, "
          f"peak GPU memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB")
    for name, rep in eng.tenant_report().items():
        print(f"  {name}: {json.dumps(rep)}")
    return dict(launches=launches)


def device_vs_cpu(dev) -> None:
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_config(SERVE_ARCH)
    params_cpu = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to(dev)
    runs = {}
    for name, p, d in (("cuda", params_gpu, dev), ("cpu", params_cpu, "cpu")):
        eng, sched, reqs, steps, _ = serve(cfg, p, torch.float32, d)
        check_served(eng, sched, reqs)
        runs[name] = (eng, reqs, steps)
    (eg, rg, sg), (ec, rc, sc) = runs["cuda"], runs["cpu"]
    if sg != sc or [r.output for r in rg] != [r.output for r in rc]:
        fail("served tokens differ between cuda and cpu")
    ag, ac = eg.state.paged.alloc, ec.state.paged.alloc
    for field in ag._fields:
        if not torch.equal(getattr(ag, field).cpu(), getattr(ac, field)):
            fail(f"allocator state field {field} differs between cuda and "
                 f"cpu")
    for field in ("block_tables", "seq_lens", "active", "scratch_slot"):
        if not torch.equal(getattr(eg.state.paged, field).cpu(),
                           getattr(ec.state.paged, field)):
            fail(f"paged state field {field} differs between cuda and cpu")
    print(f"  cuda and cpu agree: {sum(len(r.output) for r in rg)} tokens "
          f"over {sg} decode steps, allocator state bit-identical")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    from repro_torch.kernels.support_core.ops import KERNEL, build

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
    so = build()
    print(f"  built {so.name} in {KERNEL.build_seconds:.2f}s")

    print("== 3. kernel against plain version")
    par = kernel_parity(dev)
    t_serve = time_burst(dev, Q=2 * SERVE_LANES, C=2, N=512, R=7,
                         caps=[512, SERVE_LANES])
    t_large = time_burst(dev, Q=256, C=8, N=65536, R=8,
                         caps=[65536] * 8)

    print("== 4. serve at full width")
    served = serve_full_width(dev)

    print("== 5. device against cpu")
    device_vs_cpu(dev)

    print("== 6. result")
    kernels = [dict(
        name="support_core_burst", route="cuda",
        source="src/repro_torch/kernels/support_core/csrc/support_core.cu",
        replaces="src/repro/kernels/support_core/support_core_kernel.py:205",
        launches=served["launches"], max_abs_err=par.max_abs_err,
        ms=t_serve["ms"], plain_ms=t_serve["plain_ms"],
        bound_ms=t_serve["bound_ms"], bound_by=t_serve["bound_by"],
        library_ms=None,
        large_shape=dict(Q=256, C=8, N=65536, R=8, **t_large))]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
