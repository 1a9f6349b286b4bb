"""Serving launcher of the port: ``python -m repro_torch.launch.serve``.

The single-engine path of ``repro.launch.serve``: Larson-style synthetic
requests flow through the scheduler into one :class:`ServingEngine`; each
admission batch, decode step and release is one support-core burst (one
CUDA kernel launch on the card).  ``--device`` picks ``cuda`` (default) or
``cpu`` in place of the JAX launcher's ``--alloc-backend``.  Prints
allocator and scheduler telemetry.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import ARCH_IDS, smoke_config
from ..models import init_params, make_paged_config
from ..serve.engine import ServingEngine, run_admission
from ..serve.scheduler import Request, Scheduler, make_scheduler_config


def synth_requests(cfg, n: int, rng: np.random.RandomState,
                   priority_every: int = 0) -> list[Request]:
    """Larson-style synthetic request mix (the JAX launcher's, draw for
    draw).  ``priority_every=k`` marks every k-th request priority 1."""
    reqs = []
    for rid in range(n):
        plen = int(rng.pareto(2.0) * 20) % 96 + 8
        reqs.append(Request(
            rid=rid,
            tokens=rng.randint(0, cfg.vocab_size, size=plen).astype(np.int32),
            priority=1 if priority_every and rid and rid % priority_every == 0
            else 0,
        ))
    return reqs


def serve_loop(eng: ServingEngine, sched: Scheduler,
               requests: list[Request], max_new_tokens: int,
               log_every: int = 8, verbose: bool = True,
               step_times_us: list | None = None,
               preemption: bool = False) -> int:
    """Drive the scheduler/engine lifecycle until every request completes;
    returns the number of decode steps.  ``step_times_us`` collects each
    decode step's wall time (the step ends in a host copy of its tokens,
    so the time covers the device work)."""
    for req in requests:
        req.max_new_tokens = max_new_tokens
        sched.submit(req)

    step = 0
    while sched.has_work:
        progressed = run_admission(eng, sched, preemption=preemption)
        if not sched.running:
            if progressed:
                continue
            break                      # nothing admissible: pool too small
        t0 = time.perf_counter()
        tokens = eng.step()
        if step_times_us is not None:
            step_times_us.append((time.perf_counter() - t0) * 1e6)
        step += 1
        finished = sched.note_decode_step(tokens)
        if finished:
            eng.release(finished)
            sched.complete(finished)
        if verbose and step % log_every == 0:
            print(f"step {step}: done={len(sched.finished)}/{len(requests)} "
                  f"waiting={len(sched.waiting)} live_pages={eng.live_pages}")
    if sched.waiting:
        print(f"WARNING: admission starved — {len(sched.waiting)} request(s) "
              f"not served (page budget {eng.free_pages} free - "
              f"{sched.scfg.page_reserve} reserve cannot fit the next one)")
    return step


def report(eng: ServingEngine, sched: Scheduler, steps: int) -> None:
    """Print the run's allocator + scheduler telemetry."""
    a = eng.state.paged.alloc
    s = eng.stats
    kv = eng.tenants.kv.size_class
    kvcfg = eng.kvcfg
    if sched.failed:
        print(f"FAILED: {len(sched.failed)} request(s) rejected by the "
              f"allocator")
    print(f"served {len(sched.finished)} requests in {steps} decode steps on "
          f"{eng.device} | stash={kvcfg.stash_size}/{kvcfg.stash_watermark}"
          f"/{kvcfg.stash_refill} | allocs={int(a.alloc_count[kv])} "
          f"frees={int(a.free_count[kv])} fails={int(a.fail_count[kv])} "
          f"peak_pages={int(a.peak_used[kv])} live={eng.live_pages} | "
          f"admit_bursts={s.hmq_admit_bursts} "
          f"release_bursts={s.hmq_release_bursts} "
          f"preemptions={s.preemptions} | "
          f"stash_hit_rate={s.stash_hit_rate:.2f} "
          f"decode_bursts/1k={s.hmq_bursts_per_1k_decode_steps:.0f} "
          f"stash_depth_hist={s.stash_depth_hist}")
    print(f"burst_occupancy={s.burst_occupancy:.2f} | tenants:")
    for name, rep in eng.tenant_report().items():
        acc = s.tenants.get(name, {})
        print(f"  {name}: used={rep['used']}/{rep['quota']} "
              f"peak={rep['peak_used']} allocs={rep['alloc_count']} "
              f"frees={rep['free_count']} fails={rep['fail_count']} "
              f"(burst mallocs={acc.get('mallocs', 0)} "
              f"failed={acc.get('failed', 0)})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model, KV pages and allocator live; "
                         "cuda runs the support-core CUDA kernel, cpu its "
                         "plain PyTorch version")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=24)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--stash-size", type=int, default=None,
                    help="per-lane page-stash size (0 disables the front "
                         "tier; default: autotuned from boundary cadence)")
    ap.add_argument("--preemption", action="store_true")
    ap.add_argument("--priority-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch)
    rng = np.random.RandomState(args.seed)
    kvcfg = make_paged_config(cfg, seq_len=256, lanes=args.lanes,
                              page_size=args.page_size, dtype=torch.float32,
                              stash_size=args.stash_size)
    params = init_params(cfg, seed=args.seed, dtype=torch.float32,
                         device=args.device)
    scfg = make_scheduler_config(cfg, kvcfg, max_prompt_len=128)
    requests = synth_requests(cfg, args.requests, rng,
                              priority_every=args.priority_every)
    eng = ServingEngine(cfg, kvcfg, params, sched_cfg=scfg,
                        device=args.device)
    sched = Scheduler(scfg)
    steps = serve_loop(eng, sched, requests, args.max_new_tokens,
                       preemption=args.preemption)
    report(eng, sched, steps)


if __name__ == "__main__":
    main()
