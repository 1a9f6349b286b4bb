"""Serving launcher of the port: ``python -m repro_torch.launch.serve``.

The closed-loop paths of ``repro.launch.serve``: Larson-style synthetic
requests flow through the scheduler into one :class:`ServingEngine`, or,
with ``--engines N`` (N > 1), into N engine shards on one shared support
core (:class:`~repro_torch.serve.multi_engine.MultiEngine`: burst windows
of ``--quantum`` decode steps, ``--router``, preemption).  Each admission
batch, decode step, release and window commit is one support-core burst
(one CUDA kernel launch on the card).  ``--prefix-cache on`` keeps
completed requests' pages (``--eviction``, ``--cache-pages``) and admits
hits by copy or by alias (``--prefix-alias``).  ``--device`` picks
``cuda`` (default) or ``cpu`` in place of the JAX launcher's
``--alloc-backend``; the JAX launcher's environment knobs are flags with
its defaults.  ``--alloc-policy`` picks the central allocator design.
``--loadgen poisson|bursty|diurnal`` drives the multi-engine loop open
loop instead (seeded arrivals by virtual time, ``--rate``,
``--priority-frac``, ``--shared-prefix-frac``, ``--max-windows``) and
reports time-to-first-token percentiles; ``--record-trace FILE`` writes
the run's allocator-op trace for ``python -m repro_torch.launch.replay``.
Prints allocator and scheduler telemetry; ``--spans`` records the
program's spans (:mod:`repro_torch.tracing`) and prints, at exit, each
span's count, total and self milliseconds.

    python -m repro_torch.launch.serve --arch deepseek-7b --device cpu \
        --engines 2 --prefix-cache on --prefix-alias alias
    python -m repro_torch.launch.serve --arch deepseek-7b --device cpu \
        --loadgen poisson --alloc-policy buddy --record-trace run.trc
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import tracing
from ..alloc.eviction import EVICTION_POLICIES
from ..alloc.policies import ALLOC_POLICIES
from ..configs.base import ARCH_IDS, smoke_config
from ..loadgen import (ARRIVAL_KINDS, LoadgenSpec, build_workload,
                       certify_complete, record_service, run_open_loop,
                       save_trace)
from ..models import init_params, make_paged_config
from ..serve.engine import ServingEngine, run_admission
from ..serve.multi_engine import MultiEngine
from ..serve.router import ROUTER_POLICIES
from ..serve.scheduler import Request, Scheduler, make_scheduler_config


def synth_requests(cfg, n: int, rng: np.random.RandomState,
                   priority_every: int = 0) -> list[Request]:
    """Larson-style synthetic request mix (the JAX launcher's, draw for
    draw): an audio request also carries ``encoder_seq_len`` frame rows
    of ``randn``, a vlm request 4 patch rows.  ``priority_every=k`` marks
    every k-th request priority 1."""
    reqs = []
    for rid in range(n):
        plen = int(rng.pareto(2.0) * 20) % 96 + 8
        reqs.append(Request(
            rid=rid,
            tokens=rng.randint(0, cfg.vocab_size, size=plen).astype(np.int32),
            frames=(rng.randn(cfg.encoder_seq_len, cfg.d_model)
                    .astype(np.float32) if cfg.family == "audio" else None),
            patches=(rng.randn(4, cfg.d_model).astype(np.float32)
                     if cfg.family == "vlm" else None),
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
    decode step's wall time, read from its ``decode.step`` span (the step
    ends in a host copy of its tokens, so the time covers the device
    work)."""
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
        tokens = eng.step()
        if step_times_us is not None:
            step_times_us.append(eng.last_step.duration_us)
        step += 1
        finished = sched.note_decode_step(tokens)
        if finished:
            # demotion keys must be read before sched.complete drops the
            # running entries (prefix cache on only)
            kv_toks = {lane: sched.kv_token_prefix(lane)
                       for lane in finished} if eng.cache is not None \
                else None
            eng.release(finished, kv_tokens=kv_toks)
            sched.complete(finished)
        if verbose and step % log_every == 0:
            print(f"step {step}: done={len(sched.finished)}/{len(requests)} "
                  f"waiting={len(sched.waiting)} live_pages={eng.live_pages}")
    if sched.waiting:
        print(f"WARNING: admission starved — {len(sched.waiting)} request(s) "
              f"not served (page budget {eng.free_pages} free - "
              f"{sched.scfg.page_reserve} reserve cannot fit the next one)")
    return step


def decode_graph(s) -> str:
    """An engine's decode-graph counters: captures, replays and the state
    leaves copied in before the replays (all 0 where the step is eager)."""
    return (f"decode_graph={s.decode_graph_captures}/"
            f"{s.decode_graph_replays}/{s.decode_graph_copies} "
            f"(captures/replays/copies)")


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
          f"{eng.device} | policy={eng.alloc_policy} "
          f"mean_run_len={s.mean_run_len:.2f} "
          f"compactions={s.compactions}/{s.compaction_moves} moves | "
          f"stash={kvcfg.stash_size}/{kvcfg.stash_watermark}"
          f"/{kvcfg.stash_refill} | allocs={int(a.alloc_count[kv])} "
          f"frees={int(a.free_count[kv])} fails={int(a.fail_count[kv])} "
          f"peak_pages={int(a.peak_used[kv])} live={eng.live_pages} | "
          f"admit_bursts={s.hmq_admit_bursts} "
          f"release_bursts={s.hmq_release_bursts} "
          f"preemptions={s.preemptions} | "
          f"stash_hit_rate={s.stash_hit_rate:.2f} "
          f"decode_bursts/1k={s.hmq_bursts_per_1k_decode_steps:.0f} "
          f"stash_depth_hist={s.stash_depth_hist} | "
          f"{decode_graph(s)}")
    if eng.cache is not None:
        print(f"prefix_cache: hit_rate={s.cache_hit_rate:.2f} "
              f"prefill_tokens_saved={s.prefill_tokens_saved} "
              f"pages={s.cache_pages}/{eng.cache.budget} "
              f"inserts={s.cache_inserts} evictions={s.cache_evictions} "
              f"policy={eng.cache.policy.name} mode={eng.prefix_alias} "
              f"(alias {'on' if eng.alias_enabled else 'off'}) "
              f"aliased_pages={s.aliased_pages} "
              f"hit_copy_bytes={s.cache_hit_copy_bytes} "
              f"hit_admit_us={s.hit_admit_us:.0f}")
    print(f"burst_occupancy={s.burst_occupancy:.2f} | tenants:")
    for name, rep in eng.tenant_report().items():
        acc = s.tenants.get(name, {})
        print(f"  {name}: used={rep['used']}/{rep['quota']} "
              f"peak={rep['peak_used']} allocs={rep['alloc_count']} "
              f"frees={rep['free_count']} fails={rep['fail_count']} "
              f"(burst mallocs={acc.get('mallocs', 0)} "
              f"failed={acc.get('failed', 0)})")


def shard_report(me: MultiEngine) -> None:
    """Each shard's contiguity and fragmentation line: the policy's mean
    admitted run length, the compaction counters and its KV class's
    fragmentation report."""
    for i, eng in enumerate(me.engines):
        s = eng.stats
        frag = eng.fragmentation_report()[eng.tenants.kv.name]
        print(f"  e{i}: policy={eng.alloc_policy} "
              f"mean_run_len={s.mean_run_len:.2f} "
              f"compactions={s.compactions} "
              f"compaction_moves={s.compaction_moves} "
              f"external_frag={frag['external_frag']:.2f} "
              f"largest_free_run={frag['largest_free_run']} "
              f"free_extents={frag['free_extents']} "
              f"splits={frag['split_count']} merges={frag['merge_count']}")


def serve_loadgen(me: MultiEngine, cfg, args) -> None:
    """The open-loop path: seeded arrivals submitted by virtual time, the
    tail-latency report and, with ``--record-trace``, the allocator-op
    trace of the run."""
    if me.device.type == "cuda":
        # build the kernels first: a request's TTFT should not hold nvcc
        from ..kernels._build import build_all
        from ..kernels.flash_attention.ops import FLASH_KERNEL
        from ..kernels.paged_attention.ops import PAGED_KERNEL
        from ..kernels.support_core.ops import KERNEL
        build_all((KERNEL, PAGED_KERNEL, FLASH_KERNEL))
    rec = record_service(me.service) if args.record_trace else None
    spec = LoadgenSpec(n_requests=args.requests, arrival=args.loadgen,
                       rate=args.rate, priority_frac=args.priority_frac,
                       shared_prefix_frac=args.shared_prefix_frac,
                       output_cap=args.max_new_tokens, seed=args.seed)
    rep = run_open_loop(me, build_workload(spec, cfg.vocab_size),
                        max_windows=args.max_windows, verbose=True)
    print(f"open-loop {spec.arrival} rate={spec.rate}/step seed={spec.seed} "
          f"on {me.device}: completed={rep.completed} failed={rep.failed} "
          f"stranded={rep.stranded} in {rep.windows} windows "
          f"({rep.decode_steps} engine-steps, {rep.wall_s:.2f}s)")
    print(f"  TTFT p50={rep.p50_ttft_us / 1e3:.1f}ms "
          f"p90={rep.p90_ttft_us / 1e3:.1f}ms "
          f"p99={rep.p99_ttft_us / 1e3:.1f}ms (virtual: "
          f"p50={rep.p50_ttft_steps:.1f} p99={rep.p99_ttft_steps:.1f} steps)")
    print(f"  per-token p50={rep.p50_tpot_us / 1e3:.1f}ms "
          f"p99={rep.p99_tpot_us / 1e3:.1f}ms | queue depth "
          f"mean={rep.queue_depth_mean:.1f} max={rep.queue_depth_max} | "
          f"{rep.requests_per_s:.2f} requests/s")
    shard_report(me)
    if rec is not None:
        me.service.recorder = None
        trace = certify_complete(rec.finish(), me.engines,
                                 me.stats.window_bursts)
        save_trace(trace, args.record_trace)
        print(f"  trace: {trace.bursts} bursts ({trace.live_bursts} live, "
              f"{trace.ops} ops) {trace.windows} windows -> "
              f"{args.record_trace} complete={trace.header['complete']} "
              f"(replay: python -m repro_torch.launch.replay "
              f"{args.record_trace})")


def serve_multi(me: MultiEngine, requests: list[Request],
                max_new_tokens: int) -> int:
    """The multi-engine path: serve every request, then print the
    deployment's window telemetry, each shard's report and the
    cross-engine tenant rollup.  Returns the burst windows."""
    windows = me.serve(requests, max_new_tokens=max_new_tokens, verbose=True)
    st = me.stats
    if me.failed:
        print(f"FAILED: {len(me.failed)} request(s) rejected by the "
              f"allocator")
    print(f"served {len(me.finished)} requests across {me.n_engines} engines "
          f"on {me.device} in {windows} windows ({st.decode_steps} "
          f"engine-steps) | router={me.router.policy} quantum={me.quantum} "
          f"preemption={me.preemption} | window_commits={st.window_commits}"
          f"/{st.window_bursts} "
          f"cross_engine_burst_occupancy={st.cross_engine_burst_occupancy:.2f}"
          f" preemptions={st.preemptions}")
    for i, eng in enumerate(me.engines):
        s = eng.stats
        cache = (f" cache_hit_rate={s.cache_hit_rate:.2f} "
                 f"prefill_tokens_saved={s.prefill_tokens_saved} "
                 f"cache_pages={s.cache_pages}/{eng.cache.budget} "
                 f"evictions={s.cache_evictions} "
                 f"aliased_pages={s.aliased_pages} "
                 f"hit_copy_bytes={s.cache_hit_copy_bytes}"
                 if eng.cache is not None else "")
        print(f"  e{i}: admitted={s.admitted} completed={s.completed} "
              f"decode_steps={s.decode_steps} "
              f"stash_hit_rate={s.stash_hit_rate:.2f} "
              f"decode_bursts/1k={s.hmq_bursts_per_1k_decode_steps:.0f} "
              f"{decode_graph(s)}{cache}")
    shard_report(me)
    print("cross-engine tenant rollup (one shared AllocService):")
    for name, d in me.tenant_rollup().items():
        print(f"  {name}: engines={d['engines']} used={d['used']}/"
              f"{d['quota']} peak={d['peak_used']} allocs={d['alloc_count']}"
              f" frees={d['free_count']} fails={d['fail_count']}")
    return windows


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
    ap.add_argument("--engines", type=int, default=1,
                    help="engine shards on ONE shared AllocService; >1 "
                         "drives the multi-engine loop")
    ap.add_argument("--quantum", type=int, default=4,
                    help="burst-window length in decode steps (multi-engine "
                         "loop): deferred allocator traffic from every shard "
                         "merges into one commit per window")
    ap.add_argument("--router", default="round_robin",
                    choices=list(ROUTER_POLICIES),
                    help="multi-engine request routing policy")
    ap.add_argument("--preemption", action="store_true")
    ap.add_argument("--priority-every", type=int, default=0)
    ap.add_argument("--prefix-cache", default="off", choices=["on", "off"],
                    help="keep completed requests' full KV pages cached by "
                         "token prefix and skip their prefill on a hit")
    ap.add_argument("--eviction", default="lru",
                    choices=list(EVICTION_POLICIES),
                    help="prefix-cache eviction policy")
    ap.add_argument("--cache-pages", type=int, default=None,
                    help="prefix-cache page budget (default: half the KV "
                         "pool; charged against the kv tenant quota)")
    ap.add_argument("--prefix-alias", default="copy",
                    choices=["copy", "alias"],
                    help="hit admission: 'copy' writes the cached K/V into "
                         "fresh lane pages, 'alias' splices the cached pages "
                         "into the lane's block table (full attention only)")
    ap.add_argument("--alloc-policy", default="freelist",
                    choices=list(ALLOC_POLICIES),
                    help="central-allocator policy: the free list (the CUDA "
                         "kernel on the card), address-ordered first fit "
                         "over the owner bitmap, or power-of-two buddy runs")
    ap.add_argument("--loadgen", default="off",
                    choices=["off", *ARRIVAL_KINDS],
                    help="open-loop arrival process; anything but 'off' "
                         "drives the multi-engine loop by virtual arrival "
                         "time and reports TTFT percentiles")
    ap.add_argument("--rate", type=float, default=0.15,
                    help="open-loop mean arrivals per decode step")
    ap.add_argument("--priority-frac", type=float, default=0.0,
                    help="open-loop fraction of requests at priority 1")
    ap.add_argument("--shared-prefix-frac", type=float, default=0.0,
                    help="open-loop fraction of prompts opening with one "
                         "common prefix (exercises --prefix-cache)")
    ap.add_argument("--record-trace", default=None, metavar="FILE",
                    help="write the open-loop run's allocator-op trace to "
                         "FILE for model-free replay")
    ap.add_argument("--max-windows", type=int, default=None,
                    help="open-loop window budget (smoke-run bound)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spans", action="store_true",
                    help="record the program's spans and print each one's "
                         "count, total and self milliseconds at exit")
    args = ap.parse_args(argv)
    if args.record_trace and args.loadgen == "off":
        ap.error("--record-trace needs --loadgen")

    cfg = smoke_config(args.arch)
    if args.loadgen != "off" and cfg.family == "audio":
        ap.error("--loadgen draws no frame embeddings for an audio request "
                 "(nor does the JAX package's loadgen)")
    rng = np.random.RandomState(args.seed)
    kvcfg = make_paged_config(cfg, seq_len=256, lanes=args.lanes,
                              page_size=args.page_size, dtype=torch.float32,
                              stash_size=args.stash_size)
    params = init_params(cfg, seed=args.seed, dtype=torch.float32,
                         device=args.device)
    scfg = make_scheduler_config(cfg, kvcfg, max_prompt_len=128)
    requests = synth_requests(cfg, args.requests, rng,
                              priority_every=args.priority_every)
    cache = dict(prefix_cache=args.prefix_cache == "on",
                 eviction=args.eviction, cache_pages=args.cache_pages,
                 prefix_alias=args.prefix_alias,
                 alloc_policy=args.alloc_policy)
    if args.spans:
        tracing.enable()
    try:
        if args.engines > 1 or args.loadgen != "off":
            me = MultiEngine(cfg, kvcfg, params, n_engines=args.engines,
                             sched_cfg=scfg, quantum=args.quantum,
                             preemption=args.preemption, router=args.router,
                             device=args.device, **cache)
            if args.loadgen != "off":
                serve_loadgen(me, cfg, args)
            else:
                serve_multi(me, requests, args.max_new_tokens)
        else:
            eng = ServingEngine(cfg, kvcfg, params, sched_cfg=scfg,
                                device=args.device, **cache)
            sched = Scheduler(scfg)
            steps = serve_loop(eng, sched, requests, args.max_new_tokens,
                               preemption=args.preemption)
            report(eng, sched, steps)
    finally:
        if args.spans:
            tracing.disable()
    if args.spans:
        print("spans:")
        print(tracing.format_summary(tracing.drain()))


if __name__ == "__main__":
    main()
