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
its defaults.  Prints allocator and scheduler telemetry.

    python -m repro_torch.launch.serve --arch deepseek-7b --device cpu \
        --engines 2 --prefix-cache on --prefix-alias alias
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..alloc.eviction import EVICTION_POLICIES
from ..configs.base import ARCH_IDS, smoke_config
from ..models import init_params, make_paged_config
from ..serve.engine import ServingEngine, run_admission
from ..serve.multi_engine import MultiEngine
from ..serve.router import ROUTER_POLICIES
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
              f"decode_bursts/1k={s.hmq_bursts_per_1k_decode_steps:.0f}"
              f"{cache}")
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
    cache = dict(prefix_cache=args.prefix_cache == "on",
                 eviction=args.eviction, cache_pages=args.cache_pages,
                 prefix_alias=args.prefix_alias)
    if args.engines > 1:
        me = MultiEngine(cfg, kvcfg, params, n_engines=args.engines,
                         sched_cfg=scfg, quantum=args.quantum,
                         preemption=args.preemption, router=args.router,
                         device=args.device, **cache)
        serve_multi(me, requests, args.max_new_tokens)
        return
    eng = ServingEngine(cfg, kvcfg, params, sched_cfg=scfg,
                        device=args.device, **cache)
    sched = Scheduler(scfg)
    steps = serve_loop(eng, sched, requests, args.max_new_tokens,
                       preemption=args.preemption)
    report(eng, sched, steps)


if __name__ == "__main__":
    main()
