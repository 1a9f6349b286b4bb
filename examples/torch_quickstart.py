"""Quickstart on the PyTorch port: the SpeedMalloc support-core, end to end.

The six parts of ``examples/quickstart.py``, on ``repro_torch``:

1. drive the support-core through its client API (`repro_torch.alloc`):
   named tenants, typed burst ops, ticket resolution, pluggable policies,
2. train a tiny LM a few steps,
3. serve it through the SpeedMalloc paged-KV engine (three tenants on one
   support-core),
4. hold a multi-turn conversation with the prefix cache on: each turn's
   KV pages survive completion, so the next turn's growing history hits
   the cache and skips most of its prefill,
5. drive open-loop Poisson load, record the allocator-op trace, and
   replay it model-free (exact counters) + through the paper's sim
   policies,
6. admit a mixed short/long workload under the buddy policy: contiguous
   multi-page run grants (mean_run_len > 1), fragmentation telemetry,
   and the between-window compaction pass.

On the card every support-core burst of the free-list policy, every
decode attention and every prefill attention is a hand-written CUDA
kernel, and part 5's sim replay runs the simulator's trace kernel; on the
CPU each runs its plain PyTorch version.  The JAX package reads three
knobs from the environment; here they are arguments at their defaults
(``alloc_policy="freelist"``, ``eviction="lru"``, ``prefix_alias="copy"``).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.alloc import AllocService
from repro_torch.configs import smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import serve_loop
from repro_torch.loadgen import (LoadgenSpec, build_workload, record_service,
                                 replay_sim_policies, run_open_loop)
from repro_torch.loadgen.trace import (certify_complete, replay_trace,
                                       save_trace)
from repro_torch.models import (init_params, loss_fn, make_paged_config,
                                synth_batch)
from repro_torch.serve.engine import AdmissionItem, ServingEngine
from repro_torch.serve.multi_engine import MultiEngine
from repro_torch.serve.scheduler import (Request, Scheduler,
                                         make_scheduler_config)


# --- 1. the support-core, through the client API (DESIGN.md §9) -----------
def part1_client_api(dev) -> dict:
    svc = AllocService(policy="freelist", device=dev)
    kv = svc.register_tenant("kv_pages", capacity=8)
    ws = svc.register_tenant("workspace", capacity=16)
    state = svc.init_state()               # segregated metadata, all tenants

    burst = svc.new_burst()                # ONE HMQ batch: 3 mallocs + 1 free
    t_a = burst.malloc(kv, lane=0, n=2)
    t_b = burst.malloc(kv, lane=1, n=1)
    t_w = burst.malloc(ws, lane=0, n=4)
    burst.free_all(kv, lane=1)             # deferred: allocatable next burst
    state, res = svc.commit(state, burst, max_blocks_per_req=4)

    grants = {"lane0 kv": res.blocks_for(t_a)[0].tolist(),
              "lane1 kv": res.blocks_for(t_b)[0].tolist(),
              "lane0 ws": res.blocks_for(t_w)[0].tolist()}
    print("support-core: blocks granted per ticket:")
    print("  lane0 kv:", grants["lane0 kv"], " lane1 kv:", grants["lane1 kv"],
          " lane0 ws:", grants["lane0 ws"])
    s = res.stats
    counters = {"mallocs": int(s.mallocs), "frees": int(s.frees),
                "failed": int(s.failed)}
    print(f"  mallocs={counters['mallocs']} frees={counters['frees']} "
          f"failed={counters['failed']}")
    used = {t.name: int(s.per_tenant.used[t.size_class])
            for t in svc.tenants}
    print(f"  per-tenant used: {used}")

    # the same burst under a different central design: address-ordered
    # first fit
    bm = AllocService(policy="bitmap", device=dev)
    bm_kv = bm.register_tenant("kv_pages", capacity=8)
    b2 = bm.new_burst()
    t2 = b2.malloc(bm_kv, lane=0, n=2)
    _, res2 = bm.commit(bm.init_state(), b2, max_blocks_per_req=4)
    grants["bitmap lane0 kv"] = res2.blocks_for(t2)[0].tolist()
    print(f"  same client code, bitmap policy grants "
          f"{grants['bitmap lane0 kv']} "
          f"(freelist granted {grants['lane0 kv']})\n")
    return dict(grants=grants, counters=counters, used=used,
                freelist_commits=1)


# --- 2. train a reduced model a few steps ----------------------------------
def part2_train(dev) -> tuple:
    cfg = smoke_config("mixtral-8x7b")      # tiny same-family MoE
    params = init_params(cfg, dtype=torch.float32, device=dev)
    batch = synth_batch(cfg, batch=4, seq=32, device=dev)
    weights = list(params.parameters())
    params.requires_grad_(True)
    losses = []
    for i in range(3):
        loss = loss_fn(params, cfg, batch)[0]
        grads = torch.autograd.grad(loss, weights, allow_unused=True)
        with torch.no_grad():
            for p, g in zip(weights, grads):
                if g is not None:
                    p.sub_(0.5 * g)
        losses.append(float(loss.detach()))
        print(f"train step {i}: loss {losses[-1]:.4f}")
    params.requires_grad_(False)
    return cfg, params, losses


# --- 3. serve it on the paged KV cache -------------------------------------
def part3_serve(dev, cfg, params) -> tuple:
    kvcfg = make_paged_config(cfg, seq_len=128, lanes=2, page_size=8,
                              dtype=torch.float32)
    eng = ServingEngine(cfg, kvcfg, params, device=dev)
    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                              12).astype(np.int32)
    eng.admit(0, prompt)
    out = [int(eng.state.tokens[0])]
    for _ in range(8):
        eng.step()
        out.append(int(eng.state.tokens[0]))
    a = eng.state.paged.alloc
    print(f"\nserved 8 tokens: {out}")
    print(f"allocator: allocs={int(a.alloc_count[0])} "
          f"live_pages={int(a.used[0])} peak={int(a.peak_used[0])}")
    print("engine tenants on the one support-core:")
    for name, rep in eng.tenant_report().items():
        print(f"  {name}: used={rep['used']}/{rep['quota']} "
              f"allocs={rep['alloc_count']}")
    return kvcfg, eng, out


# --- 4. multi-turn conversation on the prefix cache (DESIGN.md §11) --------
def part4_prefix_cache(dev, cfg, params, kvcfg) -> tuple:
    scfg = make_scheduler_config(cfg, kvcfg, max_prompt_len=96)
    chat = ServingEngine(cfg, kvcfg, params, sched_cfg=scfg, device=dev,
                         prefix_cache=True, eviction="lru",
                         prefix_alias="copy")
    plain = ServingEngine(cfg, kvcfg, params, sched_cfg=scfg, device=dev)
    rng = np.random.RandomState(7)
    history = rng.randint(0, cfg.vocab_size, 18).astype(np.int32)  # system

    print(f"\nmulti-turn chat, prefix cache on "
          f"(policy={chat.cache.policy.name}, page_size={kvcfg.page_size}):")
    prompt_total = prev_saved = 0
    for turn in range(4):
        # each user turn appends a few tokens to the running conversation;
        # the prompt is the FULL history, exactly what a chat loop resends
        history = np.concatenate(
            [history, rng.randint(0, cfg.vocab_size, 6).astype(np.int32)])
        plen = len(history)
        prompt_total += plen
        replies = {}
        for name, eng2 in (("on", chat), ("off", plain)):
            sched = Scheduler(scfg)
            serve_loop(eng2, sched, [Request(rid=turn,
                                             tokens=history.copy())],
                       max_new_tokens=5, verbose=False)
            replies[name] = np.asarray(sched.finished[0].output, np.int32)
        assert (replies["on"] == replies["off"]).all()  # cache moves no token
        history = np.concatenate([history, replies["on"]])  # reply joins
        s = chat.stats
        saved = s.prefill_tokens_saved - prev_saved
        prev_saved = s.prefill_tokens_saved
        print(f"  turn {turn}: prompt={plen:3d} tok, prefilled "
              f"{plen - saved:3d} (cache off: {plen:3d})  "
              f"cache_hit_rate={s.cache_hit_rate:.2f} "
              f"cached_pages={s.cache_pages}")
    # turn 0 misses (cold cache); every later turn reuses the demoted
    # pages, so the hit rate climbs while each prefill shrinks to the new
    # suffix even as the conversation keeps growing
    assert chat.stats.cache_hits == 3 and chat.stats.prefill_tokens_saved > 0
    print(f"  prompt tokens prefilled across the chat: "
          f"{prompt_total - chat.stats.prefill_tokens_saved} of "
          f"{prompt_total} (cache off prefills all {prompt_total})")

    # zero-copy hits (DESIGN.md §12): with prefix_alias="alias", a hit
    # SPLICES the cache-owned pages into the lane's block table under a
    # refcount bump instead of copying the prefix K/V into fresh pages.
    # Needs full attention -- mixtral above is SWA, where alias degrades to
    # the copy path -- so run it on a tiny dense arch.
    cfg_d = smoke_config("deepseek-7b")
    params_d = init_params(cfg_d, dtype=torch.float32, device=dev)
    kvcfg_d = make_paged_config(cfg_d, seq_len=128, lanes=2, page_size=8,
                                dtype=torch.float32)
    scfg_d = make_scheduler_config(cfg_d, kvcfg_d, max_prompt_len=96)
    zc = ServingEngine(cfg_d, kvcfg_d, params_d, sched_cfg=scfg_d,
                       device=dev, prefix_cache=True, prefix_alias="alias")
    rng_d = np.random.RandomState(11)
    system = rng_d.randint(0, cfg_d.vocab_size, 32).astype(np.int32)
    reqs = [Request(rid=i, tokens=np.concatenate(
                [system,
                 rng_d.randint(0, cfg_d.vocab_size, 6).astype(np.int32)]))
            for i in range(4)]
    sched = Scheduler(scfg_d)
    serve_loop(zc, sched, reqs, max_new_tokens=4, verbose=False)
    s = zc.stats
    print(f"\nzero-copy aliasing (prefix_alias=alias, dense arch): "
          f"{len(sched.finished)} reqs, cache_hits={s.cache_hits}")
    print(f"  aliased_pages={s.aliased_pages} spliced by reference, "
          f"cache_hit_copy_bytes={s.cache_hit_copy_bytes} "
          f"(copy mode would copy every cached page)")
    assert s.aliased_pages > 0 and s.cache_hit_copy_bytes == 0
    assert zc.cache.pinned == 0      # every splice was released with its lane
    return cfg_d, params_d, (chat, plain, zc)


# --- 5. open-loop load + allocator-op trace record/replay (DESIGN.md §14) --
def part5_open_loop(dev, cfg_d, params_d, trace_dir: Path) -> dict:
    # Open-loop traffic: requests arrive on a seeded Poisson schedule
    # whether or not the engines have finished the previous ones -- the
    # regime where tail latency (p99 TTFT) means something.  While the run
    # is live, a TraceRecorder captures every allocator burst the support
    # core commits; afterwards the SAME op stream replays model-free
    # through a fresh AllocService and must land on EXACTLY the live
    # per-tenant counters.

    # the stash keeps decode refills off the shared allocator, so no
    # in-step emergency burst goes live
    kvcfg_lg = make_paged_config(cfg_d, seq_len=128, lanes=2, page_size=8,
                                 dtype=torch.float32, stash_size=8,
                                 stash_watermark=2, stash_refill=4)
    scfg_lg = make_scheduler_config(cfg_d, kvcfg_lg, max_prompt_len=64)
    me = MultiEngine(cfg_d, kvcfg_lg, params_d, n_engines=2,
                     sched_cfg=scfg_lg, quantum=4, device=dev)
    rec = record_service(me.service)           # attach the recorder seam
    spec = LoadgenSpec(n_requests=8, arrival="poisson", rate=0.2,
                       prompt_min=6, prompt_cap=24, output_min=2,
                       output_cap=6, priority_frac=0.25, seed=0)
    report = run_open_loop(me, build_workload(spec, cfg_d.vocab_size))
    me.service.recorder = None                 # detach before replaying
    trace = certify_complete(rec.finish(), me.engines,
                             window_bursts=me.stats.window_bursts)
    print(f"\nopen-loop poisson: {report.completed} done in "
          f"{report.windows} windows, p50/p99 TTFT = "
          f"{report.p50_ttft_us:.0f}/{report.p99_ttft_us:.0f}us, queue "
          f"depth max {report.queue_depth_max}")
    print(f"trace: {trace.bursts} bursts ({trace.ops} ops, "
          f"{trace.windows} windows), complete={trace.header['complete']}")

    # replay the tracefile through the live policy -- counters must be
    # EXACT -- and through the paper's sim policies for a what-if cycle
    # estimate
    save_trace(trace, trace_dir / "quickstart.alloctrace")
    res = replay_trace(trace, device=dev)
    assert res.report == me.service.tenant_report(me.alloc)
    print(f"replay: {res.bursts} bursts in {res.wall_s:.3f}s "
          f"({res.signatures} burst signatures), counters EXACT")
    sims = replay_sim_policies(trace, policies=("speedmalloc", "tcmalloc"),
                               device=dev)
    for name, row in sims.items():
        print(f"  sim {name}: {row['mallocs']} mallocs, "
              f"{row['shared_trips']} shared trips, "
              f"est {row['est_cycles']:.0f} cycles")
    return dict(kvcfg=kvcfg_lg, scfg=scfg_lg, me=me, report=report,
                trace=trace, replay=res, sims=sims)


# --- 6. buddy policy: contiguous runs + fragmentation telemetry (§15) ------
def part6_buddy(dev, cfg_d, params_d, kvcfg_lg, scfg_lg) -> tuple:
    # A mixed short/long workload under the buddy central design:
    # admission requests each sequence's whole predicted page count as ONE
    # contiguous run (OP_MALLOC_RUN), so a long prompt's pages land side
    # by side instead of wherever the free stack points.  Same client code
    # -- the policy is just the alloc_policy argument.
    bud = ServingEngine(cfg_d, kvcfg_lg, params_d, sched_cfg=scfg_lg,
                        device=dev, alloc_policy="buddy")
    fl = ServingEngine(cfg_d, kvcfg_lg, params_d, sched_cfg=scfg_lg,
                       device=dev, alloc_policy="freelist")
    rng_b = np.random.RandomState(3)
    mixed = [(0, 40), (1, 8)]                   # 5-page long + 1-page short
    for eng_b in (bud, fl):
        eng_b.admit_many([AdmissionItem(lane=l, tokens=rng_b.randint(
            0, cfg_d.vocab_size, n).astype(np.int32)) for l, n in mixed])
    print("\nbuddy policy, mixed short/long admission:")
    print(f"  mean_run_len: buddy={bud.stats.mean_run_len:.2f} "
          f"freelist={fl.stats.mean_run_len:.2f} "
          f"(pages per contiguous extent; 1.0 == every page an island)")
    for name, rep in bud.fragmentation_report().items():
        print(f"  {name}: free={rep['free']} in {rep['free_extents']} "
              f"extent(s), largest_run={rep['largest_free_run']} "
              f"external_frag={rep['external_frag']:.2f} "
              f"splits={rep['split_count']} merges={rep['merge_count']}")
    moved = bud.compact()                       # between-window compaction
    print(f"  compaction pass: {moved} page(s) migrated "
          f"(coalesces torn holes; a no-op when free space is already one "
          f"run)")
    assert bud.stats.mean_run_len > 1.0 >= fl.stats.mean_run_len * 0.999
    return bud, fl, moved


def main(argv=None) -> dict:
    """Run the six parts; returns what each made (engines, reports, the
    trace), which a caller may check further."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the models, KV pages and allocator live")
    dev = resolve_device(ap.parse_args(argv).device)
    out = dict(part1=part1_client_api(dev))
    cfg, params, losses = part2_train(dev)
    kvcfg, eng, tokens = part3_serve(dev, cfg, params)
    cfg_d, params_d, (chat, plain, zc) = part4_prefix_cache(dev, cfg, params,
                                                            kvcfg)
    with tempfile.TemporaryDirectory() as tmp:
        p5 = part5_open_loop(dev, cfg_d, params_d, Path(tmp))
    bud, fl, moved = part6_buddy(dev, cfg_d, params_d, p5["kvcfg"],
                                 p5["scfg"])
    out.update(
        cfg=cfg, cfg_d=cfg_d, losses=losses, tokens=tokens,
        engines={"serve": eng, "chat": chat, "plain": plain, "alias": zc,
                 "buddy": bud, "freelist": fl},
        multi=p5["me"], report=p5["report"], trace=p5["trace"],
        replay=p5["replay"], sims=p5["sims"], compaction_moves=moved)
    return out


if __name__ == "__main__":
    main()
