"""Trace replay launcher of the port: ``python -m repro_torch.launch.replay
TRACE [--policy P] [--sim POLICIES [--threads N]] [--device cpu|cuda]``.

Drives a recorded allocator-op tracefile (``launch.serve --loadgen ...
--record-trace FILE`` of either package, or ``loadgen.trace.save_trace``)
through a model-free ``AllocService``: no model forward, on the card
unless ``--device cpu``.  ``--policy`` replays the trace under another
allocator design; single frees, retags and bumps name the recorded
policy's block ids, so such a replay leaves them out
(``AllocTrace.drop_block_ids``) and says so.  Prints the per-tenant
counters, the replay's wall time and its bursts per second.  ``--sim``
also replays the trace through comma-separated allocator-simulator
policies (``sim.policies.ALL_POLICIES``) at ``--threads`` sim threads, on
the same device, and prints each one's counts and estimated cycles.
"""
from __future__ import annotations

import argparse

from ..alloc.policies import ALLOC_POLICIES
from ..loadgen.trace import load_trace, replay_sim_policies, replay_trace


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="tracefile written by save_trace / "
                                  "--record-trace")
    ap.add_argument("--policy", default=None, choices=list(ALLOC_POLICIES),
                    help="override the recorded allocator policy")
    ap.add_argument("--sim", default=None, metavar="POLICIES",
                    help="also replay through comma-separated sim policies "
                         "(e.g. 'speedmalloc,tcmalloc,mimalloc')")
    ap.add_argument("--threads", type=int, default=8,
                    help="sim thread count for --sim lowering")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the replayed allocator state and the sim "
                         "traces live")
    args = ap.parse_args(argv)

    trace = recorded = load_trace(args.trace)
    h = trace.header
    print(f"{args.trace}: v{h['version']} policy={h['policy']} "
          f"tenants={len(h['tenants'])} bursts={trace.bursts} "
          f"({trace.live_bursts} live, {trace.ops} ops) "
          f"windows={trace.windows} complete={h['complete']}")
    if args.policy not in (None, h["policy"]) and trace.names_block_ids:
        trace = trace.drop_block_ids()
        print(f"under {args.policy}: without the single frees, retags and "
              f"bumps, which name {h['policy']}'s block ids "
              f"({trace.ops} ops left)")
    res = replay_trace(trace, policy=args.policy, device=args.device)
    rate = res.bursts / res.wall_s if res.wall_s > 0 else 0.0
    print(f"replayed {res.bursts} bursts ({res.live_bursts} live) on "
          f"{args.device} in {res.wall_s:.4f}s ({rate:.1f} bursts/s, "
          f"{res.signatures} burst shape(s)) "
          f"policy={args.policy or h['policy']}")
    for name, rep in res.report.items():
        print(f"  {name}: used={rep['used']}/{rep['quota']} "
              f"peak={rep['peak_used']} allocs={rep['alloc_count']} "
              f"frees={rep['free_count']} fails={rep['fail_count']}")
    if args.sim:
        rows = replay_sim_policies(recorded,
                                   policies=args.sim.split(","),
                                   threads=args.threads, device=args.device)
        print(f"sim-policy sweep ({args.threads} threads, {args.device}):")
        for name, r in rows.items():
            print(f"  {name}: mallocs={r['mallocs']} frees={r['frees']} "
                  f"fast_hits={r['fast_hits']} "
                  f"shared_trips={r['shared_trips']} "
                  f"est_cycles={r['est_cycles']:.0f}")


if __name__ == "__main__":
    main()
