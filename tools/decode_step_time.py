#!/usr/bin/env python3
"""Decode-step time of one tree's port on one NVIDIA card, for comparing
two commits in one call.

    python3 tools/decode_step_time.py TREE LABEL [--arch deepseek-7b|gemma3-1b]
                                                [--reps 3]

Imports ``repro_torch`` from ``TREE/src`` (a checkout or a ``git archive``
of any commit that has the port), serves ``--arch`` at its published
widths with ``chip_smoke.py``'s full-width workload for it (bf16, seeded
random weights, its requests, 4 lanes, its page size and generation
length) ``--reps`` times, and prints each run's median decode step,
tokens/s and median prefill pass (wall time from a synchronised start to
``torch.cuda.synchronize()``), prefixed with ``LABEL``.  The first run
builds the kernels at first use.
When the tree has the paged-attention op, it also prints the host time
of one call of its wrapper beside one small PyTorch op (no sync).
Run trees in turns (parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (helpers only; imports no repro_torch)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("tree")
    ap.add_argument("label")
    ap.add_argument("--arch", default="deepseek-7b", choices=list(cs.WORKLOADS))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("decode_step_time: needs a CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import init_params, make_paged_config
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.scheduler import Scheduler, make_scheduler_config

    cfg, wl = get_config(args.arch), cs.WORKLOADS[args.arch]
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    for rep in range(args.reps):
        kvcfg = make_paged_config(cfg, seq_len=wl["seq"],
                                  lanes=cs.SERVE_LANES, page_size=wl["page"],
                                  dtype=torch.bfloat16)
        scfg = make_scheduler_config(cfg, kvcfg,
                                     max_prompt_len=wl["max_prompt"])
        eng = ServingEngine(cfg, kvcfg, params, sched_cfg=scfg,
                            device="cuda")
        prefill_us: list = []
        cs.time_prefill_passes(eng, prefill_us)
        sched = Scheduler(scfg)
        reqs = cs.make_requests(cfg, wl, wl["prompt_lens"])
        step_us: list = []
        steps = serve_loop(eng, sched, reqs, wl["new_tokens"], verbose=False,
                           step_times_us=step_us)
        torch.cuda.synchronize()
        toks = sum(len(r.output) for r in reqs) - len(reqs)
        print(f"{args.label} {args.arch} run {rep}: {steps} decode steps, "
              f"median step {statistics.median(step_us) / 1e3:.2f} ms, "
              f"{toks / (sum(step_us) / 1e6):.1f} tokens/s, "
              f"{len(prefill_us)} prefill passes, median "
              f"{statistics.median(prefill_us) / 1e3:.2f} ms", flush=True)

    try:
        from repro_torch.kernels.paged_attention.ops import \
            paged_decode_attention_op as op
    except ImportError:
        return
    dev = torch.device("cuda")
    B, KV, hd, ps, P, L = 4, 32, 128, 8, 33, 30
    pool = torch.zeros((B * P + 2, L, ps, KV, hd), dtype=torch.bfloat16,
                       device=dev)
    q = torch.zeros((B, KV, hd), dtype=torch.bfloat16, device=dev)
    tab = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    seq = torch.full((B,), 100, dtype=torch.int32, device=dev)
    act = torch.ones((B,), dtype=torch.bool, device=dev)
    calls = {"paged-attention wrapper": lambda: op(
                 q, pool[:, 1], pool[:, 1], tab, seq, 1 << 30, k_self=q,
                 v_self=q, active=act),
             "one torch add": lambda: q + 1}
    for name, fn in calls.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        host = (time.perf_counter() - t0) / 1000
        torch.cuda.synchronize()
        print(f"{args.label} host time of {name}: {host * 1e6:.1f} us/call")


if __name__ == "__main__":
    main()
