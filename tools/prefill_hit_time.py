#!/usr/bin/env python3
"""Prefill passes with and without a prefix-cache hit, on one NVIDIA card.

    python3 tools/prefill_hit_time.py [--reps 10]

Serves ``chip_smoke.py``'s phase 4c workload once (deepseek-7b at its
published widths, bf16 weights from seed 0, two engine shards with
alias-mode prefix caches, 16 requests on two shared 64-token prefixes)
and keeps every prefill pass's input batch.  Then it replays those
batches warm, ``--reps`` rounds with the hit and miss passes interleaved,
and prints per kind the median wall time of a pass (a synchronised start
to ``torch.cuda.synchronize()``), then the device kernel time and launch
count of one round under ``torch.profiler``.  A hit pass prefills only
the uncached suffix over the cached prefix's K/V; the gather of that K/V
from the pages happens before the pass and is not in it.  Prints the
card's ``nvidia-smi`` line first.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (helpers only; imports no repro_torch)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("prefill_hit_time: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    cfg, params = cs.full_width_params(dev, "deepseek-7b")
    me = cs.multi_engine(cfg, params, torch.bfloat16, dev, True, True)
    batches: list = []              # (kind, batch)
    prefill = me.engines[0]._prefill
    for eng in me.engines:
        inner = eng._prefill

        def keep(p, batch, inner=inner):
            batches.append(("hit" if "prefix_k" in batch else "miss", batch))
            return inner(p, batch)
        eng._prefill = keep
    reqs = cs.shared_prefix_requests(cfg)
    me.serve(reqs, max_new_tokens=cs.MULTI["new_tokens"])
    cs.check_multi_served(me, reqs, "capture")
    for kind, b in batches:
        pre = b.get("prefix_k")
        print(f"  {kind}: tokens {tuple(b['tokens'].shape)}, real "
              f"{b['lengths'].tolist()}, cached prefix "
              f"{pre.shape[2] if pre is not None else 0}")
    del me

    wall = {"hit": [], "miss": []}
    for _ in range(args.reps):
        for kind, b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, b)
            torch.cuda.synchronize()
            wall[kind].append((time.perf_counter() - t0) * 1e6)
    for kind, us in wall.items():
        print(f"{kind}: {len(us)} warm passes, wall median "
              f"{statistics.median(us) / 1e3:.2f} ms (min "
              f"{min(us) / 1e3:.2f}, max {max(us) / 1e3:.2f})")

    for kind in ("hit", "miss"):
        mine = [b for k, b in batches if k == kind]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for b in mine:
                prefill(params, b)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in kernels)
        if device_us <= 0:
            raise SystemExit("prefill_hit_time: the profiler recorded no "
                             "device time")
        flash_us = sum(e.self_device_time_total for e in kernels
                       if "flash" in e.key)
        print(f"{kind}: device kernels {device_us / len(mine) / 1e3:.3f} ms "
              f"a pass ({sum(e.count for e in kernels) // len(mine)} "
              f"launches; flash {flash_us / len(mine) / 1e3:.3f} ms), "
              f"over {len(mine)} passes")


if __name__ == "__main__":
    main()
