#!/usr/bin/env python3
"""Where the port's decode step spends its time on one NVIDIA card.

    python3 tools/profile_torch_serve.py [--steps 8]

Serves the same workload as ``chip_smoke.py``'s full-width phase
(deepseek-7b at its published widths, bf16, seeded random weights; 8
synthetic requests, 4 lanes, 8-token pages), admits the first batch, runs
three decode steps to warm up, then traces ``--steps`` decode steps with
``torch.profiler``.  Prints the window's wall time, the summed device
kernel time and the device's idle share, kernel time by name, and the
support-core kernel's share.  Fails when the profiler records no device
time.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: needs a CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import synth_requests
    from repro_torch.models import init_params, make_paged_config
    from repro_torch.serve.engine import ServingEngine, run_admission
    from repro_torch.serve.scheduler import Scheduler, make_scheduler_config

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = get_config("deepseek-7b")
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    kvcfg = make_paged_config(cfg, seq_len=256, lanes=4, page_size=8,
                              dtype=torch.bfloat16)
    scfg = make_scheduler_config(cfg, kvcfg, max_prompt_len=128)
    eng = ServingEngine(cfg, kvcfg, params, sched_cfg=scfg, device="cuda")
    sched = Scheduler(scfg)
    for req in synth_requests(cfg, 8, np.random.RandomState(0)):
        req.max_new_tokens = 3 + args.steps + 1
        sched.submit(req)
    run_admission(eng, sched)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us <= 0:
        raise SystemExit("profile_torch_serve: the profiler recorded no "
                         "device time")
    print(f"{args.steps} decode steps, {int(eng.state.paged.active.sum())} "
          f"active lanes: wall {wall_us / 1e3:.2f} ms "
          f"({wall_us / args.steps / 1e3:.2f} ms/step), device kernels "
          f"{device_us / 1e3:.2f} ms, device idle share "
          f"{1 - device_us / wall_us:.3f}")
    launches = sum(e.count for e in kernels)
    print(f"{launches} kernel launches ({launches / args.steps:.0f}/step)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total
                    )[:args.top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:100]}")
    sc = sum(e.self_device_time_total for e in kernels
             if "support_core" in e.key)
    print(f"support-core kernel: {sc / 1e3:.3f} ms "
          f"({sc / device_us:.4f} of device time)")


if __name__ == "__main__":
    main()
