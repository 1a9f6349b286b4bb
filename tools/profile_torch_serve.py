#!/usr/bin/env python3
"""Where the port's decode step spends its time on one NVIDIA card.

    python3 tools/profile_torch_serve.py [--arch ARCH] [--steps 8]

Serves the workload of ``chip_smoke.py``'s full-width phase for ``--arch``
(any of its ``WORKLOADS``: published widths, at its depth cut where it has
one, bf16, seeded random weights; its requests, patches included, 4
lanes, its page size), admits the first batch, runs three decode steps to warm
up, then traces ``--steps`` decode steps with ``torch.profiler``.  Prints
the window's wall time, the summed device kernel time and the device's
idle share, kernel time by name, and the shares of the port's kernels and
of device copies.  For zamba2-1.2b, rwkv6-7b and whisper-medium it then
profiles the step's family pieces alone on the same lanes' state
(``chip_smoke.step_profile``'s parts) and gives each one's share of the
step's device time: the Mamba2 blocks and their SSD recurrence; the
RWKV6 time mixes and their wkv recurrence; whisper's cross K/V
projection (``2 x lanes x frames x d x KV*hd`` multiply-adds a layer,
anew every step, with its rate) and its cross-attention flash calls.
Fails when the profiler records no device time.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# kernel-name fragments of each share the summary reports
SHARES = {"support-core kernel": ("support_core",),
          "paged attention kernel (both passes)": ("paged_attention",
                                                   "paged_combine"),
          "flash attention kernel": ("flash_",),
          "device copies": ("copy", "Copy")}


def main() -> None:
    from chip_smoke import (SERVE_LANES, WORKLOADS, device_profile,
                            full_width_config, hybrid_parts, make_requests,
                            rwkv6_parts, whisper_parts)
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="deepseek-7b", choices=list(WORKLOADS))
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: needs a CUDA card")
    from repro_torch.models import init_params, make_paged_config
    from repro_torch.serve.engine import ServingEngine, run_admission
    from repro_torch.serve.scheduler import Scheduler, make_scheduler_config

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg, wl = full_width_config(args.arch), WORKLOADS[args.arch]
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    kvcfg = make_paged_config(cfg, seq_len=wl["seq"], lanes=SERVE_LANES,
                              page_size=wl["page"], dtype=torch.bfloat16)
    scfg = make_scheduler_config(cfg, kvcfg, max_prompt_len=wl["max_prompt"])
    eng = ServingEngine(cfg, kvcfg, params, sched_cfg=scfg, device="cuda")
    sched = Scheduler(scfg)
    for req in make_requests(cfg, wl, wl["prompt_lens"]):
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
    print(f"{args.arch}: {cfg.num_layers} layers, {args.steps} decode steps, "
          f"{int(eng.state.paged.active.sum())} active lanes: wall "
          f"{wall_us / 1e3:.2f} ms ({wall_us / args.steps / 1e3:.2f} ms/step), "
          f"device kernels {device_us / 1e3:.2f} ms, device idle share "
          f"{1 - device_us / wall_us:.3f}")
    launches = sum(e.count for e in kernels)
    print(f"{launches} kernel launches ({launches / args.steps:.0f}/step)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total
                    )[:args.top]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x  {e.key[:100]}")
    for label, frags in SHARES.items():
        us = sum(e.self_device_time_total for e in kernels
                 if any(f in e.key for f in frags))
        n = sum(e.count for e in kernels if any(f in e.key for f in frags))
        print(f"{label}: {us / 1e3:.3f} ms in {n} launches "
              f"({us / device_us:.4f} of device time)")
    parts = {"zamba2-1.2b": hybrid_parts, "rwkv6-7b": rwkv6_parts,
             "whisper-medium": whisper_parts}.get(args.arch)
    if parts is None:
        return
    step_us = device_us / args.steps
    lanes = int(eng.state.paged.active.sum())
    for key, (label, fn) in parts(eng).items():
        us, n, _ = device_profile(fn, args.steps)
        rate = ""
        if key == "cross_kv":
            flop = 2 * 2 * lanes * cfg.num_layers * cfg.encoder_seq_len \
                * cfg.d_model * cfg.num_kv_heads * cfg.resolved_head_dim
            rate = (f"; {flop / 1e9:.1f} GFLOP a step at {lanes} lanes, "
                    f"{flop / us / 1e6:.1f} TFLOP/s")
        print(f"{label} alone: {us / 1e3:.3f} ms device time in {n:.0f} "
              f"launches a step ({us / step_us:.4f} of the step's device "
              f"time){rate}")


if __name__ == "__main__":
    main()
