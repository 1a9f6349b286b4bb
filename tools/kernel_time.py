#!/usr/bin/env python3
"""Device time of one tree's three kernels on one NVIDIA card, at the
shapes of ``chip_smoke.py`` phase 3, for comparing two commits in one
call.

    python3 tools/kernel_time.py TREE LABEL [--host]

Imports ``repro_torch`` from ``TREE/src`` (a checkout or a ``git archive``
of any commit that has the ops; its kernels are built at first use under
``TREE/build/kernels``) and times, in bf16, paged decode attention (self
mode on one layer of a 26- or 30-layer pool, every lane active) and
causal flash prefill attention at deepseek-7b's shape and at gemma3-1b's
local (window 512) and global layers; then the support-core burst at the
serve's shape (Q=8 C=2 N=512 R=7), the large shape (Q=256 C=8 N=65536
R=8), the live decode, release and all-NOP bursts of a card-sized
gemma3-1b pool (synthetic mixes) and a release burst on the global path
(``chip_smoke.burst_cases``); last, the host time of one call of the
burst's wrapper at the serve's shape beside one small PyTorch op (no
sync; the median of 10 loops of 200 calls).  ``--host`` times only that,
so that many short runs can alternate trees.  Each device time is the
median of CUDA event pairs around one call queued behind a GPU spin
(``chip_smoke.device_ms``), so it is the device's time, not the host's.
Prints the card's ``nvidia-smi`` line, one line per shape and one JSON
line, each prefixed with ``LABEL``.  Run trees in turns (parent, change,
change, parent).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (helpers only; imports no repro_torch)

FULL = cs.FULL
# (B, KV, G, hd, ps, P, L, seq_lens, window): chip_smoke.py phase 3
PAGED = {"deepseek-7b": (4, 32, 1, 128, 8, 33, 30, [119, 104, 87, 112], FULL),
         "gemma3-1b local": (4, 1, 4, 256, 16, 129, 26,
                             [1400, 1024, 700, 611], 512),
         "gemma3-1b global": (4, 1, 4, 256, 16, 129, 26,
                              [1400, 1024, 700, 611], FULL)}
# (B, T, H, KV, hd, window)
FLASH = {"deepseek-7b": (4, 128, 32, 32, 128, FULL),
         "gemma3-1b local": (4, 1536, 4, 1, 256, 512),
         "gemma3-1b global": (4, 1536, 4, 1, 256, FULL)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("tree")
    ap.add_argument("label")
    ap.add_argument("--host", action="store_true",
                    help="time only the burst wrapper's host cost")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_time: needs a CUDA card")
    src = Path(args.tree).resolve() / "src"
    sys.path.insert(0, str(src))
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise SystemExit(f"kernel_time: imported {repro_torch.__file__}, "
                         f"not the tree's")
    lab = args.label
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{lab} card: {smi}", flush=True)
    dev = torch.device("cuda")
    us = {} if args.host else device_times(lab, dev)
    from repro_torch.kernels.support_core.ops import support_core_burst
    state, sched, R, gated = cs.serve_burst(dev)
    one = torch.zeros(8, dtype=torch.int32, device=dev)
    us["host"] = {}
    for name, fn in (("support-core wrapper", lambda: support_core_burst(
                          state, sched, R, gated=gated)),
                     ("one torch add", lambda: one + 1)):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        loops = []
        for _ in range(10):
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            loops.append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
        us["host"][name] = statistics.median(loops)
        print(f"{lab} host time of {name}: {us['host'][name]:.1f} us/call",
              flush=True)
    print(f"{lab} " + json.dumps(dict(label=lab, card=smi, us=us)))


def device_times(lab: str, dev) -> dict:
    """Device µs of each kernel at each shape, printed as they come."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention_op as paged_op
    from repro_torch.kernels.support_core.ops import support_core_burst
    us: dict = {"paged": {}, "flash": {}}
    for name, (B, KV, G, hd, ps, P, L, seq, window) in PAGED.items():
        case = cs.paged_pool_case(np.random.RandomState(2), dev,
                                  torch.bfloat16, B, KV, G, hd, ps, P, L, seq,
                                  [True] * B)
        pargs, kw = cs.paged_args(case, window, True)
        us["paged"][name] = cs.device_ms(lambda: paged_op(*pargs, **kw)) * 1e3
        print(f"{lab} paged {name}: {us['paged'][name]:.2f} us", flush=True)
    for name, (B, T, H, KV, hd, window) in FLASH.items():
        rng = np.random.RandomState(3)
        q = cs.rand(rng, (B, T, H, hd), torch.bfloat16, dev)
        k = cs.rand(rng, (B, T, KV, hd), torch.bfloat16, dev)
        v = cs.rand(rng, (B, T, KV, hd), torch.bfloat16, dev)
        us["flash"][name] = cs.device_ms(
            lambda: flash_attention_op(q, k, v, causal=True, window=window),
            n=30) * 1e3
        print(f"{lab} flash {name}: {us['flash'][name]:.2f} us", flush=True)
    us["support_core"] = {}
    for name, (state, sched, R, gated) in cs.burst_cases(dev).items():
        us["support_core"][name] = cs.device_ms(
            lambda: support_core_burst(state, sched, R, gated=gated)) * 1e3
        print(f"{lab} support core {name} (Q={sched.capacity} "
              f"N={state.free_stack.shape[1]} gated={gated}): "
              f"{us['support_core'][name]:.2f} us", flush=True)
    return us


if __name__ == "__main__":
    main()
