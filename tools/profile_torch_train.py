#!/usr/bin/env python3
"""lm-100m's training on one NVIDIA card: its loss over 200 steps, then
where its train step spends the time.

    python3 tools/profile_torch_train.py

Runs ``examples/torch_train_lm.py`` (lm-100m, f32, 8 x 256 tokens,
grad_accum 2, checkpoints in a temporary directory) for 200 steps on the
card and prints every loss and step time and the median loss over seven
spans of steps.  Then builds the same train step on seeded weights and
one fixed batch, runs three steps to warm up and traces three with
``torch.profiler``: prints the step's wall time under the profiler, its
device time, and the kernels by device and by host time.
"""
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

print(cs.card_line(), torch.__version__, flush=True)
ex = cs.load_example("train_lm")
t0 = time.perf_counter()
with tempfile.TemporaryDirectory() as d:
    rep = ex.main(["--steps", "200", "--checkpoint-dir", d])
print(f"wall {time.perf_counter() - t0:.1f}s")
print("losses", json.dumps([round(x, 4) for x in rep.losses]))
print("step ms", json.dumps([round(x, 1) for x in rep.step_times_ms]))
for a, b in ((0, 10), (10, 20), (20, 40), (40, 60), (60, 100), (100, 150),
             (150, 200)):
    print(a, b, statistics.median(rep.losses[a:b]))

from repro_torch.models import init_params  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
cfg = ex.lm_config(False)
params = init_params(cfg, dtype=torch.float32, device="cuda")
params.requires_grad_(True)
opt = AdamW(lr=1e-3)
state = opt.init(params)
step = make_train_step(cfg, opt, grad_accum=2)
g = torch.Generator().manual_seed(0)
tok = torch.randint(0, cfg.vocab_size, (8, 256), generator=g,
                    dtype=torch.int32)
batch = {"tokens": tok.cuda(), "labels": torch.roll(tok, -1, 1).cuda()}
for _ in range(3):
    params, state, m = step(params, state, batch)
torch.cuda.synchronize()
from torch.profiler import ProfilerActivity, profile  # noqa: E402
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(3):
        params, state, m = step(params, state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3
ka = prof.key_averages()
kernels = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
dev_us = sum(e.self_device_time_total for e in kernels) / 3
if dev_us <= 0:
    raise SystemExit("profile_torch_train: the profiler recorded no device "
                     "time")
print(f"profiled step wall {wall * 1e3:.1f} ms (under the profiler), "
      f"device {dev_us / 1e3:.1f} ms in "
      f"{sum(e.count for e in kernels) / 3:.0f} kernel launches")
print(ka.table(sort_by="self_device_time_total", row_limit=20))
print(ka.table(sort_by="self_cpu_time_total", row_limit=15))
