"""Find an open-loop cell's knee once, on the card: the highest offered
rate at which the waiting queue does not grow across the window.

    python portbench/sweep.py --workload deepseek-7b.chat --seconds 30 \\
        --rates 4 5 6 7 8

One process builds the cell once and runs its mix at each rate in turn
(warm-up, window, drain, every lane released), printing per rate the
waiting queue at the window's start and end and its slope, the tails and
the output rate.  The benchmark's runs never call it; the rate it finds
goes into the mix's file by hand, at four fifths of the knee.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--drain", type=float, default=15.0,
                    help="seconds to follow the window's requests after it")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from portbench import core
    from portbench import traffic as tr

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    _, model, mix = core.cell_files(args.workload, core.manifest())
    core.build_kernels()
    me, _params = core.build_program(model, mix, args.seed, "cuda")
    for rate in args.rates:
        m = dict(mix, arrival=dict(mix["arrival"], rate=rate))
        run = core.Run(cell=args.workload, model=model, mix=m,
                       seed=args.seed, seconds=args.seconds, device="cuda",
                       device_name=torch.cuda.get_device_name(0),
                       t_start=time.perf_counter())
        items = tr.schedule(m, args.seed, args.seconds, model["vocab_size"])
        drv = core.Driver(run, me, items)
        queue, running = [], []
        inner = drv.window

        def window(inner=inner, queue=queue, running=running):
            w = inner()
            queue.append((w.t1, sum(len(s.waiting) for s in me.scheds)))
            running.append(sum(len(s.running) for s in me.scheds))
            return w
        drv.window = window
        drv.open_loop(args.seconds, float(m.get("warmup_s", 0.0)),
                      args.drain, 0.0)
        run.window_tokens = drv.tokens1 - drv.tokens0
        q = [(t, n) for t, n in queue if run.w_begin <= t <= run.w_end]
        slope = float(np.polyfit([t for t, _ in q], [n for _, n in q], 1)[0]) \
            if len(q) > 2 else float("nan")
        e = core.end_to_end(run)
        print(json.dumps({
            "rate": rate, "queue_start": q[0][1] if q else None,
            "queue_end": q[-1][1] if q else None,
            "queue_mean": float(np.mean([n for _, n in q])) if q else None,
            "queue_slope_per_s": slope,
            "running_mean": float(np.mean(running[run.first_window:
                                                  run.last_window])),
            "offered_tokens_per_s": tr.offered_output_tokens_per_s(m),
            "late_s": run.late_s, **e}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
