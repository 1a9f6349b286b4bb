"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python portbench/run.py --workload deepseek-7b.chat --seed 12345 \\
        --seconds 45 --trace 0

Builds the cell's configuration on the card through the port's own API,
warms up on the cell's traffic, measures for ``--seconds``, checks what
the window served against the plain reference, and prints one JSON line
last: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` (and with ``--trace 1`` ``breakdown``), and ``checks``, each
number compared beside its limit, which also end standard error.

Exits non-zero without a result when no card is present, when the card
count is below the cell's chips, or when a module of the JAX package (or
JAX itself) was loaded.  ``--control 1`` puts the fp8 control in the
program's place in the comparison, so the run reads not correct, and
prints the program's own readings beside it on standard error (for
setting the limits; the benchmark's own runs never pass it).
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
# a deployment's allocator setting: mixtral's exact-length prefills of 4 x
# 4090 rows free and take blocks of several GB, which fragment the cache
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import check, core

    man = core.manifest()
    cell, model, mix = core.cell_files(args.workload, man)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run, checks = core.run_cell(args.workload, model, mix, args.seed,
                                args.seconds, bool(args.trace), "cuda",
                                T_START, control=bool(args.control))
    found = core.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    if args.trace:
        entries = [m for m in man["per_layer"]
                   if core.applies(m, args.workload)]
        values = core.per_layer(run, entries)
    else:
        entries = [m for m in man["end_to_end"]
                   if core.applies(m, args.workload)]
        known = core.end_to_end(run)
        values = {m["name"]: known[m["name"]] for m in entries
                  if m["name"] in known}
    units = {m["name"]: m["unit"] for m in entries}
    attempted, failed = core.attempted_failed(run)
    ok = check.correct(checks)
    device = {"platform": "gpu", "kind": run.device_name,
              "count": cell["chips"],
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": ok, "attempted": attempted, "failed": failed,
           "metrics": {k: {"value": v, "unit": units[k]}
                       for k, v in values.items()},
           "device": device}
    if args.trace and run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    calls = run.window_calls()
    extra = {"window_s": run.window_s, "window_tokens": run.window_tokens,
             "checked_tokens": run.checked_tokens,
             "late_s": run.late_s if mix["loop"] == "open" else None,
             "calls": len(calls),
             "longest_call_s": max((w.t1 - w.t0 for w in calls), default=0),
             "warmup_calls_s": [round(w.t1 - w.t0, 3)
                                for w in run.windows[:run.first_window]][:12],
             "steps": sum(len(w.step_us) for w in calls),
             "admitted": sum(len(w.prompts) for w in calls),
             "t_drain_s": run.t_drained - run.w_end,
             "check_s": run.check_s,
             "pool_pages": run.pool_pages,
             "pool_pages_in_use_peak": run.pages_in_use}
    if run.gap_stats is not None:
        extra["gaps"] = run.gap_stats
    print(f"portbench: {json.dumps(extra)}", file=sys.stderr)
    for name, c in (run.program_checks or {}).items():
        print(f"program {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
