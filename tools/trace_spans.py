#!/usr/bin/env python3
"""A benchmark cell on one NVIDIA card with the program's spans on: the
readings of ``portbench/spans.py`` that the harness does not take, and
what the span recorder costs.

    python3 tools/trace_spans.py --workload deepseek-7b.chat --seeds 7 \\
        --seconds 51 --mode trace
    python3 tools/trace_spans.py --workload mixtral-8x7b.chat \\
        --seeds 1 2 3 --mode cost
    python3 tools/trace_spans.py --probe

``--mode trace`` runs the cell as ``portbench/run.py --trace 1`` does
(``portbench.core.run_cell``) and turns ``repro_torch.tracing`` on over
the profiler's span.  The program's spans reach the profiler's clock
through two calibrated anchors, one at each end: ten short spans, each
holding one marker kernel's launch, bound the offset between the two
clocks to a few microseconds (``portbench.spans.calibrate`` and
``calibrated``); the drift between the two anchors is printed.  One JSON
line: the cell's per-layer metrics, the device-idle ms inside each
``decode.step``, the MoE share of the steps' device time, the host share
of ``alloc.commit``, the share of the steps' idle time under a child
span, the idle seconds by the innermost program span (the benchmark's
own labels where none is open), how each kernel found its span (launch
correlation id or device start), and each span's count, total and self
ms.

Where the decode step is a CUDA graph replay (the card's path,
``repro_torch.serve.decode_graph``), a step is one ``decode.replay``
span beside its ``decode.readback``: every kernel of the step launches
inside it.  The step's ``moe``, ``moe.route``, ``decode.forward``,
``decode.alloc`` and ``alloc.commit[decode]`` spans are not opened, so
``moe_share`` reads null and ``alloc_share`` holds only the admission,
release and window commits; ``replays`` counts the replayed steps, and
``replay_device`` gives a replay's device span (first kernel's start to
last one's end), the kernels' busy time in it and their number: the span
less the busy time is the idle between the graph's kernels.

``--mode cost`` builds the cell's program once and serves, for each
seed, the first ``lanes`` requests of the cell's traffic (outputs capped
at 128 tokens) to completion three times: a warm-up, then twice with the
recorder on for every other decode step (the even ones, then the odd
ones), so that both sides sample the same stretch of the host's time
and neighbouring steps the same batch.  It prints each pass's mean
decode step (``step_times_us``) with the recorder on and off, the median
change from a step to its neighbour, and spans per step.

``--probe`` checks the clock: twenty ``torch.cuda._sleep`` kernels, each
launched inside a span right after a ``synchronize()``, 0.5 s apart,
under the profiler, between the calibration spans; it prints how far
after its span's start each kernel started on the device through the
calibrated anchors, their drift, and what one span costs the host with
the recorder off and on.

The modes skip the benchmark's reference check (``portbench/run.py``
makes it).  Fails without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
# the allocator setting portbench/run.py runs the cells with
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

from portbench import check, core  # noqa: E402
from portbench import spans as sp  # noqa: E402
from portbench import trace as trc  # noqa: E402
from portbench import traffic as tr  # noqa: E402
from repro_torch import tracing  # noqa: E402

OUTPUT_CAP = 128
#: the span of a decode step replayed as a CUDA graph
REPLAY = "decode.replay"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def clock_of(spans: list, ops: list, launches: dict) -> tuple[list, dict]:
    """``(the spans less the calibration ones, {"anchors", "fit_width_us",
    "drift_ns", "calib_anchored", "calib_marks"})``: which of the two
    calibration groups gave an anchor, and the marker kernels in each
    half of the profile with the number that lack a launch event; raises
    where no calibration group paired."""
    rest, anchors, widths = sp.calibrated(spans, ops, launches)
    if anchors is None:
        marks = sum("spin_kernel" in n and c in launches for n, _, _, c in ops)
        cal = sum(s.name == sp.CALIB_SPAN for s in spans)
        raise SystemExit(f"trace_spans: no calibration group paired: {cal} "
                         f"calibration spans, {marks} marker launches")
    # which ends paired, and the markers the profiler kept in each half
    starts = [s.start_ns for s in spans if s.name == sp.CALIB_SPAN]
    hosts = [h for h, _ in anchors]
    mid = (min(launches.values()) + max(launches.values())) / 2
    marks = [launches.get(c, s) for n, s, _, c in ops if "spin_kernel" in n]
    lost = sum(c not in launches for n, _, _, c in ops if "spin_kernel" in n)
    return rest, {"anchors": anchors,
                  "fit_width_us": [w / 1e3 for w in widths],
                  "drift_ns": anchors[-1][1] - anchors[0][1],
                  "calib_anchored": [starts[0] in hosts,
                                     starts[-sp.CALIB] in hosts],
                  "calib_marks": [sum(t < mid for t in marks),
                                  sum(t >= mid for t in marks), lost]}


def replay_device(spans: list, ops: list, owner: list) -> Optional[dict]:
    """Per replayed decode step (the kernels launched inside one
    ``decode.replay`` span), the mean device span from its first kernel's
    start to its last one's end, the kernels' busy time inside it and
    their number; ``None`` where no step was replayed."""
    groups: dict = {}
    for (_, s, e, _), i in zip(ops, owner):
        if i >= 0 and spans[i].name == REPLAY:
            groups.setdefault(i, []).append((s, e))
    if not groups:
        return None
    n = len(groups)
    return {"replays": n,
            "span_ms": sum(max(e for _, e in iv) - min(s for s, _ in iv)
                           for iv in groups.values()) / n / 1e6,
            "busy_ms": sum(trc.union_seconds(iv)[0]
                           for iv in groups.values()) / n * 1e3,
            "kernels": sum(len(iv) for iv in groups.values()) / n}


def read_spans(run_, prof, spans: list) -> dict:
    """The span readings of a traced run (its profiler still open)."""
    t = run_.trace
    ops, launches = sp.trace_events(prof)
    spans, clk = clock_of(spans, ops, launches)
    anchors = clk.pop("anchors")
    f = sp.trace_clock(anchors)
    lo_h, hi_h = int(t["t0"] * 1e9), int(t["t1"] * 1e9)
    lo, hi = f(lo_h), f(hi_h)
    mapped = sp.on_trace_clock(spans, anchors)
    segs = sp.innermost(mapped)
    _, merged = trc.union_seconds((s, e) for _, s, e, _ in ops)
    idle = sp.idle_intervals(merged, lo, hi)
    fallback = [(f(int(a * 1e9)), f(int(b * 1e9)), label) for a, b, label
                in trc.host_segments(run_.window_calls(traced=True),
                                     t["t0"], t["t1"])]
    gaps = sp.idle_by_label(idle, sp.overlay(sp.labelled(mapped, segs),
                                             fallback))
    owner, how = sp.attribute(ops, launches, segs)
    return {
        "decode_idle_ms": sp.decode_idle_ms(mapped, idle, lo, hi),
        # a replayed step opens no moe span (a prefill still does):
        # nothing to split out
        "moe_share": sp.moe_share(mapped, ops, owner)
        if any(s.name == "moe" and sp.under(spans, i, sp.DECODE_STEP)
               for i, s in enumerate(spans)) else None,
        "alloc_share": sp.alloc_share(spans, lo_h, hi_h),
        "replay_device": replay_device(mapped, ops, owner),
        "child_idle_share": sp.child_idle_share(mapped, idle, segs),
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1]),
        "idle_s": sum(gaps.values()),
        "harness_idle_s": sum(s for _, s in t["idle_gaps"]),
        **clk,
        "attributed": how,
        "launch_events": len(launches),
        "steps": sum(lo_h <= s.start_ns < hi_h for s in spans
                     if s.name == sp.DECODE_STEP),
        "replays": sum(lo_h <= s.start_ns < hi_h for s in spans
                       if s.name == REPLAY),
        "spans": len(spans),
        "table": [[n, c, round(tt, 3), round(x, 3)]
                  for n, c, tt, x in tracing.summary(spans)],
    }


def traced_run(workload: str, seed: int, seconds: float) -> dict:
    """``--mode trace``: the harness's traced run with spans on."""
    got: dict = {}
    start, stop, reduce = core.Driver.trace_start, core.Driver.trace_stop, \
        trc.reduce

    def trace_start(self):
        start(self)
        tracing.enable()
        sp.calibrate()

    def trace_stop(self):
        sp.calibrate()
        tracing.disable()
        stop(self)

    def reduce_and_read(run_, prof):
        reduce(run_, prof)
        got.update(read_spans(run_, prof, tracing.drain()))

    torch.cuda._sleep(1)                  # load the marker's module first
    core.Driver.trace_start, core.Driver.trace_stop = trace_start, trace_stop
    trc.reduce = reduce_and_read
    try:
        cell, model, mix = core.cell_files(workload, core.manifest())
        run_, _ = core.run_cell(workload, model, mix, seed, seconds, True,
                                "cuda", time.perf_counter())
    finally:
        core.Driver.trace_start, core.Driver.trace_stop = start, stop
        trc.reduce = reduce
    per = core.per_layer(run_, [m for m in core.manifest()["per_layer"]
                                if core.applies(m, workload)])
    print(f"trace_spans: calibrated clock (widths {got['fit_width_us']} "
          f"us, drift {got['drift_ns']} ns; ends anchored "
          f"{got['calib_anchored']}, markers by half and unlaunched "
          f"{got['calib_marks']}), {got['attributed']} kernels placed",
          file=sys.stderr)
    return {"workload": workload, "seed": seed, "card": card(),
            "per_layer": per, "end_to_end": core.end_to_end(run_),
            "busy_s": run_.trace["busy_s"],
            "window_s": run_.trace["window_s"], **got}


def serve_pass(me, items: list, parity: int) -> dict:
    """Serve ``items`` to completion with the recorder on for every other
    decode step (those of ``parity``; ``-1``: none): neighbouring steps
    carry the same batch, so each pair compares step for step."""
    from repro_torch.serve.scheduler import Request
    tracing.disable()
    tracing.drain()
    me.submit([Request(rid=it.rid, tokens=it.prompt,
                       max_new_tokens=min(it.max_new_tokens, OUTPUT_CAP))
               for it in items])
    step_us: list = []

    def toggled(inner):
        def step():
            on = len(step_us) % 2 == parity
            tracing.enable() if on else tracing.disable()
            try:
                return inner()
            finally:
                tracing.disable()
                step_us.append(inner.__self__.last_step.duration_us)
        return step

    for eng in me.engines:
        eng.step = toggled(eng.step)
    try:
        while me.has_work:
            me.step_window()
    finally:
        for eng in me.engines:
            del eng.step
    names = [s.name for s in tracing.drain()]
    on = step_us[parity::2] if parity >= 0 else []
    off = step_us[1 - parity::2] if parity >= 0 else step_us
    pairs = [(a - b) / b for a, b in zip(on, off)] if parity == 0 else \
        [(a - b) / b for a, b in zip(on, off[1:])]
    return {"off_ms": statistics.mean(off) / 1e3,
            "on_ms": statistics.mean(on) / 1e3 if on else None,
            "pair_median_pct": 100 * statistics.median(pairs)
            if pairs else None,
            "steps": len(step_us),
            "spans_per_step": names.count(sp.DECODE_STEP)
            and len(names) / names.count(sp.DECODE_STEP)}


def cost_runs(workload: str, seeds: list) -> list:
    """``--mode cost``: the same requests served with the recorder on in
    every other decode step."""
    cell, model, mix = core.cell_files(workload, core.manifest())
    core.build_kernels()
    me, _ = core.build_program(model, mix, seeds[0], "cuda")
    out = []
    for seed in seeds:
        items = tr.schedule(mix, seed, 51.0, model["vocab_size"])[
            :me.kvcfg.max_lanes * me.n_engines]
        serve_pass(me, items, -1)                           # warm-up
        for parity in (0, 1):
            row = {"workload": workload, "seed": seed, "on": parity,
                   **serve_pass(me, items, parity)}
            print(json.dumps(row), flush=True)
            out.append(row)
    on = statistics.mean(r["on_ms"] for r in out)
    off = statistics.mean(r["off_ms"] for r in out)
    print(f"trace_spans: mean decode step {off:.4f} ms off, {on:.4f} ms "
          f"on ({100 * (on / off - 1):+.3f}%), median of step pairs "
          f"{statistics.median(r['pair_median_pct'] for r in out):+.3f}% "
          f"over seeds {seeds}", file=sys.stderr)
    return out


def probe(n: int = 20, gap_s: float = 0.5, cycles: int = 2_000_000
          ) -> dict:
    """``--probe``: device start of a kernel launched in a span after a
    ``synchronize()``, less the span's start, on the profiler's clock
    through the calibrated anchors."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda._sleep(cycles)                       # load the module
    torch.cuda.synchronize()
    tracing.drain()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tracing.enable()
        sp.calibrate()
        for _ in range(n):
            time.sleep(gap_s)
            torch.cuda.synchronize()
            with tracing.span("probe"):
                torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
        sp.calibrate()
        tracing.disable()
        torch.cuda.synchronize()
    ops, launches = sp.trace_events(prof)
    probes, clk = clock_of(tracing.drain(), ops, launches)
    spin = sorted(s for name, s, _, _ in ops if "spin_kernel" in name)
    if len(spin) != n + 2 * sp.CALIB or len(probes) != n:
        raise SystemExit(f"probe: {len(spin)} sleep kernels in the trace, "
                         f"not {n + 2 * sp.CALIB}")
    f = sp.trace_clock(clk.pop("anchors"))
    off = [(k - f(s.start_ns)) / 1e3
           for k, s in zip(spin[sp.CALIB:-sp.CALIB], probes)]
    return {"card": card(), "span_ns": span_cost(), **clk,
            "offsets_us": [round(x, 3) for x in off],
            "median_us": statistics.median(off)}


def span_cost(n: int = 200_000) -> dict:
    """Host ns of one empty span, two levels deep (the cost of a child
    span inside an open one), with the recorder off and on."""
    out = {}
    for on in (False, True):
        tracing.enable() if on else tracing.disable()
        with tracing.span("outer"):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with tracing.span("decode.forward"):
                    pass
            dt = time.perf_counter_ns() - t0
        tracing.disable()
        tracing.drain()
        out["on" if on else "off"] = dt / n
    return out


def main(argv=None) -> int:
    paras = __doc__.split("\n\n")
    ap = argparse.ArgumentParser(
        description=paras[0],
        epilog=next(p for p in paras if p.startswith("Where the decode")))
    ap.add_argument("--workload")
    ap.add_argument("--seeds", type=int, nargs="+", default=[7])
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--mode", choices=("trace", "cost"), default="trace")
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("trace_spans: needs a CUDA card")
    # the reference check is portbench/run.py's; these runs only time
    check.checks = lambda *a, **k: {}
    if args.probe:
        print(json.dumps({"probe": probe()}), flush=True)
    if args.workload is None:
        return 0
    if args.mode == "cost":
        cost_runs(args.workload, args.seeds)
        return 0
    for seed in args.seeds:
        print(json.dumps(traced_run(args.workload, seed, args.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
