"""``tools/trace_spans.py`` reads a traced span whose decode steps are CUDA
graph replays: each step one ``decode.replay`` span (every kernel of the
step launched inside it, by the graph launch's correlation id) beside its
``decode.readback``, no ``moe`` or decode commit span inside a step
(an admission's prefill still opens a ``moe`` span).  On synthetic
profiler events and spans: no crash, a step's idle read, ``moe_share``
null, a replay's device span and busy time, and a span table with the
replay's row."""
import importlib.util
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from portbench import spans as sp  # noqa: E402
from repro_torch.tracing import SpanRecord  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MS = 1_000_000


def _tool():
    spec = importlib.util.spec_from_file_location(
        "trace_spans_tool", ROOT / "tools" / "trace_spans.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault(spec.name, mod)
    spec.loader.exec_module(mod)
    return mod


def _event(name, cuda, start, dur, corr):
    dev = torch.autograd.DeviceType.CUDA if cuda else \
        torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: dev, start_ns=lambda: start,
        duration_ns=lambda: dur, correlation_id=lambda: corr)


def _calibration(t0, corr0):
    """One group of calibration spans from host ns ``t0`` (the profiler's
    clock equal to the host's), each holding its marker's launch."""
    spans, events = [], []
    for i in range(sp.CALIB):
        s = t0 + 1000 * i
        spans.append(SpanRecord(sp.CALIB_SPAN, s, s + 40, -1, {}))
        events.append(_event("cudaLaunchKernel", False, s + 10, 2,
                             corr0 + i))
        events.append(_event("void at::cuda::spin_kernel(long)", True,
                             s + 20, 4, corr0 + i))
    return spans, events


def test_replayed_steps_read_without_moe_spans():
    tool = _tool()
    head, ev_head = _calibration(0, 1)
    tail, ev_tail = _calibration(200 * MS, 101)
    # a window 10-190 ms, an admission 62-90 whose prefill opens a moe
    # span, two replayed steps: 20-60 (replay 20-22, readback 50-60) and
    # 100-140 (replay 100-102, readback 130-140);
    # each graph launch runs its two kernels 25-33 and 34-46 (105-113,
    # 114-126)
    work = [SpanRecord("window", 10 * MS, 190 * MS, -1, {}),
            SpanRecord("decode.step", 20 * MS, 60 * MS, sp.CALIB,
                       {"shard": 0}),
            SpanRecord("decode.replay", 20 * MS, 22 * MS, sp.CALIB + 1, {}),
            SpanRecord("decode.readback", 50 * MS, 60 * MS, sp.CALIB + 1,
                       {}),
            SpanRecord("decode.step", 100 * MS, 140 * MS, sp.CALIB,
                       {"shard": 0}),
            SpanRecord("decode.replay", 100 * MS, 102 * MS, sp.CALIB + 4,
                       {}),
            SpanRecord("decode.readback", 130 * MS, 140 * MS, sp.CALIB + 4,
                       {}),
            SpanRecord("window.admission", 62 * MS, 90 * MS, sp.CALIB, {}),
            SpanRecord("admit.prefill", 63 * MS, 89 * MS, sp.CALIB + 7, {}),
            SpanRecord("moe", 64 * MS, 88 * MS, sp.CALIB + 8, {})]
    spans = head + work + tail
    events = ev_head + ev_tail
    for corr, launch, run in ((50, 21 * MS, 25 * MS), (51, 101 * MS,
                                                       105 * MS)):
        events.append(_event("cudaGraphLaunch", False, launch, 1000, corr))
        events.append(_event("paged_attention_kernel", True, run, 8 * MS,
                             corr))
        events.append(_event("gemm", True, run + 9 * MS, 12 * MS, corr))
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    run_ = types.SimpleNamespace(
        trace={"t0": 0.005, "t1": 0.195, "idle_gaps": [("x", 0.1)]},
        window_calls=lambda traced: [])
    got = tool.read_spans(run_, prof, spans)
    assert got["steps"] == got["replays"] == 2
    assert got["moe_share"] is None
    assert got["alloc_share"] == 0.0
    # each step idles 20-25, 33-34 and 46-60 of its 40 ms
    assert got["decode_idle_ms"] == pytest.approx(20.0, abs=1e-3)
    assert got["attributed"] == {"correlation": 24, "device start": 0}
    # each replay's kernels span 21 ms, 1 of them the gap between the two
    assert got["replay_device"] == {"replays": 2, "span_ms": 21.0,
                                    "busy_ms": pytest.approx(20.0),
                                    "kernels": 2.0}
    rows = {row[0]: row for row in got["table"]}
    assert rows["decode.replay"][1] == 2 and rows["decode.step"][1] == 2
    assert "decode.forward" not in rows and rows["moe"][1] == 1
