"""The program's timing as the benchmark reads it (``portbench/spans.py``),
on synthetic records: the stamp tails, the clock mapping and its
calibration, the idle gaps labelled by the innermost program span (their
total unchanged), each kernel's span by correlation id, and the readings of decode-step idle
time, MoE share and allocator share; then a tiny run on the CPU, whose
``--trace 0`` path records no span."""
import math
import types

import pytest

from portbench import core, spans as sp, trace
from portbench import traffic as tr
from repro_torch import tracing
from repro_torch.tracing import SpanRecord

from . import tiny

MS = 1_000_000          # ns


def _span(name, s, e, parent=-1, **attrs):
    return SpanRecord(name, s, e, parent, attrs)


def _tree():
    """A window 0-100 ms: admission 0-20 (prefill 2-15), a decode step
    20-80 (forward 20-50 with one moe 30-45 around its route 30-35, alloc
    50-60 with a commit 52-58, readback 62-78), the window commit
    85-95 with its commit 86-90."""
    return [_span("window", 0, 100 * MS),
            _span("window.admission", 0, 20 * MS, 0, shard=0, rids=[4]),
            _span("admit.prefill", 2 * MS, 15 * MS, 1),
            _span("decode.step", 20 * MS, 80 * MS, 0, shard=0),
            _span("decode.forward", 20 * MS, 50 * MS, 3),
            _span("moe", 30 * MS, 45 * MS, 4),
            _span("moe.route", 30 * MS, 35 * MS, 5),
            _span("decode.alloc", 50 * MS, 60 * MS, 3),
            _span("alloc.commit", 52 * MS, 58 * MS, 7, kind="decode"),
            _span("decode.readback", 62 * MS, 78 * MS, 3),
            _span("window.commit", 85 * MS, 95 * MS, 0),
            _span("alloc.commit", 86 * MS, 90 * MS, 10, kind="window")]


def _due(due, t_submit, t_admit, t_first, state="finished", t_done=None,
         n_out=1):
    req = types.SimpleNamespace(t_submit=t_submit, t_admit=t_admit,
                                t_first=t_first, t_done=t_done,
                                output=[0] * n_out, state=state)
    return core.Req(tr.Item(0, due, None, 1, "window"), req, due)


def _run(reqs, t_drained=50.0):
    run = core.Run(cell="c", model={}, mix={"loop": "open"}, seed=0,
                   seconds=10, device="cuda", device_name="x")
    run.reqs, run.t_drained = reqs, t_drained
    return run


def test_stamp_tails_count_the_unserved_to_the_drain():
    s = 1e9
    reqs = [_due(10.0 + i, int((10.0 + i) * s), int((10.1 + i) * s),
                 int((10.3 + i) * s)) for i in range(9)]
    reqs.append(_due(20.0, int(20.0 * s), None, None, state="waiting"))
    run = _run(reqs)
    wait = sp.stamp_tail_ms(run, "t_submit", "t_admit")
    first = sp.stamp_tail_ms(run, "due", "t_first")
    # nine requests at 100 / 300 ms, the tenth waits to the drain (30 s)
    assert wait == pytest.approx(100.0, abs=1e-3)
    assert first == pytest.approx(300.0, abs=1e-3)
    assert sp.stamp_tail_ms(run, "t_submit", "t_admit", q=100) == \
        pytest.approx(30000.0, abs=1e-3)
    assert core.reader_of("queue_wait_p90_ms").read(run) == wait
    assert core.reader_of("first_token_p90_ms").read(run) == first


def test_stamp_tpot_counts_the_unserved_to_the_drain():
    """Nine requests of 11 tokens finish 200 + 10 i ms after their first
    token (20 + i ms a token); the tenth, cut at the drain, counts from
    its first token to the drain's end (50 s) over its 6 tokens."""
    s = 1e9
    reqs = [_due(10.0 + i, 0, 0, int((10.3 + i) * s),
                 t_done=int((10.5 + i + 0.01 * i) * s), n_out=11)
            for i in range(9)]
    cut = _due(20.0, 0, 0, int(40.0 * s), state="running", n_out=6)
    run = _run(reqs + [cut])
    assert sp.stamp_tpot_ms(run) == pytest.approx(28.0, abs=1e-3)
    assert sp.stamp_tpot_ms(run, q=100) == pytest.approx(2000.0, abs=1e-3)
    assert core.reader_of("tpot_stamp_p90_ms").read(run) == \
        sp.stamp_tpot_ms(run)
    assert core.reader_of("tpot_stamp_p90_ms.open").read(run) == \
        sp.stamp_tpot_ms(run)
    # a finished request that the harness cut at the close counts to the
    # drain too
    cut.request.state, cut.truncated = "finished", True
    cut.request.t_done = int(41.0 * s)
    assert sp.stamp_tpot_ms(run, q=100) == pytest.approx(2000.0, abs=1e-3)


def test_stamp_tails_read_nothing_without_stamps():
    """The parent's ``Request`` has no stamps: the readers return None."""
    r = core.Req(tr.Item(0, 1.0, None, 1, "window"),
                 types.SimpleNamespace(output=[0], state="finished"), 1.0)
    for name in ("queue_wait_p90_ms", "first_token_p90_ms",
                 "tpot_stamp_p90_ms", "tpot_stamp_p90_ms.open"):
        assert core.reader_of(name).read(_run([r])) is None
        assert core.reader_of(name).read(_run([])) is None


def test_clock_mapping_through_two_anchors():
    # an anchor is (host ns, profiler ns less host ns); 10 s later the
    # offset has drifted by 2 us
    a0 = (1_000, 5_000_000_000_000)
    a1 = (10_000_001_000, a0[1] + 2_000)
    f = sp.trace_clock([a0, a1])
    assert f(1_000) == 1_000 + a0[1]
    assert f(10_000_001_000) == 10_000_001_000 + a0[1] + 2_000
    assert f(5_000_001_000) == 5_000_001_000 + a0[1] + 1_000
    one = sp.trace_clock([a0])
    assert one(7) == 7 + a0[1]
    moved = sp.on_trace_clock(_tree()[:2], [a0])
    assert moved[1].start_ns == a0[1] and moved[1].parent == 0
    assert moved[1].attrs == {"shard": 0, "rids": [4]}


def _calibration(t0, offset, n=sp.CALIB):
    """``n`` calibration spans of 40 ns from host ns ``t0``, 1000 ns
    apart, each launching its marker 10 + 3 i ns in, on a profiler clock
    ``offset`` ns ahead; ``(spans, ops, launches)``."""
    spans, ops, launches = [], [], {}
    for i in range(n):
        s = t0 + 1000 * i
        spans.append(_span(sp.CALIB_SPAN, s, s + 40))
        corr = t0 + i
        launches[corr] = s + 10 + 3 * i + offset
        ops.append(("void at::cuda::spin_kernel(long)", launches[corr] + 5,
                    launches[corr] + 9, corr))
    return spans, ops, launches


def test_offset_fitted_to_the_calibration_launches():
    """Each calibration span holds its marker's launch: the launches at
    10..37 ns into spans of 40 ns bound the offset to [offset - 3,
    offset + 10]; the anchor is the middle, and the drift between the two
    groups is the clock's."""
    a = _calibration(0, 1_000_000)
    b = _calibration(10_000_000_000, 1_002_000)
    work = [_span("window", 20_000, 9_000_000_000),
            _span("decode.step", 30_000, 40_000, sp.CALIB)]
    spans = a[0] + work + b[0]          # the step's parent: the window
    ops, launches = a[1] + b[1], {**a[2], **b[2]}
    rest, anchors, widths = sp.calibrated(spans, ops, launches)
    assert [(s.name, s.parent) for s in rest] == [("window", -1),
                                                  ("decode.step", 0)]
    assert widths == [13, 13]
    assert anchors == [(0, 1_000_000 + 3), (10_000_000_000, 1_002_000 + 3)]
    f = sp.trace_clock(anchors)
    assert f(5_000_000_000) - 5_000_000_000 == 1_001_000 + 3
    # the launch windows bound the offset to their intersection
    assert sp.launch_offset([(0, 40, 1030), (100, 160, 1152)]) == (992, 1030)
    assert sp.launch_offset([(0, 40, 1030), (300, 310, 1400)]) is None
    assert sp.launch_offset([]) is None
    # a group whose launches no offset fits gives no anchor
    late = dict(launches)
    late[b[1][0][3]] += 100
    _, one, _ = sp.calibrated(spans, ops, late)
    assert one == anchors[:1]
    # the last group's markers lost: the first group's anchor alone; the
    # first group's lost: the last's; no calibration: no clock
    window_launch = {99: 9_000_000_000 + 1_001_000}
    _, head, _ = sp.calibrated(spans, a[1], {**a[2], **window_launch})
    assert head == anchors[:1]
    _, tail, _ = sp.calibrated(spans, b[1], {**b[2], 99: 1_000_500})
    assert tail == anchors[1:]
    assert sp.calibrated(work, ops, launches)[1] is None
    # one group of spans pairs with its own markers
    assert sp.calibrated(a[0], a[1], a[2])[1] == anchors[:1]


def test_innermost_segments_tile_the_spans():
    spans = _tree()
    segs = sp.innermost(spans)
    names = [(s // MS, e // MS, spans[i].name) for s, e, i in segs]
    assert names == [
        (0, 2, "window.admission"), (2, 15, "admit.prefill"),
        (15, 20, "window.admission"), (20, 30, "decode.forward"),
        (30, 35, "moe.route"), (35, 45, "moe"), (45, 50, "decode.forward"),
        (50, 52, "decode.alloc"), (52, 58, "alloc.commit"),
        (58, 60, "decode.alloc"), (60, 62, "decode.step"),
        (62, 78, "decode.readback"), (78, 80, "decode.step"),
        (80, 85, "window"), (85, 86, "window.commit"),
        (86, 90, "alloc.commit"), (90, 95, "window.commit"),
        (95, 100, "window")]


def test_idle_gaps_labelled_by_program_spans_with_totals_unchanged():
    """The device is busy 22-28, 40-44 and 60-79 ms of a traced span
    -10-110 ms; the benchmark's own labels cover the time no program span
    covers (before and after the window)."""
    spans = _tree()
    busy = [(22 * MS, 28 * MS), (40 * MS, 44 * MS), (60 * MS, 79 * MS)]
    events = [("k", s, e) for s, e in busy]
    w = core.Window(t0=-0.010, t1=0.105, steps=[(0.020, 0.080)])
    lo, hi = -10 * MS, 110 * MS
    old = trace.summarise(events, lo / 1e9, hi / 1e9, 0, [w])
    _, merged = trace.union_seconds(busy)
    idle = sp.idle_intervals(merged, lo, hi)
    fallback = [(int(a * 1e9), int(b * 1e9), label) for a, b, label
                in trace.host_segments([w], lo / 1e9, hi / 1e9)]
    segs = sp.overlay(sp.labelled(spans, sp.innermost(spans)), fallback)
    gaps = sp.idle_by_label(idle, segs)
    assert sum(gaps.values()) == pytest.approx(
        sum(s for _, s in old["idle_gaps"]))
    ms = {k: round(v * 1e3, 6) for k, v in gaps.items()}
    assert ms == {trace.REST: 10.0 + 5.0, trace.LOOP: 5.0,
                  "window.admission": 2.0 + 5.0, "admit.prefill": 13.0,
                  "decode.forward": 2.0 + 2.0 + 5.0, "moe.route": 5.0,
                  "moe": 5.0 + 1.0, "decode.alloc": 2.0 + 2.0,
                  "alloc.commit": 6.0 + 4.0, "window": 5.0 + 5.0,
                  "window.commit": 1.0 + 5.0, "decode.step": 1.0}
    assert sum(ms.values()) == pytest.approx(
        120.0 - 6.0 - 4.0 - 19.0)


def test_kernels_take_the_span_of_their_launch():
    spans = _tree()
    segs = sp.innermost(spans)
    # (name, device start, end, correlation id): the first two launched
    # in the moe's route and the commit, run later on the device; the
    # third has no launch event and falls back to its device start
    ops = [("gemm", 61 * MS, 63 * MS, 7), ("burst", 64 * MS, 65 * MS, 8),
           ("copy", 70 * MS, 72 * MS, 9), ("late", 120 * MS, 121 * MS, 10)]
    launches = {7: 31 * MS, 8: 53 * MS, 10: 119 * MS}
    owner, how = sp.attribute(ops, launches, segs)
    assert [spans[i].name if i >= 0 else None for i in owner] == \
        ["moe.route", "alloc.commit", "decode.readback", None]
    assert how == {"correlation": 3, "device start": 1}
    # 2 ms of moe among 5 ms launched inside the decode step
    assert sp.moe_share(spans, ops, owner) == pytest.approx(40.0)


def test_decode_idle_alloc_share_and_child_share():
    spans = _tree()
    busy = [(22 * MS, 28 * MS), (40 * MS, 44 * MS), (60 * MS, 79 * MS)]
    _, merged = trace.union_seconds(busy)
    idle = sp.idle_intervals(merged, 0, 100 * MS)
    # idle inside the step 20-80: 20-22, 28-40, 44-60, 79-80 = 31 ms
    assert sp.decode_idle_ms(spans, idle, 0, 100 * MS) == pytest.approx(31.0)
    assert sp.decode_idle_ms(spans, idle, 90 * MS, 100 * MS) is None
    # of which 1 ms (79-80) is the step's self time
    assert sp.child_idle_share(spans, idle, sp.innermost(spans)) == \
        pytest.approx(100.0 * 30 / 31)
    # 6 + 4 ms of commits in 0-100 ms; 3 + 4 ms in 55-105
    assert sp.alloc_share(spans, 0, 100 * MS) == pytest.approx(10.0)
    assert sp.alloc_share(spans, 55 * MS, 105 * MS) == pytest.approx(14.0)
    assert sp.alloc_share(spans, 5, 5) is None


def test_trace_events_pair_kernels_with_launches():
    torch = pytest.importorskip("torch")
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, dev, s, d, corr):
        return types.SimpleNamespace(
            name=lambda: name, device_type=lambda: dev, start_ns=lambda: s,
            duration_ns=lambda: d, correlation_id=lambda: corr)
    events = [ev("cudaLaunchKernel", cpu, 100, 5, 11),
              ev("paged_attention_kernel", cuda, 150, 20, 11),
              ev("Memcpy DtoH", cuda, 180, 4, 12),
              ev("aten::mm", cpu, 90, 50, 0)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    ops, launches = sp.trace_events(prof)
    assert ops == [("paged_attention_kernel", 150, 170, 11),
                   ("Memcpy DtoH", 180, 184, 12)]
    assert launches == {11: 100}


def test_untraced_run_records_no_span_and_reads_the_stamps():
    tracing.drain()
    run, checks = tiny.run(requests=2)
    assert not tracing.RECORDER.on and tracing.drain() == []
    wait = core.reader_of("queue_wait_p90_ms").read(run)
    first = core.reader_of("first_token_p90_ms").read(run)
    tpot = core.reader_of("tpot_stamp_p90_ms").read(run)
    ttft = core.end_to_end(run)["ttft_p90_ms"]
    assert math.isfinite(wait) and math.isfinite(first)
    assert 0 < tpot < math.inf
    # pointwise: submitted at or after due, first token after admission,
    # stamped inside the call whose end the harness reads
    assert 0 <= wait <= first <= ttft
