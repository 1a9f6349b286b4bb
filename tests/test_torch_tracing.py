"""The port's spans and request stamps (``repro_torch.tracing``), on the
CPU at smoke size: the recorder's no-op path and its parent links, the
span tree of a multi-engine window, one ``alloc.commit`` per counted
commit, ``step_times_us`` read from the ``decode.step`` spans, each
request's four stamps in order (a preempted one keeps its first), and
the serve launcher's ``--spans`` table (the commits by kind)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import init_params, make_paged_config  # noqa: E402
from repro_torch.serve.multi_engine import MultiEngine  # noqa: E402
from repro_torch.serve.scheduler import Request, make_scheduler_config  # noqa: E402

WINDOW_CHILDREN = {"window.admission", "decode.step", "window.commit"}
#: span name -> the names its parent may have
PARENTS = {
    "window": {None},
    "window.admission": {"window"},
    "decode.step": {"window"},
    "window.commit": {"window"},
    "admit.prefill": {"window.admission"},
    "admit.readback": {"window.admission"},
    "decode.forward": {"decode.step"},
    "decode.alloc": {"decode.step"},
    "decode.readback": {"decode.step"},
    "moe": {"decode.forward", "admit.prefill"},
    "moe.route": {"moe"},
    "moe.experts": {"moe"},
    "alloc.commit": {"window.admission", "decode.alloc", "window.commit"},
}


@pytest.fixture(autouse=True)
def recorder_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _deployment(arch, n_engines=2, lanes=2, quantum=3, preemption=False):
    cfg = smoke_config(arch)
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    kvcfg = make_paged_config(cfg, seq_len=64, lanes=lanes, page_size=4,
                              dtype=torch.float32)
    scfg = make_scheduler_config(cfg, kvcfg, max_prompt_len=32)
    return cfg, MultiEngine(cfg, kvcfg, params, n_engines=n_engines,
                            sched_cfg=scfg, quantum=quantum,
                            preemption=preemption, device="cpu")


def _requests(vocab, lens, seed=3):
    rng = np.random.RandomState(seed)
    return [Request(rid=i, tokens=rng.randint(0, vocab, n).astype(np.int32))
            for i, n in enumerate(lens)]


@pytest.fixture(scope="module")
def moe_run():
    """Two mixtral smoke shards serving 5 requests with spans on:
    ``(deployment, spans, step_times_us, requests)``."""
    tracing.enable()
    try:
        cfg, me = _deployment("mixtral-8x7b")
        reqs = _requests(cfg.vocab_size, (9, 13, 9, 13, 9))
        step_us: list = []
        me.serve(reqs, max_new_tokens=6, step_times_us=step_us)
    finally:
        tracing.disable()
    return me, tracing.drain(), step_us, reqs


def test_off_records_nothing_and_returns_the_shared_no_op():
    a = tracing.span("window")
    with tracing.span("decode.step", shard=1) as b:
        with tracing.span("moe"):
            pass
    assert a is b is tracing.NO_SPAN
    with tracing.timed("decode.step", shard=0) as t:
        pass
    assert t.end_ns >= t.start_ns > 0          # timed reads the clock
    assert tracing.drain() == []


def test_on_nested_spans_carry_their_parents_and_self_time():
    tracing.enable()
    with tracing.span("a", rid=7) as a:
        with tracing.span("b"):
            with tracing.span("c"):
                pass
        with tracing.timed("d", shard=2):
            pass
        a.note(extra=1)
    with tracing.span("e"):
        pass
    tracing.disable()
    spans = tracing.drain()
    assert [s.name for s in spans] == ["a", "b", "c", "d", "e"]
    assert [s.parent for s in spans] == [-1, 0, 1, 0, -1]
    assert spans[0].attrs == {"rid": 7, "extra": 1}
    assert spans[3].attrs == {"shard": 2}
    for s in spans:
        assert s.end_ns >= s.start_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    rows = {n: (c, t, x) for n, c, t, x in tracing.summary(spans)}
    a, b, c, d = spans[:4]
    assert rows["a"][2] * 1e6 == pytest.approx(
        (a.end_ns - a.start_ns) - (b.end_ns - b.start_ns)
        - (d.end_ns - d.start_ns))
    assert rows["c"][1] == rows["c"][2]          # a leaf: self == total
    assert tracing.drain() == []


def test_drain_inside_an_open_span_raises():
    tracing.enable()
    with tracing.span("window"):
        with pytest.raises(RuntimeError, match="open span"):
            tracing.drain()
    assert [s.name for s in tracing.drain()] == ["window"]


def test_window_span_tree(moe_run):
    me, spans, _, _ = moe_run
    names = [s.name for s in spans]
    assert set(names) == set(PARENTS)
    for s in spans:
        parent = spans[s.parent].name if s.parent >= 0 else None
        assert parent in PARENTS[s.name], (s.name, parent)
    windows = [i for i, s in enumerate(spans) if s.name == "window"]
    assert len(windows) == me.stats.windows
    for w in windows:
        kids = {s.name for s in spans if s.parent == w}
        assert kids <= WINDOW_CHILDREN and "window.commit" in kids
    steps = [s for s in spans if s.name == "decode.step"]
    assert len(steps) == me.stats.decode_steps
    assert {s.attrs["shard"] for s in steps} == {0, 1}
    for i, s in enumerate(spans):
        if s.name == "decode.step":
            kids = [k.name for k in spans if k.parent == i]
            assert kids == ["decode.forward", "decode.alloc",
                            "decode.readback"]
            moes = [k for k in spans if k.name == "moe"
                    and spans[k.parent].parent == i]
            assert len(moes) == me.cfg.num_layers
    routes = [s for s in spans if s.name == "moe.route"]
    assert len(routes) == names.count("moe") == names.count("moe.experts")
    admitted = sorted(r for s in spans if s.name == "window.admission"
                      for r in s.attrs.get("rids", ()))
    assert admitted == list(range(5))
    # completions ride the window's merged commit: no release burst
    assert {s.attrs["kind"] for s in spans if s.name == "alloc.commit"} \
        == {"admission", "decode", "window"}


def test_one_alloc_commit_per_counted_commit(moe_run):
    me, spans, _, _ = moe_run
    commits = [s for s in spans if s.name == "alloc.commit"]
    counted = sum(e.stats.commits for e in me.engines) \
        + me.stats.window_bursts
    assert len(commits) == counted
    kinds = [s.attrs["kind"] for s in commits]
    assert kinds.count("window") == me.stats.window_bursts
    assert kinds.count("decode") == sum(e.stats.decode_commits
                                        for e in me.engines)
    assert kinds.count("admission") == sum(e.stats.hmq_admit_bursts
                                           for e in me.engines)


def test_step_times_are_the_decode_step_spans(moe_run):
    _, spans, step_us, _ = moe_run
    assert step_us == [(s.end_ns - s.start_ns) / 1e3 for s in spans
                       if s.name == "decode.step"]


def test_request_stamps_in_order(moe_run):
    _, spans, _, reqs = moe_run
    win = [s for s in spans if s.name == "window"]
    for r in reqs:
        assert r.state == "finished"
        assert r.t_submit <= r.t_admit <= r.t_first <= r.t_done
        assert win[0].start_ns <= r.t_admit <= win[-1].end_ns


def test_stamps_are_written_with_spans_off_and_survive_preemption():
    """A priority-3 request preempts one of two running lanes; the victim
    keeps the admission and first-token stamps of its first admission."""
    cfg, me = _deployment("deepseek-7b", n_engines=1, quantum=2,
                          preemption=True)
    a, b, c = _requests(cfg.vocab_size, (9, 11, 7))
    c.priority = 3
    me.submit([a, b], max_new_tokens=10)
    step_us: list = []
    me.step_window(step_times_us=step_us)
    first = {r.rid: (r.t_admit, r.t_first) for r in (a, b)}
    assert all(t is not None for ts in first.values() for t in ts)
    me.submit([c], max_new_tokens=10)
    while me.has_work:
        me.step_window(step_times_us=step_us)
    victims = [r for r in (a, b) if r.preemptions]
    assert victims
    for r in (a, b, c):
        assert r.state == "finished"
        assert r.t_submit <= r.t_admit <= r.t_first <= r.t_done
    for r in victims:
        assert (r.t_admit, r.t_first) == first[r.rid]
    assert len(step_us) == me.stats.decode_steps
    assert tracing.drain() == []                 # the recorder stayed off


def test_launcher_prints_the_span_table(capsys):
    launch_serve.main(["--arch", "deepseek-7b", "--device", "cpu",
                       "--requests", "3", "--max-new-tokens", "4",
                       "--lanes", "2", "--engines", "2", "--spans"])
    out = capsys.readouterr().out
    table = out[out.index("spans:"):].splitlines()[1:]
    assert table[0].split() == ["span", "count", "total", "ms", "self", "ms"]
    rows = {line.split()[0]: line.split()[1:] for line in table[1:]}
    assert {"window", "window.admission", "decode.step", "decode.forward",
            "decode.alloc", "decode.readback", "window.commit",
            "admit.prefill", "admit.readback"} <= set(rows)
    # the allocator's commits get a row per caller (the span's kind)
    assert {n for n in rows if n.startswith("alloc.commit")} == {
        "alloc.commit[admission]", "alloc.commit[decode]",
        "alloc.commit[window]"}
    totals = [float(v[1]) for v in rows.values()]
    assert totals == sorted(totals, reverse=True)
    for count, total, self_ms in rows.values():
        assert int(count) > 0 and float(total) >= float(self_ms) >= 0
    assert not tracing.RECORDER.on and tracing.drain() == []
