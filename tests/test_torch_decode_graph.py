"""The decode step replayed as a graph (``repro_torch.serve.decode_graph``).

On the CPU a stand-in graph takes the CUDA graph's place: its capture
runs the step once and keeps the outputs, its replay runs the step again
into them with the launch counters held (a replay runs no Python).  An
engine forced onto it serves step for step as an eager engine does (the
whole state and the tokens equal bit for bit, through admissions,
completions and window commits), copies in only the state leaves that
were replaced and never a K/V pool, counts each kernel's recorded
launches once a replay, and keeps its deferred refills past the next
step.  Where the graph engages is a rule on what the engine can observe.

On the card (``cuda``) a real graph is held to an eager engine at smoke
size, dense and moe, over 64 steps and more.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import init_params, make_paged_config  # noqa: E402
from repro_torch.serve import decode_graph as dg  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402
from repro_torch.serve.multi_engine import MultiEngine  # noqa: E402
from repro_torch.serve.scheduler import Request, make_scheduler_config  # noqa: E402
from repro_torch.tracing import COUNTERS  # noqa: E402

ARCHS = ("deepseek-7b", "mixtral-8x7b")
#: mellum2 at one period of its layers (three windowed, one global), a
#: window of 8 tokens that the requests outgrow: a split cache that
#: recycles, and grouped expert products (on the card in bf16: 256
#: experts top-8 at 4 lanes are a buffer of 2048 rows, past
#: ``moe.GROUPED_MIN_ROWS``; 8 experts top-2 on the CPU)
MELLUM2 = "mellum2-12b-a2.5b"


def _config(arch, device="cpu"):
    cfg = smoke_config(arch)
    if arch == MELLUM2:
        E, K = (8, 2) if device == "cpu" else (256, 8)
        cfg = dataclasses.replace(cfg, num_layers=4, window=8, num_experts=E,
                                  experts_per_token=K,
                                  moe_capacity_factor=E / K, d_ff=64)
    return cfg


class StandInGraph:
    """A CUDA graph's stand-in on the CPU: ``capture`` runs the step and
    keeps its outputs, ``replay`` runs it again and writes the new
    outputs into the kept ones, with the launch counters and the host
    counts of ``tracing.COUNTERS`` as they were (a replay runs no
    Python)."""

    def warm(self, fn):
        fn()

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        counts, host = dg._counts(), dict(COUNTERS.host)
        for dst, src in zip(dg._leaves(self.out), dg._leaves(self.fn())):
            if dst is not None:
                dst.copy_(src)
        dg._set_counts(counts)
        COUNTERS.host.clear()
        COUNTERS.host.update(host)


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(dg, "CudaGraph", StandInGraph)


def _force_graph(eng, on: bool = True):
    eng._graph_engages = lambda: on


def _deployment(arch, device="cpu", lanes=2, quantum=2,
                dtype=torch.float32):
    cfg = _config(arch, device)
    params = init_params(cfg, seed=0, dtype=dtype, device=device)
    kvcfg = make_paged_config(cfg, seq_len=64, lanes=lanes, page_size=4,
                              dtype=dtype)
    scfg = make_scheduler_config(cfg, kvcfg, max_prompt_len=32)
    return MultiEngine(cfg, kvcfg, params, n_engines=1, sched_cfg=scfg,
                       quantum=quantum, preemption=False, device=device)


def _requests(vocab, n, seed=5):
    rng = np.random.RandomState(seed)
    return [Request(rid=i, tokens=rng.randint(0, vocab, 5 + i % 7
                                              ).astype(np.int32),
                    max_new_tokens=4 + (3 * i) % 9)
            for i in range(n)]


def _record_steps(eng, into: list):
    """After every step: the state's leaves (copied; the pools without
    their sink page, which every inactive lane and the capture write),
    the tokens it returned, and each step kernel's launches in the
    step."""
    inner = eng.step

    def step():
        c0 = dg._counts()
        toks = inner()
        launched = [b - a for a, b in zip(c0, dg._counts())]
        pools = dg._pools(eng.state)
        into.append(([None if t is None else
                      t[:-1].clone() if any(t is p for p in pools)
                      else t.clone() for t in dg._leaves(eng.state)],
                     toks.copy(), launched))
        return toks
    eng.step = step


def _serve_pair(arch, device, lanes, n_requests, quantum=2,
                dtype=torch.float32):
    """The same requests through a graph engine and an eager one: each
    step's record from both, and the two engines."""
    out = []
    for graph in (True, False):
        me = _deployment(arch, device, lanes=lanes, quantum=quantum,
                         dtype=dtype)
        eng = me.engines[0]
        _force_graph(eng, graph)
        steps: list = []
        _record_steps(eng, steps)
        me.serve(_requests(me.cfg.vocab_size, n_requests),
                 max_new_tokens=None)
        out.append((steps, eng, me))
    return out


def _assert_same_steps(graph_steps, eager_steps):
    assert len(graph_steps) == len(eager_steps)
    for k, ((ga, gt, gl), (ea, et, el)) in enumerate(
            zip(graph_steps, eager_steps)):
        np.testing.assert_array_equal(gt, et, err_msg=f"tokens, step {k}")
        assert gl == el, f"launches in step {k}: {gl} != {el}"
        for i, (a, b) in enumerate(zip(ga, ea)):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b), f"state leaf {i}, step {k}"


# ---------------------------------------------------------------- CPU

@pytest.mark.parametrize("arch", ARCHS + (MELLUM2,))
def test_stand_in_graph_serves_as_eager_step_for_step(stand_in, arch):
    (g_steps, g_eng, g_me), (e_steps, e_eng, e_me) = _serve_pair(
        arch, "cpu", lanes=2, n_requests=7)
    _assert_same_steps(g_steps, e_steps)
    assert {r.rid: r.output for r in g_me.finished} == \
        {r.rid: r.output for r in e_me.finished}
    s = g_eng.stats
    assert s.decode_graph_captures == 1
    assert s.decode_graph_replays == s.decode_steps == len(g_steps) >= 20
    # admissions, completions and window commits replace leaves between
    # steps; the eager engine never captures
    assert s.decode_graph_copies > 0
    assert e_eng._graph is None and e_eng.stats.decode_graph_replays == 0


STASH = dict(stash_size=4, stash_watermark=1, stash_refill=2)


def _engine(arch="deepseek-7b", defer_refill=False, **kv):
    cfg = smoke_config(arch)
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    kvcfg = make_paged_config(cfg, seq_len=64, lanes=2, page_size=4,
                              dtype=torch.float32, **kv)
    return ServingEngine(cfg, kvcfg, params, device="cpu",
                         defer_refill=defer_refill)


def test_copy_in_touches_replaced_leaves_and_never_the_pools(stand_in):
    eng = _engine()
    _force_graph(eng)
    rng = np.random.RandomState(1)
    assert eng.admit(0, rng.randint(0, 100, 6).astype(np.int32))
    eng.step()                           # capture, then the first replay
    own = [t for t in dg._leaves(eng._graph.static) if t is not None]
    shared = (eng.state.paged.k_pages, eng.state.paged.v_pages)
    assert eng.stats.decode_graph_copies == len(own) - len(shared)
    assert eng.state is eng._graph.static
    eng.step()                           # nothing replaced: nothing copied
    assert eng.stats.decode_graph_copies == len(own) - len(shared)
    eng.state = eng.state._replace(tokens=eng.state.tokens.clone())
    eng.step()
    assert eng.stats.decode_graph_copies == len(own) - len(shared) + 1
    assert eng.admit(1, rng.randint(0, 100, 9).astype(np.int32))
    before = eng.stats.decode_graph_copies
    eng.step()                           # the admission burst's new leaves
    assert eng.stats.decode_graph_copies > before + 1
    pools = eng.state.paged.k_pages
    eng.state = eng.state._replace(paged=eng.state.paged._replace(
        k_pages=pools.clone()))
    with pytest.raises(RuntimeError, match="K/V pool"):
        eng.step()


def test_replay_counts_recorded_launches_once(stand_in):
    """A step that counts (2, 3, 1) launches: the warm-up and capture
    undo theirs, each replay adds the recorded ones."""
    def counting(inner):
        def dec(params, state):
            for k, n in zip(dg.STEP_KERNELS, (2, 3, 1)):
                k.launches += n
            return inner(params, state)
        return dec

    got = []
    saved = dg._counts()
    try:
        for graph in (True, False):
            eng = _engine()
            _force_graph(eng, graph)
            eng._decode = counting(eng._decode)
            assert eng.admit(0, np.arange(3, 9, dtype=np.int32))
            c0 = dg._counts()
            for _ in range(3):
                eng.step()
            got.append([b - a for a, b in zip(c0, dg._counts())])
    finally:
        dg._set_counts(saved)        # the process-wide counters, as found
    assert got[0] == got[1] == [6, 9, 3]


def test_deferred_refills_survive_the_next_step(stand_in):
    """Each step's ``PendingDecodeOps`` keep their values after later
    replays overwrite the graph's outputs: the lanes' stashes run dry,
    lane 1 is released, and each step still reads as the eager one's."""
    got = []
    for graph in (True, False):
        eng = _engine(defer_refill=True, **STASH)
        _force_graph(eng, graph)
        rng = np.random.RandomState(2)
        assert eng.admit(0, rng.randint(0, 100, 7).astype(np.int32))
        assert eng.admit(1, rng.randint(0, 100, 4).astype(np.int32))
        for k in range(9):
            if k == 6:
                eng.release([1])
            eng.step()
        got.append(eng.pending_ops)
    graph_ops, eager_ops = got
    assert len(graph_ops) == len(eager_ops) == 9
    for g, e in zip(graph_ops, eager_ops):
        for a, b in zip(g, e):
            # ``window`` is a split cache's: None on one pool
            assert (a is None and b is None) or torch.equal(a, b)
    assert len({tuple(p.below.tolist()) for p in eager_ops}) == 4


def test_graph_engages_only_on_a_plain_card():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert dg.graph_engages(cuda, None, None)
    assert not dg.graph_engages(cpu, None, None)
    assert not dg.graph_engages(torch.device("meta"), None, None)
    assert not dg.graph_engages(cuda, object(), None)
    assert not dg.graph_engages(cuda, None, object())


def test_cpu_engine_steps_eagerly():
    eng = _engine()
    assert not eng._graph_engages()
    assert eng.admit(0, np.arange(2, 8, dtype=np.int32))
    eng.step()
    assert eng._graph is None
    s = eng.stats
    assert (s.decode_graph_captures, s.decode_graph_replays,
            s.decode_graph_copies) == (0, 0, 0)


def test_recorder_keeps_the_step_eager(stand_in):
    """A recorder set after the capture sends the next steps down the
    eager path, and a replay after it copies their state in."""
    eng = _engine()
    recorder = types.SimpleNamespace(on_commit=lambda *a: None)
    assert eng.admit(0, np.arange(2, 8, dtype=np.int32))
    eng._graph_engages = lambda: eng.service.recorder is None
    eng.step()
    eng.service.recorder = recorder
    eng.step()
    assert eng.stats.decode_graph_replays == 1
    assert eng.state is not eng._graph.static
    eng.service.recorder = None
    eng.step()
    assert eng.stats.decode_graph_replays == 2
    assert eng.state is eng._graph.static


# ---------------------------------------------------------------- card

@pytest.mark.cuda
@pytest.mark.parametrize("arch,dtype", [
    *((a, torch.float32) for a in ARCHS), (MELLUM2, torch.bfloat16)])
def test_graph_equals_eager_on_card(arch, dtype):
    """The CUDA graph against the eager step on the card, one engine each,
    at least 64 steps with admissions, completions and window commits
    between them: state and tokens bit for bit and each kernel's launches
    step by step (mellum2 in bf16, so that its experts take the grouped
    products, and its split cache recycles)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    (g_steps, g_eng, g_me), (e_steps, e_eng, _) = _serve_pair(
        arch, "cuda", lanes=4, n_requests=48, dtype=dtype)
    _assert_same_steps(g_steps, e_steps)
    s = g_eng.stats
    assert len(g_steps) >= 64
    assert s.decode_graph_captures == 1
    assert s.decode_graph_replays == s.decode_steps >= 63
    assert e_eng._graph is None
    assert sum(sum(launched) for _, _, launched in g_steps) > 0
