"""The port's allocator-op trace (``repro_torch.loadgen.trace``) against
the JAX package's, on the CPU, with no model.

* The recorder sees every commit, retag and refcount bump of an
  ``AllocService`` in mutation order, one host copy of each queue, and
  changes no token and no state; a compaction pass rides the trace as
  retags and bumps under buddy, and ``certify_complete`` refuses a trace
  of a run compacted under the free list, whose stack rebuild no event
  carries.  A what-if replay of a trace that names block ids is refused;
  without those ops (``drop_block_ids``) it matches the JAX package's.
* A trace written by each package replays in both under all three
  policies: the two writers' files are byte-identical, the replays give
  equal per-tenant counters and a bit-identical final state.  The stream
  has no block-naming op (single frees, retags, bumps), so its packets
  mean the same pages under every policy in both packages; traces with
  such ops are crossed under their recorded policy in
  ``tests/test_torch_loadgen.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.loadgen import trace as jtrace  # noqa: E402
from repro_torch.alloc import ALLOC_POLICIES, AllocService  # noqa: E402
from repro_torch.core.freelist import FreeListState  # noqa: E402
from repro_torch.core.packets import (FREE_ALL, OP_FREE, OP_MALLOC,  # noqa: E402
                                      OP_MALLOC_RUN, OP_NOP, OP_REFILL)
from repro_torch.loadgen import (AllocTrace, load_trace,  # noqa: E402
                                 record_service, replay_trace, save_trace)


def stream_trace(header_policy="buddy", n=24, seed=0):
    """A trace of random bursts with no block-naming op (mallocs, refills,
    runs and FREE_ALLs on four tenants, window marks between), as numpy
    events: its packets mean the same pages under every policy."""
    rng = np.random.RandomState(seed)
    events = []
    for b in range(n):
        q = int(rng.choice([6, 10]))
        ops = rng.choice([OP_MALLOC, OP_REFILL, OP_MALLOC_RUN, OP_FREE,
                          OP_NOP], q)
        r = int(rng.choice([1, 4]))
        args = np.where(ops == OP_FREE, FREE_ALL, rng.randint(0, r + 2, q))
        events.append(("burst", r, *[np.asarray(x, np.int32) for x in (
            ops, rng.randint(0, 3, q), rng.randint(0, 4, q), args)]))
        if b % 4 == 3:
            events.append(("window",))
    header = {"version": 1, "policy": header_policy, "backend": "jnp",
              "tenants": [["e0/kv_pages", 24], ["e0/scratch", 2],
                          ["e1/kv_pages", 24], ["e1/scratch", 2]],
              "traced_commits": 0, "complete": True}
    return jtrace.AllocTrace(header=header, events=events)


@pytest.mark.parametrize("policy", ALLOC_POLICIES)
def test_replays_cross_both_ways_under_every_policy(tmp_path, policy):
    """A trace written by each package, replayed by both under ``policy``:
    the two writers' files are byte-identical, and the replays give equal
    per-tenant counters and a bit-identical final state."""
    trace = stream_trace()
    save_trace(trace, tmp_path / "port.trc")
    jtrace.save_trace(trace, tmp_path / "jax.trc")
    assert (tmp_path / "port.trc").read_bytes() == \
        (tmp_path / "jax.trc").read_bytes()
    for name in ("port.trc", "jax.trc"):
        want = jtrace.replay_trace(jtrace.load_trace(tmp_path / name),
                                   policy=policy)
        got = replay_trace(load_trace(tmp_path / name), policy=policy,
                           device="cpu")
        assert got.report == want.report, (name, policy)
        for field in FreeListState._fields:
            np.testing.assert_array_equal(
                getattr(got.state, field).numpy(),
                np.asarray(getattr(want.state, field)),
                err_msg=f"{name} under {policy}: {field}")
        assert (got.bursts, got.live_bursts, got.windows, got.ops) == \
            (want.bursts, want.live_bursts, want.windows, want.ops)
        assert got.report["e0/kv_pages"]["alloc_count"] > 0


def test_recorder_keeps_every_op_in_mutation_order(tmp_path):
    svc = AllocService(policy="buddy", device="cpu")
    kv = svc.register_tenant("kv_pages", 16)
    svc.register_tenant("scratch", 2)
    rec = record_service(svc)
    state = svc.init_state()
    b = svc.new_burst()
    b.malloc_run(kv, [0, 1], n=3)
    state, res = svc.commit(state, b, max_blocks_per_req=3)
    pages = res.blocks[0]
    state = svc.retag_blocks(state, kv, pages[:1], 1 << 30)
    state = svc.bump_refcounts(state, kv, pages[1:], 2)
    rec.mark_window()
    state, resp, stats = svc.step(state, b.build_queue(),
                                  max_blocks_per_req=3)
    assert resp.status.tolist() == [1, 1] and int(stats.core.mallocs) == 2
    svc.recorder = None
    svc.commit(state, b, max_blocks_per_req=3)       # not recorded
    trace = rec.finish()
    assert [ev[0] for ev in trace.events] == \
        ["burst", "retag", "bump", "window", "burst"]
    _, r, op, lane, cls, arg = trace.events[0]
    assert r == 3 and op.tolist() == [OP_MALLOC_RUN] * 2
    assert lane.tolist() == [0, 1] and arg.tolist() == [3, 3]
    assert trace.events[1][1:] == (0, trace.events[1][2], 1 << 30)
    assert trace.events[1][2].tolist() == pages[:1].tolist()
    assert trace.events[2][2].tolist() == pages[1:].tolist()
    assert trace.events[2][3] == 2
    assert trace.header == {
        "version": 1, "policy": "buddy", "backend": "jnp",
        "tenants": [["kv_pages", 16], ["scratch", 2]],
        "traced_commits": 0, "complete": None}
    assert (trace.bursts, trace.live_bursts, trace.windows, trace.ops) == \
        (2, 2, 1, 4)
    save_trace(trace, tmp_path / "t.trc")
    again = jtrace.load_trace(tmp_path / "t.trc")
    assert again.header == trace.header
    for x, y in zip(again.events, trace.events):
        assert x[0] == y[0] and all(np.array_equal(a, b)
                                    for a, b in zip(x[1:], y[1:]))
    res = replay_trace(load_trace(tmp_path / "t.trc"), device="cpu")
    want = jtrace.replay_trace(again)
    assert res.report == want.report
    for field in FreeListState._fields:
        np.testing.assert_array_equal(getattr(res.state, field).numpy(),
                                      np.asarray(getattr(want.state, field)))


def test_load_rejects_foreign_and_other_versions(tmp_path):
    (tmp_path / "x").write_bytes(b"not a trace")
    with pytest.raises(ValueError, match="not a repro allocator tracefile"):
        load_trace(tmp_path / "x")
    (tmp_path / "v").write_bytes(jtrace.TRACE_MAGIC + bytes([2, 0, 0, 0, 0]))
    with pytest.raises(ValueError, match="version 2"):
        load_trace(tmp_path / "v")


def compacting_run(record: bool, policy: str = "buddy"):
    """A port-only open-loop run (smoke deepseek-7b, 2 shards of 2 lanes,
    ``policy``, alias-mode prefix caches, preemption on) with every shard
    compacted after every second window; ``(engine, report, moves,
    recorder)``."""
    from repro_torch.configs import smoke_config
    from repro_torch.loadgen import LoadgenSpec, build_workload, run_open_loop
    from repro_torch.models import init_params, make_paged_config
    from repro_torch.serve.multi_engine import MultiEngine
    from repro_torch.serve.scheduler import make_scheduler_config
    cfg = smoke_config("deepseek-7b")
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    kvcfg = make_paged_config(cfg, seq_len=64, lanes=2, page_size=4,
                              dtype=torch.float32)
    me = MultiEngine(cfg, kvcfg, params, n_engines=2,
                     sched_cfg=make_scheduler_config(cfg, kvcfg,
                                                     max_prompt_len=32),
                     quantum=2, preemption=True, prefix_cache=True,
                     prefix_alias="alias", alloc_policy=policy,
                     device="cpu")
    moves = []
    inner = me.step_window

    def window():
        progressed = inner(validate=True)
        if me.stats.windows % 2 == 0:
            moves.append(sum(me.compact()))
            me.validate()
        return progressed

    me.step_window = window
    rec = record_service(me.service) if record else None
    spec = LoadgenSpec(n_requests=12, rate=0.5, prompt_min=8, prompt_cap=24,
                       output_cap=8, shared_prefix_frac=0.5,
                       shared_prefix_tokens=8, priority_frac=0.25, seed=3)
    rep = run_open_loop(me, build_workload(spec, cfg.vocab_size))
    me.service.recorder = None
    return me, rep, moves, rec


@pytest.fixture(scope="module")
def compacted_run(tmp_path_factory):
    """:func:`compacting_run`, recorded and saved."""
    from repro_torch.loadgen import certify_complete
    me, rep, moves, rec = compacting_run(record=True)
    trace = certify_complete(rec.finish(), me.engines,
                             me.stats.window_bursts)
    path = tmp_path_factory.mktemp("compacted") / "run.trc"
    save_trace(trace, path)
    return me, rep, moves, trace, path


def test_recording_changes_no_token_and_no_state(compacted_run):
    me, rep, moves, _, _ = compacted_run
    off, rep_off, moves_off, _ = compacting_run(record=False)
    assert {r.rid: r.output for r in off.finished} == \
        {r.rid: r.output for r in me.finished}
    assert moves_off == moves
    assert (rep_off.windows, rep_off.decode_steps, rep_off.p50_ttft_steps) \
        == (rep.windows, rep.decode_steps, rep.p50_ttft_steps)
    for field in FreeListState._fields:
        assert torch.equal(getattr(off.alloc, field),
                           getattr(me.alloc, field)), field


def test_compaction_rides_the_trace(compacted_run):
    """The pass's owner and refcount changes are recorded as retags and
    bumps: the recorded policy's replay, in both packages, ends with the
    live run's counters, owner and refcount rows."""
    me, rep, moves, trace, path = compacted_run
    assert rep.completed == 12 and not rep.stranded and sum(moves) > 0
    assert any(ev[0] == "retag" and ev[3] == -1 for ev in trace.events)
    live = me.service.tenant_report(me.alloc)
    res = replay_trace(load_trace(path), device="cpu")
    want = jtrace.replay_trace(jtrace.load_trace(path))
    assert res.report == live == want.report
    for field in ("owner", "refcount", "free_top", "used", "alloc_count",
                  "free_count", "fail_count", "split_count", "merge_count"):
        assert torch.equal(getattr(res.state, field),
                           getattr(me.alloc, field)), field
        np.testing.assert_array_equal(getattr(res.state, field).numpy(),
                                      np.asarray(getattr(want.state, field)))


@pytest.mark.parametrize("policy", ["freelist", "bitmap"])
def test_what_if_replay_follows_compaction(compacted_run, policy):
    """The compacted buddy run under another policy: its retags and bumps
    name buddy's ids, so the port refuses the what-if; without them
    (``drop_block_ids``) the two packages replay to one valid state."""
    from repro_torch.core.freelist import validate_freelist
    _, _, _, trace, path = compacted_run
    with pytest.raises(ValueError, match="names block ids"):
        replay_trace(load_trace(path), policy=policy, device="cpu")
    neutral = load_trace(path).drop_block_ids()
    assert neutral.header == dict(trace.header, complete=None)
    assert not any(ev[0] in ("retag", "bump") for ev in neutral.events)
    got = replay_trace(neutral, policy=policy, device="cpu")
    want = jtrace.replay_trace(neutral, policy=policy)
    assert got.report == want.report
    for field in FreeListState._fields:
        np.testing.assert_array_equal(getattr(got.state, field).numpy(),
                                      np.asarray(getattr(want.state, field)),
                                      err_msg=f"{policy}: {field}")
    validate_freelist(got.state)


def test_certify_refuses_compaction_under_the_free_list():
    """Under the free list a compaction pass's stack rebuild is in no
    event: the recorded replay ends with the live run's owner rows but
    another stack, one that fails I2.  ``certify_complete`` refuses the
    trace; an uncompacting free-list run certifies."""
    from repro_torch.core.freelist import validate_freelist
    from repro_torch.loadgen import certify_complete
    me, rep, moves, rec = compacting_run(record=True, policy="freelist")
    assert rep.completed == 12 and sum(moves) > 0
    trace = rec.finish()
    with pytest.raises(ValueError, match="compaction moved"):
        certify_complete(trace, me.engines, me.stats.window_bursts)
    res = replay_trace(trace, device="cpu")
    assert torch.equal(res.state.owner, me.alloc.owner)
    assert not torch.equal(res.state.free_stack, me.alloc.free_stack)
    with pytest.raises(AssertionError, match="I2"):
        validate_freelist(res.state)
    for e in me.engines:
        e.stats.compaction_moves = 0      # as if no pass had moved a page
    assert certify_complete(trace, me.engines, me.stats.window_bursts) \
        .header["complete"] is True


def test_drop_block_ids_keeps_what_every_policy_reads_alike(tmp_path):
    """``drop_block_ids`` turns single frees into NOPs and leaves retags
    and bumps out; bursts, windows and every other packet stay, and the
    result replays alike in both packages under all three policies."""
    trace = stream_trace(n=16, seed=5)
    assert not AllocTrace(trace.header, trace.events).names_block_ids
    rng = np.random.RandomState(6)
    events = []
    for ev in trace.events:
        if ev[0] == "burst":
            _, r, op, lane, cls, arg = ev
            single = rng.rand(op.shape[0]) < 0.3
            op = np.where(single, OP_FREE, op).astype(np.int32)
            arg = np.where(single, rng.randint(0, 24, op.shape[0]),
                           arg).astype(np.int32)
            ev = ("burst", r, op, lane, cls, arg)
        events.append(ev)
    events.insert(3, ("retag", 0, np.arange(2, dtype=np.int32), 1 << 30))
    events.insert(5, ("bump", 2, np.arange(3, dtype=np.int32), 1))
    named = AllocTrace(header=trace.header, events=events)
    assert named.names_block_ids
    save_trace(named, tmp_path / "named.trc")
    neutral = load_trace(tmp_path / "named.trc").drop_block_ids()
    assert not neutral.names_block_ids
    assert (neutral.bursts, neutral.windows) == (named.bursts, named.windows)
    n_single = sum(int(np.sum((ev[2] == OP_FREE) & (ev[5] >= 0)))
                   for ev in events if ev[0] == "burst")
    assert n_single > 0 and neutral.ops == named.ops - n_single
    kept = [ev for ev in events if ev[0] != "retag" and ev[0] != "bump"]
    for a, b in zip(neutral.events, kept):
        if a[0] == "burst":
            single = (b[2] == OP_FREE) & (b[5] >= 0)
            for x, y in zip(a[2:], b[2:]):
                np.testing.assert_array_equal(x, np.where(single, 0, y))
    for policy in ALLOC_POLICIES:
        got = replay_trace(neutral, policy=policy, device="cpu")
        want = jtrace.replay_trace(neutral, policy=policy)
        assert got.report == want.report, policy
        for field in FreeListState._fields:
            np.testing.assert_array_equal(
                getattr(got.state, field).numpy(),
                np.asarray(getattr(want.state, field)),
                err_msg=f"{policy}: {field}")
