"""Two shards of the moe family in the port against the JAX package's
``MultiEngine``, on the CPU: smoke mixtral-8x7b (sliding window of 64)
and phi3.5-moe (full attention) in f32 with the JAX parameters carried
across.

Two shards of 2 lanes, burst windows of 4 steps, the stash off: the
recycled pages of every step ride the window's merged commit as single
frees (a page of a lane released in that window beside its FREE_ALL);
window by window the shared state equals the JAX ``MultiEngine``'s, and
the windowless arch stages no flush.  The port's run, recorded, replays
in both packages to the live counters.  Prompt lengths repeat (the moe
family's exact-length buckets compile one JAX prefill a length).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.loadgen import trace as jtrace  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_paged_config as j_make_paged_config  # noqa: E402
from repro.serve.multi_engine import MultiEngine as JMultiEngine  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.freelist import FreeListState  # noqa: E402
from repro_torch.loadgen import (certify_complete, load_trace,  # noqa: E402
                                 record_service, replay_trace, save_trace)
from repro_torch.models import make_paged_config, params_from_numpy  # noqa: E402
from repro_torch.serve.multi_engine import MultiEngine  # noqa: E402
from repro_torch.serve.scheduler import Request, make_scheduler_config  # noqa: E402


def _alloc_diff(t_alloc, j_alloc) -> list[str]:
    return [f for f in FreeListState._fields
            if not np.array_equal(getattr(t_alloc, f).numpy(),
                                  np.asarray(getattr(j_alloc, f)))]


def _requests(cls, vocab):
    rng = np.random.RandomState(2)
    lens = (70, 90, 70, 90, 70, 90)
    return [cls(rid=i, tokens=rng.randint(0, vocab, n).astype(np.int32))
            for i, n in enumerate(lens)]


@pytest.fixture(scope="module",
                params=["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"])
def two_shards(request, tmp_path_factory):
    """Two shards of 2 lanes, windows of 4 steps, stash off, 6 requests
    of 70-90 tokens and 14 new: both packages window by window, the port
    recorded."""
    jcfg, cfg = j_smoke_config(request.param), smoke_config(request.param)
    jparams = j_init_params(jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    kw = dict(seq_len=128, lanes=2, page_size=8, stash_size=0)
    jkv = j_make_paged_config(jcfg, dtype=jnp.float32, **kw)
    tkv = make_paged_config(cfg, dtype=torch.float32, **kw)
    scfg = make_scheduler_config(cfg, tkv, max_prompt_len=96)
    assert scfg.exact_buckets
    me = MultiEngine(cfg, tkv, tparams, n_engines=2, sched_cfg=scfg,
                     quantum=4, device="cpu")
    jme = JMultiEngine(jcfg, jkv, jparams, n_engines=2, dtype=jnp.float32,
                       sched_cfg=scfg, quantum=4, alloc_backend="jnp",
                       alloc_policy="freelist")
    rec = record_service(me.service)
    flushed = []                   # per window: pages pending as flushes
    inner = me._flush_window

    def flush(released, evicted):
        flushed.append(sum(int(p.flush_mask.sum()) for e in me.engines
                           for p in e.pending_ops))
        return inner(released, evicted)
    me._flush_window = flush
    me.submit(_requests(Request, cfg.vocab_size), max_new_tokens=14)
    jme.submit(_requests(JRequest, cfg.vocab_size), max_new_tokens=14)
    windows = []
    while me.has_work or jme.has_work:
        progress = (me.step_window(validate=True), jme.step_window())
        windows.append((progress, _alloc_diff(me.alloc, jme.alloc)))
        assert len(windows) < 40
    me.service.recorder = None
    trace = certify_complete(rec.finish(), me.engines,
                             me.stats.window_bursts)
    path = tmp_path_factory.mktemp("swa") / "run.trc"
    save_trace(trace, path)
    return cfg, me, jme, windows, flushed, path


def test_two_shards_match_jax_window_by_window(two_shards):
    cfg, me, jme, windows, flushed, _ = two_shards
    for i, (progress, diff) in enumerate(windows):
        assert progress == (True, True), i
        assert not diff, f"window {i}: {diff}"
    out = {r.rid: list(r.output) for r in me.finished}
    assert out == {r.rid: list(r.output) for r in jme.finished}
    assert sorted(out) == list(range(6))
    assert all(len(o) == 14 for o in out.values())
    for f in ("windows", "window_commits", "window_slots_live",
              "window_slots_capacity", "decode_steps"):
        assert getattr(me.stats, f) == getattr(jme.stats, f), f
    roll = me.tenant_rollup()
    assert roll == jme.tenant_rollup()
    for d in roll.values():
        assert d["used"] == 0 and d["alloc_count"] == d["free_count"]
    # the windowed arch flushes its recycled pages on the window commits;
    # the full-attention one stages none
    assert (sum(flushed) > 0) == (cfg.window is not None)


def test_windowed_trace_replays_to_the_live_counters(two_shards):
    """The recorded run (its flushes are single frees naming block ids)
    replays under its own policy, in both packages, to the live run's
    per-tenant counters and owner and refcount rows."""
    _, me, _, _, _, path = two_shards
    live = me.service.tenant_report(me.alloc)
    got = replay_trace(load_trace(path), device="cpu")
    want = jtrace.replay_trace(jtrace.load_trace(path))
    assert got.report == live == want.report
    for f in ("owner", "refcount", "free_top", "used", "alloc_count",
              "free_count", "fail_count"):
        assert torch.equal(getattr(got.state, f), getattr(me.alloc, f)), f
        np.testing.assert_array_equal(getattr(got.state, f).numpy(),
                                      np.asarray(getattr(want.state, f)))
