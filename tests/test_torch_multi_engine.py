"""The port's multi-engine deployment (``repro_torch.serve.multi_engine``)
on the CPU, against the JAX package's ``MultiEngine`` (``alloc_backend=
"jnp"``) and against its own single engine.

Setup of the JAX package's multi-engine tests: smoke deepseek-7b in f32
with the JAX parameters carried across, 2 lanes per shard, 4-token pages,
seq 64.  Two shards of the port and of the JAX package step window by
window on the same requests: tokens must be equal and the one shared
``FreeListState`` bit-identical after every window, with the invariants
(I1–I6 over every shard's classes) checked after each.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_paged_config as j_make_paged_config  # noqa: E402
from repro.serve.multi_engine import MultiEngine as JMultiEngine  # noqa: E402
from repro.serve.router import Router as JRouter  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro_torch.alloc.service import AllocService  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.freelist import FreeListState  # noqa: E402
from repro_torch.launch.serve import serve_loop  # noqa: E402
from repro_torch.models import make_paged_config, params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402
from repro_torch.serve.multi_engine import MultiEngine  # noqa: E402
from repro_torch.serve.router import (ROUTER_POLICIES, Router,  # noqa: E402
                                      shard_load)
from repro_torch.serve.scheduler import (Request, Scheduler,  # noqa: E402
                                         SchedulerConfig, default_buckets,
                                         make_scheduler_config)

ARCH = "deepseek-7b"


@pytest.fixture(scope="module")
def dense():
    jcfg, cfg = j_smoke_config(ARCH), smoke_config(ARCH)
    jparams = j_init_params(jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    return jcfg, cfg, jparams, tparams


def _configs(jcfg, cfg, seq_len=64, max_prompt=32, **kw):
    jkv = j_make_paged_config(jcfg, seq_len=seq_len, lanes=2, page_size=4,
                              dtype=jnp.float32, **kw)
    tkv = make_paged_config(cfg, seq_len=seq_len, lanes=2, page_size=4,
                            dtype=torch.float32, **kw)
    assert (tkv.num_pages, tkv.max_pages_per_lane, tkv.scratch_slots,
            tkv.stash_size, tkv.stash_watermark, tkv.stash_refill) == \
        (jkv.num_pages, jkv.max_pages_per_lane, jkv.scratch_slots,
         jkv.stash_size, jkv.stash_watermark, jkv.stash_refill)
    return (jkv, tkv, make_scheduler_config(cfg, tkv,
                                            max_prompt_len=max_prompt))


def _prompts(vocab, n, seed=0, max_new=6):
    rng = np.random.RandomState(seed)
    return [(rid, rng.randint(0, vocab, size=8 + rid % 5).astype(np.int32),
             max_new) for rid in range(n)]


def _requests(prompts, cls=Request, priority=None):
    return [cls(rid=rid, tokens=toks.copy(), max_new_tokens=m,
                priority=0 if priority is None else priority[rid])
            for rid, toks, m in prompts]


def _outputs(requests):
    return {r.rid: list(r.output) for r in requests}


def _alloc_equal(t_alloc, j_alloc) -> list[str]:
    return [f for f in FreeListState._fields
            if not np.array_equal(getattr(t_alloc, f).numpy(),
                                  np.asarray(getattr(j_alloc, f)))]


# ---------------------------------------------------------------------------
# router (a copy of the JAX package's)
# ---------------------------------------------------------------------------

def test_router_policies_and_tie_break():
    rr = Router("round_robin")
    assert [rr.route([0, 0, 0]) for _ in range(5)] == [0, 1, 2, 0, 1]
    ll = Router("least_loaded")
    assert ll.route([3, 1, 2]) == 1
    for loads, want in (([2, 2, 2, 2], 0), ([5, 2, 2, 7], 1), ([4, 9, 4], 0),
                        ([7, 3, 3, 3, 9], 1)):
        assert ll.route(loads) == want       # lowest index among the least
    assert [ll.route([1, 1]) for _ in range(4)] == [0, 0, 0, 0]
    with pytest.raises(ValueError, match="unknown router"):
        Router("random")
    assert ROUTER_POLICIES == ("round_robin", "least_loaded")
    # the same random load vectors route the same way as the JAX router
    rng = np.random.RandomState(0)
    for policy in ROUTER_POLICIES:
        a, b = Router(policy), JRouter(policy)
        for _ in range(50):
            loads = rng.randint(0, 4, size=rng.randint(1, 6)).tolist()
            assert a.route(loads) == b.route(loads)
    scfg = SchedulerConfig(page_size=4, num_pages=16, max_lanes=2,
                           buckets=default_buckets(16))
    s = Scheduler(scfg)
    assert shard_load(s) == 0
    s.submit(Request(rid=0, tokens=np.zeros(4, np.int32)))
    assert shard_load(s) == 1


# ---------------------------------------------------------------------------
# N = 2 against the JAX package, window by window
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def n2_runs(dense):
    """Both deployments on 8 requests, 2 shards, quantum 3, preemption on,
    stepped in lockstep; records per-window differences."""
    jcfg, cfg, jparams, tparams = dense
    jkv, tkv, scfg = _configs(jcfg, cfg)
    jme = JMultiEngine(jcfg, jkv, jparams, n_engines=2, dtype=jnp.float32,
                       sched_cfg=scfg, quantum=3, alloc_backend="jnp",
                       alloc_policy="freelist")
    tme = MultiEngine(cfg, tkv, tparams, n_engines=2, sched_cfg=scfg,
                      quantum=3, device="cpu")
    prompts = _prompts(cfg.vocab_size, 8)
    jme.submit(_requests(prompts, JRequest))
    tme.submit(_requests(prompts))
    windows = []
    while jme.has_work or tme.has_work:
        jp = jme.step_window()
        tp = tme.step_window(validate=True)
        windows.append(dict(progress=(jp, tp),
                            alloc=_alloc_equal(tme.alloc, jme.alloc),
                            authoritative=all(
                                e.state.paged.alloc is tme.alloc
                                for e in tme.engines)))
        assert len(windows) < 40
    return jme, tme, windows


def test_n2_tokens_equal_jax(n2_runs):
    jme, tme, _ = n2_runs
    assert not tme.failed and len(tme.finished) == 8
    assert _outputs(tme.finished) == _outputs(jme.finished)
    assert all(len(r.output) == 6 for r in tme.finished)


def test_n2_shared_state_bit_identical_every_window(n2_runs):
    _, _, windows = n2_runs
    assert len(windows) > 2
    for i, w in enumerate(windows):
        assert w["progress"][0] == w["progress"][1], i
        assert not w["alloc"], f"window {i}: fields {w['alloc']} differ"


def test_n2_counters_equal_jax(n2_runs):
    jme, tme, _ = n2_runs
    for f in ("windows", "window_commits", "window_slots_live",
              "window_slots_capacity", "preemptions", "decode_steps"):
        assert getattr(tme.stats, f) == getattr(jme.stats, f), f
    for je, te in zip(jme.engines, tme.engines):
        for f in ("admitted", "completed", "decode_steps", "alloc_failures",
                  "hmq_admit_bursts", "hmq_release_bursts", "decode_bursts",
                  "stash_hits", "stash_misses", "stash_depth_hist",
                  "burst_slots_live", "burst_slots_capacity", "tenants"):
            assert getattr(te.stats, f) == getattr(je.stats, f), f
        assert te.tenant_report() == je.tenant_report()
    assert tme.tenant_rollup() == jme.tenant_rollup()
    assert tme.service.namespaces == jme.service.namespaces == ("e0", "e1")


def test_every_shard_holds_the_authoritative_state(n2_runs):
    """After every window (validate syncs each shard) every shard's state
    carries the deployment's one allocator state, and every window made
    one merged burst (launch) at most."""
    _, tme, windows = n2_runs
    assert all(w["authoritative"] for w in windows)
    assert 0 < tme.stats.window_commits <= tme.stats.window_bursts \
        <= tme.stats.windows
    assert 0 < tme.stats.cross_engine_burst_occupancy <= 1


# ---------------------------------------------------------------------------
# the port against its own single engine and itself
# ---------------------------------------------------------------------------

def test_n1_sharded_token_identical_to_single_engine(dense):
    _, cfg, _, tparams = dense
    kvcfg = make_paged_config(cfg, seq_len=64, lanes=2, page_size=4,
                              dtype=torch.float32)
    scfg = make_scheduler_config(cfg, kvcfg, max_prompt_len=32)
    prompts = _prompts(cfg.vocab_size, 5)
    eng = ServingEngine(cfg, kvcfg, tparams, sched_cfg=scfg, device="cpu")
    sched = Scheduler(scfg)
    serve_loop(eng, sched, _requests(prompts), 6, verbose=False)
    want = _outputs(sched.finished)
    assert len(want) == 5
    for quantum in (1, 4):
        me = MultiEngine(cfg, kvcfg, tparams, n_engines=1, sched_cfg=scfg,
                         quantum=quantum, device="cpu")
        me.serve(_requests(prompts), max_new_tokens=6, validate=True)
        assert _outputs(me.finished) == want, quantum


def test_decode_window_costs_at_most_one_merged_commit(dense, monkeypatch):
    _, cfg, _, tparams = dense
    kvcfg = make_paged_config(cfg, seq_len=64, lanes=2, page_size=4,
                              dtype=torch.float32)
    scfg = make_scheduler_config(cfg, kvcfg, max_prompt_len=32)
    me = MultiEngine(cfg, kvcfg, tparams, n_engines=2, sched_cfg=scfg,
                     quantum=4, preemption=False, device="cpu")
    me.submit(_requests(_prompts(cfg.vocab_size, 4, max_new=14)))
    me.step_window()                          # the admission window
    bursts0 = me.stats.window_bursts
    calls = {"n": 0}
    orig = AllocService.commit

    def counting(self, *a, **kw):
        calls["n"] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(AllocService, "commit", counting)
    steps = 0
    while me.has_work:
        before, steps_before = calls["n"], me.stats.decode_steps
        assert me.step_window()
        steps += me.stats.decode_steps - steps_before
        # one gated burst per engine-step plus at most one merged commit
        assert calls["n"] - before <= \
            me.stats.decode_steps - steps_before + 1
    assert calls["n"] == steps + me.stats.window_bursts - bursts0
    assert me.stats.window_commits >= 1


def test_preemption_resume_matches_uninterrupted_output(dense):
    _, cfg, _, tparams = dense
    kvcfg = make_paged_config(cfg, seq_len=64, lanes=2, page_size=4,
                              dtype=torch.float32)
    scfg = make_scheduler_config(cfg, kvcfg, max_prompt_len=32)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 11, 7)]
    solo = {}
    for rid, p in enumerate(prompts):
        me = MultiEngine(cfg, kvcfg, tparams, n_engines=1, sched_cfg=scfg,
                         quantum=2, preemption=False, device="cpu")
        me.serve([Request(rid=rid, tokens=p.copy())], max_new_tokens=10)
        solo[rid] = _outputs(me.finished)[rid]
    me = MultiEngine(cfg, kvcfg, tparams, n_engines=1, sched_cfg=scfg,
                     quantum=2, preemption=True, device="cpu")
    me.submit([Request(rid=0, tokens=prompts[0].copy()),
               Request(rid=1, tokens=prompts[1].copy())], max_new_tokens=10)
    me.step_window(validate=True)
    me.submit([Request(rid=2, tokens=prompts[2].copy(), priority=3)],
              max_new_tokens=10)
    while me.has_work:
        assert me.step_window(validate=True)
    assert me.stats.preemptions >= 1
    done = {r.rid: r for r in me.finished}
    assert sorted(done) == [0, 1, 2]
    assert any(r.preemptions for r in done.values())
    for rid, req in done.items():
        assert req.output == solo[rid], rid
    for d in me.tenant_rollup().values():
        assert d["used"] == 0 and d["alloc_count"] == d["free_count"]


def test_shard_running_dry_leaves_other_shard_untouched(dense):
    _, cfg, _, tparams = dense
    kvcfg = make_paged_config(cfg, seq_len=32, lanes=2, page_size=4,
                              dtype=torch.float32, stash_size=0)
    scfg = make_scheduler_config(cfg, kvcfg, max_prompt_len=16)
    me = MultiEngine(cfg, kvcfg, tparams, n_engines=2, sched_cfg=scfg,
                     quantum=2, preemption=False, device="cpu")
    rng = np.random.RandomState(2)
    for rid in range(6):                     # all onto shard 0
        me.scheds[0].submit(Request(
            rid=rid, tokens=rng.randint(0, cfg.vocab_size, 12)
            .astype(np.int32), max_new_tokens=8))
    while me.has_work:
        assert me.step_window(validate=True)
    assert all(d["alloc_count"] == 0 and d["peak_used"] == 0
               for d in me.engines[1].tenant_report().values())
    assert len(me.scheds[0].finished) == 6
    rep = me.engines[0].tenant_report()
    assert all(d["peak_used"] <= d["quota"] and d["used"] == 0
               for d in rep.values())
