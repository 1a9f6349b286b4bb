"""The port's open-loop load and allocator-op traces
(``repro_torch.loadgen``) against the JAX package, on the CPU.

* Arrival processes, length samplers and ``build_workload``: the same
  seeded draws as the JAX package's.
* ``run_open_loop`` on the port's ``MultiEngine`` and on JAX's (smoke
  deepseek-7b in f32 with the JAX parameters carried across; 2 shards of
  2 lanes, buddy policy, alias-mode prefix caches, preemption on; Poisson
  arrivals with shared prefixes and priorities): the same completed,
  failed and stranded counts, the same TTFT in steps, the same tokens and
  the same final shared allocator state.
* The run's traces cross both ways: each package's recorded tracefile
  loads in the other and replays there to equal per-tenant counters and a
  bit-identical final state; the port's replay under the recorded policy
  gives the live run's counters exactly.  The traces name block ids
  (single frees, retags, bumps): the JAX package's replay under another
  policy corrupts the free stack, the port's refuses, and without those
  ops (``drop_block_ids``) both replay to one valid state under every
  policy.  ``tests/test_torch_trace.py`` crosses traces under all three
  policies.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.alloc.policies import BuddyPolicy as JBuddyPolicy  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.loadgen import arrivals as jarr  # noqa: E402
from repro.loadgen import trace as jtrace  # noqa: E402
from repro.loadgen.driver import run_open_loop as j_run_open_loop  # noqa: E402
from repro.loadgen.workload import LoadgenSpec as JSpec  # noqa: E402
from repro.loadgen.workload import build_workload as j_build_workload  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_paged_config as j_make_paged_config  # noqa: E402
from repro.serve.multi_engine import MultiEngine as JMultiEngine  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.freelist import (FreeListState,  # noqa: E402
                                       validate_freelist)
from repro_torch.loadgen import (ARRIVAL_KINDS, LoadgenSpec,  # noqa: E402
                                 build_workload, certify_complete, load_trace,
                                 record_service, replay_trace, run_open_loop,
                                 save_trace)
from repro_torch.loadgen import arrivals  # noqa: E402
from repro_torch.models import make_paged_config, params_from_numpy  # noqa: E402
from repro_torch.serve.multi_engine import MultiEngine  # noqa: E402
from repro_torch.serve.scheduler import make_scheduler_config  # noqa: E402

ARCH = "deepseek-7b"
SPEC = dict(n_requests=6, arrival="poisson", rate=0.5, prompt_min=8,
            prompt_cap=16, output_cap=6, shared_prefix_frac=1.0,
            shared_prefix_tokens=8, priority_frac=0.25, seed=0)


# ---------------------------------------------------------------------------
# seeded draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123])
def test_arrivals_and_lengths_equal_jax_draws(seed):
    def both(fn, *args):
        a = getattr(arrivals, fn)(*args, np.random.RandomState(seed))
        b = getattr(jarr, fn)(*args, np.random.RandomState(seed))
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y, err_msg=fn)

    both("poisson_arrivals", 200, 0.3)
    both("bursty_arrivals", 200, 0.1, 0.9, 12.0)
    both("diurnal_arrivals", 200, 0.25, 0.8, 64.0)
    both("bounded_pareto_lengths", 300, 1.5, 2, 24)
    with pytest.raises(ValueError):
        arrivals.poisson_arrivals(3, 0.0, np.random.RandomState(0))


@pytest.mark.parametrize("kind", ARRIVAL_KINDS)
def test_build_workload_equals_jax(kind):
    kw = dict(SPEC, arrival=kind, n_requests=24)
    cfg = smoke_config(ARCH)
    got = build_workload(LoadgenSpec(**kw), cfg.vocab_size)
    want = j_build_workload(JSpec(**kw), cfg.vocab_size)
    assert len(got) == len(want) == 24
    for (t, r), (jt, jr) in zip(got, want):
        assert t == jt
        assert (r.rid, r.max_new_tokens, r.priority) == \
            (jr.rid, jr.max_new_tokens, jr.priority)
        np.testing.assert_array_equal(r.tokens, jr.tokens)
        assert r.tokens.dtype == np.int32
    with pytest.raises(ValueError, match="unknown arrival"):
        build_workload(LoadgenSpec(arrival="uniform"), 10)


# ---------------------------------------------------------------------------
# the open loop, live, against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def open_loop(tmp_path_factory):
    """Both deployments through ``run_open_loop`` on the same timed
    requests, each with a recorder on its service; the traces are saved
    to files."""
    jcfg, cfg = j_smoke_config(ARCH), smoke_config(ARCH)
    jparams = j_init_params(jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    jkv = j_make_paged_config(jcfg, seq_len=64, lanes=2, page_size=4,
                              dtype=jnp.float32)
    tkv = make_paged_config(cfg, seq_len=64, lanes=2, page_size=4,
                            dtype=torch.float32)
    scfg = make_scheduler_config(cfg, tkv, max_prompt_len=32)
    common = dict(n_engines=2, sched_cfg=scfg, quantum=2, preemption=True,
                  alloc_policy="buddy", prefix_cache=True,
                  prefix_alias="alias")
    jme = JMultiEngine(jcfg, jkv, jparams, dtype=jnp.float32,
                       alloc_backend="jnp", **common)
    tme = MultiEngine(cfg, tkv, tparams, device="cpu", **common)
    jrec = jtrace.record_service(jme.service)
    trec = record_service(tme.service)
    # the JAX service commits admissions and windows eagerly, where the
    # buddy body's lax.scan compiles op by op; jit the body (same function)
    pol, step = JBuddyPolicy(), JBuddyPolicy.step_scheduled
    body = jax.jit(lambda st, q, r: step(pol, st, q, r, "jnp"),
                   static_argnums=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JBuddyPolicy, "step_scheduled",
                   lambda self, st, q, r, backend: body(st, q, r))
        jrep = j_run_open_loop(jme, j_build_workload(JSpec(**SPEC),
                                                     cfg.vocab_size))
    trep = run_open_loop(tme, build_workload(LoadgenSpec(**SPEC),
                                             cfg.vocab_size))
    tme.service.recorder = jme.service.recorder = None
    ttr = certify_complete(trec.finish(), tme.engines,
                           tme.stats.window_bursts)
    jtr = jrec.finish(complete=True)
    d = tmp_path_factory.mktemp("traces")
    save_trace(ttr, d / "port.trc")
    jtrace.save_trace(jtr, d / "jax.trc")
    return dict(jme=jme, tme=tme, jrep=jrep, trep=trep, ttr=ttr, jtr=jtr,
                port_file=d / "port.trc", jax_file=d / "jax.trc")


def test_open_loop_report_equals_jax(open_loop):
    jrep, trep = open_loop["jrep"], open_loop["trep"]
    assert trep.completed == 6 and not trep.failed and not trep.stranded
    for f in ("completed", "failed", "stranded", "windows", "decode_steps",
              "p50_ttft_steps", "p99_ttft_steps", "queue_depth_mean",
              "queue_depth_max"):
        assert getattr(trep, f) == getattr(jrep, f), f
    for f in ("p50_ttft_us", "p90_ttft_us", "p99_ttft_us", "p50_tpot_us",
              "p99_tpot_us", "requests_per_s", "wall_s"):
        assert np.isfinite(getattr(trep, f)) and getattr(trep, f) >= 0, f
    assert trep.p99_ttft_us >= trep.p50_ttft_us > 0
    assert set(trep.as_metrics()) == set(jrep.as_metrics())


def test_open_loop_tokens_and_state_equal_jax(open_loop):
    jme, tme = open_loop["jme"], open_loop["tme"]
    assert {r.rid: r.output for r in tme.finished} == \
        {r.rid: r.output for r in jme.finished}
    for field in FreeListState._fields:
        np.testing.assert_array_equal(getattr(tme.alloc, field).numpy(),
                                      np.asarray(getattr(jme.alloc, field)),
                                      err_msg=field)
    tme.validate()
    for je, te in zip(jme.engines, tme.engines):
        for f in ("cache_hits", "aliased_pages", "contiguous_extents",
                  "extent_pages", "preemptions"):
            assert getattr(te.stats, f) == getattr(je.stats, f), f
        assert te.stats.mean_run_len > 1
    assert sum(e.stats.cache_hits for e in tme.engines) > 0
    assert tme.tenant_rollup() == jme.tenant_rollup()


def test_tracefiles_cross_both_ways(open_loop):
    ttr, jtr = open_loop["ttr"], open_loop["jtr"]
    port_in_jax = jtrace.load_trace(open_loop["port_file"])
    jax_in_port = load_trace(open_loop["jax_file"])
    port_in_port = load_trace(open_loop["port_file"])
    assert port_in_port.header == port_in_jax.header == ttr.header
    assert ttr.header["backend"] == "jnp" and ttr.header["policy"] == "buddy"
    assert ttr.header["complete"] is True and ttr.header["tenants"] == \
        jtr.header["tenants"]
    assert jax_in_port.header == jtr.header
    for a, b in ((port_in_jax, ttr), (port_in_port, ttr), (jax_in_port, jtr)):
        assert len(a.events) == len(b.events)
        for ea, eb in zip(a.events, b.events):
            assert ea[0] == eb[0]
            for x, y in zip(ea[1:], eb[1:]):
                np.testing.assert_array_equal(x, y)
    kinds = {ev[0] for ev in ttr.events}
    assert kinds == {"burst", "window", "retag", "bump"}
    # the port records every commit; JAX's in-jit decode bursts it counts
    assert ttr.windows == jtr.windows and ttr.bursts > jtr.bursts
    assert ttr.header["traced_commits"] == 0 < jtr.header["traced_commits"]


def test_open_loop_traces_replay_across_packages(open_loop):
    """The open-loop run's two tracefiles -- with the prefix caches'
    single frees, retags and refcount bumps -- replayed by both packages
    under the recorded policy: equal counters and final state."""
    for name in ("port_file", "jax_file"):
        want = jtrace.replay_trace(jtrace.load_trace(open_loop[name]))
        got = replay_trace(load_trace(open_loop[name]), device="cpu")
        assert got.report == want.report, name
        for field in FreeListState._fields:
            np.testing.assert_array_equal(
                getattr(got.state, field).numpy(),
                np.asarray(getattr(want.state, field)),
                err_msg=f"{name}: {field}")


@pytest.mark.parametrize("policy", ["freelist", "bitmap"])
def test_what_if_replay_follows_pages_and_keeps_live_counters(open_loop,
                                                              policy):
    """The buddy run's traces under another policy.  Their single frees,
    retags and bumps name buddy's block ids, which ``policy`` grants
    elsewhere: the JAX package's replay applies them as they are and ends
    in a state that fails I2 (duplicate ids on the free list's stack, an
    out-of-range id on bitmap's) with counters other than the live run's.
    The port's replay refuses such a what-if.  Without those ops
    (``drop_block_ids``) both packages replay to equal counters and one
    bit-identical, valid state."""
    from repro.core.freelist import validate_freelist as j_validate_freelist
    tme = open_loop["tme"]
    live = tme.service.tenant_report(tme.alloc)
    for name in ("port_file", "jax_file"):
        trace = load_trace(open_loop[name])
        assert trace.names_block_ids
        bad = jtrace.replay_trace(jtrace.load_trace(open_loop[name]),
                                  policy=policy)
        with pytest.raises(AssertionError, match="I2"):
            j_validate_freelist(bad.state)
        assert bad.report != live
        with pytest.raises(ValueError, match="names block ids"):
            replay_trace(trace, policy=policy, device="cpu")

        neutral = trace.drop_block_ids()
        assert not neutral.names_block_ids
        assert (neutral.bursts, neutral.windows) == \
            (trace.bursts, trace.windows)
        assert 0 < neutral.ops < trace.ops
        got = replay_trace(neutral, policy=policy, device="cpu")
        want = jtrace.replay_trace(neutral, policy=policy)
        assert got.report == want.report, (name, policy)
        for field in FreeListState._fields:
            np.testing.assert_array_equal(
                getattr(got.state, field).numpy(),
                np.asarray(getattr(want.state, field)),
                err_msg=f"{name} under {policy}: {field}")
        validate_freelist(got.state)
        j_validate_freelist(want.state)


def test_replay_launcher_drops_block_ids_for_a_what_if(open_loop, capsys):
    """``launch.replay`` on the CPU: the recorded policy replays the trace
    as it is; another policy replays it without its block-naming ops, and
    says so."""
    from repro_torch.launch.replay import main as replay_main
    path = str(open_loop["port_file"])
    replay_main([path, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "policy=buddy" in out and "without" not in out
    replay_main([path, "--device", "cpu", "--policy", "bitmap"])
    out = capsys.readouterr().out
    assert "under bitmap: without the single frees, retags and bumps" in out
    assert "policy=bitmap" in out


def test_live_counters_equal_replay_counters(open_loop):
    tme, jme = open_loop["tme"], open_loop["jme"]
    live = tme.service.tenant_report(tme.alloc)
    assert live == jme.service.tenant_report(jme.alloc)
    res = replay_trace(load_trace(open_loop["port_file"]), device="cpu")
    assert res.report == live
    for field in FreeListState._fields:
        assert torch.equal(getattr(res.state, field),
                           getattr(tme.alloc, field)), field
    assert res.bursts == open_loop["ttr"].bursts and res.wall_s > 0
    # the JAX trace misses only the decode steps' bursts, which did no
    # state work in this run (no live emergency malloc)
    assert sum(e.stats.decode_bursts for e in tme.engines) == 0
    jres = replay_trace(load_trace(open_loop["jax_file"]), device="cpu")
    assert jres.report == live


def test_certify_complete_rejects_a_late_recorder(open_loop):
    tme = open_loop["tme"]
    ttr = load_trace(open_loop["port_file"])
    late = type(ttr)(header=dict(ttr.header, complete=None),
                     events=ttr.events[5:])
    with pytest.raises(ValueError, match="trace incomplete"):
        certify_complete(late, tme.engines, tme.stats.window_bursts)
    assert certify_complete(ttr, tme.engines, tme.stats.window_bursts) \
        .header["complete"] is True
