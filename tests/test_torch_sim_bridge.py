"""The port's bridges into the allocator simulator and the last helpers of
its ported modules, against the JAX package's, on the CPU.

* ``to_sim_trace`` of a trace recorded from the port's ``AllocService``
  (mallocs and refills of several blocks, runs, single frees, FREE_ALLs,
  more lanes than sim threads, more classes than the sim's eight) equals
  JAX's ``to_sim_trace`` of the same tracefile; ``replay_sim_policies``
  gives JAX's dicts for every policy; ``launch/replay.py --sim ...
  --threads 4 --device cpu`` prints that sweep.
* ``sim.policies.replay_prefix_trace`` of a port engine's prefix-cache
  trace reproduces the live cache's counters, and equals JAX's replay of
  the same trace.
* The helpers (``paged_kv.admit_prefill``, ``gather_kv``,
  ``num_alloc_classes``, ``paged_service``; ``lane_stash.stash_push``;
  ``hmq.max_safe_lanes``, ``queue_occupancy``; ``packets.empty_queue``;
  ``freelist.num_free``; ``service.empty_burst_stats``;
  ``configs.all_configs``) each against its JAX counterpart: state bit
  for bit, arrays equal.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.loadgen import trace as jtrace  # noqa: E402
from repro.sim import policies as jpol  # noqa: E402
from repro_torch.alloc import AllocService  # noqa: E402
from repro_torch.core.freelist import FreeListState  # noqa: E402
from repro_torch.core.packets import OP_MALLOC_RUN, OP_NOP  # noqa: E402
from repro_torch.loadgen import (load_trace, record_service,  # noqa: E402
                                 replay_sim_policies, save_trace,
                                 to_sim_trace)
from repro_torch.sim.policies import ALL_POLICIES, replay_prefix_trace  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def service_trace(tmp_path_factory):
    """A trace recorded from the port's service under buddy (which keeps
    ``OP_MALLOC_RUN``) over ten tenants (classes fold mod 8 in the sim),
    written to a tracefile both packages load."""
    svc = AllocService(policy="buddy", device=CPU)
    tenants = [svc.register_tenant(f"t{i}", 64) for i in range(10)]
    rec = record_service(svc)
    state = svc.init_state()
    rng = np.random.RandomState(3)
    held: dict = {}
    for step in range(40):
        b = svc.new_burst()
        for _ in range(rng.randint(1, 6)):
            t, lane = int(rng.randint(10)), int(rng.randint(12))
            kind = rng.choice(["malloc", "refill", "run", "free", "free_all"])
            if kind == "malloc":
                b.malloc(tenants[t], [lane], n=int(rng.randint(1, 4)))
            elif kind == "refill":
                b.refill(tenants[t], [lane], n=int(rng.randint(1, 3)))
            elif kind == "run":
                b.malloc_run(tenants[t], [lane], n=2)
            elif kind == "free" and held.get((t, lane)):
                b.free(tenants[t], [lane], [held[(t, lane)].pop()])
            else:
                b.free_all(tenants[t], [lane])
                held.pop((t, lane), None)
        state, res = svc.commit(state, b, max_blocks_per_req=3)
        q = b.build_queue()
        for i, (op, lane, c) in enumerate(zip(q.op.tolist(), q.lane.tolist(),
                                              q.size_class.tolist())):
            if op in (1, 3, OP_MALLOC_RUN) and int(res.status[i]) == 1:
                held.setdefault((c, lane), []).extend(
                    x for x in res.blocks[i].tolist() if x >= 0)
        if step % 8 == 7:
            rec.mark_window()
    path = tmp_path_factory.mktemp("sim") / "service.trc"
    save_trace(rec.finish(), path)
    return path


@pytest.mark.parametrize("threads", [1, 4, 8])
def test_to_sim_trace_matches_jax(service_trace, threads):
    got = to_sim_trace(load_trace(service_trace), threads=threads)
    want = jtrace.to_sim_trace(jtrace.load_trace(service_trace),
                               threads=threads)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert set(np.unique(got["op"])) == {1, 2}
    assert 0 <= got["thread"].min() and got["thread"].max() < threads
    assert 0 <= got["size_class"].min() and got["size_class"].max() < 8
    ops = load_trace(service_trace).events
    assert any(ev[0] == "burst" and (ev[2] == OP_MALLOC_RUN).any()
               for ev in ops)
    assert any(ev[0] == "burst" and (ev[3] >= threads).any() for ev in ops)


def test_replay_sim_policies_matches_jax(service_trace):
    names = list(ALL_POLICIES)
    got = replay_sim_policies(load_trace(service_trace), names, threads=4,
                              device=CPU)
    want = jtrace.replay_sim_policies(jtrace.load_trace(service_trace),
                                      names, threads=4)
    assert got == want
    assert got["tcmalloc"]["mallocs"] > 0 and got["tcmalloc"]["frees"] > 0


def test_empty_sim_trace(tmp_path):
    """A trace with no malloc, refill or free lowers to an empty sim trace,
    which replays to the initial state under every policy."""
    svc = AllocService(device=CPU)
    kv = svc.register_tenant("kv", 8)
    rec = record_service(svc)
    svc.commit(svc.init_state(), _nop_burst(svc, kv))
    trace = rec.finish()
    sim = to_sim_trace(trace)
    assert all(a.shape == (0,) for a in sim.values())
    rows = replay_sim_policies(trace, list(ALL_POLICIES), device=CPU)
    assert all(v == 0 for r in rows.values() for v in r.values())
    save_trace(trace, tmp_path / "nop.trc")
    assert rows == jtrace.replay_sim_policies(
        jtrace.load_trace(tmp_path / "nop.trc"), list(ALL_POLICIES))


def _nop_burst(svc, kv):
    """A burst whose only packet is a free of ``NO_BLOCK`` (a NOP)."""
    b = svc.new_burst()
    b.free(kv, [0], [-1])
    assert b.build_queue().op.tolist() == [OP_NOP]
    return b


def test_replay_launcher_prints_the_sim_sweep(service_trace, capsys):
    from repro_torch.launch.replay import main
    main([str(service_trace), "--sim", "speedmalloc,tcmalloc", "--threads",
          "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "sim-policy sweep (4 threads, cpu):" in out
    rows = replay_sim_policies(load_trace(service_trace),
                               ["speedmalloc", "tcmalloc"], threads=4,
                               device=CPU)
    for name, r in rows.items():
        assert (f"  {name}: mallocs={r['mallocs']} frees={r['frees']} "
                f"fast_hits={r['fast_hits']} shared_trips="
                f"{r['shared_trips']} est_cycles={r['est_cycles']:.0f}") in out


# --------------------------------------------------------------------------
# the prefix-cache replay
# --------------------------------------------------------------------------

def test_replay_prefix_trace_of_port_engine():
    """Two port shards with LRU caches in alias mode serve ten requests on
    one 40-token prefix; each cache's trace replays to its live counters
    through the port's replay and through JAX's."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params, make_paged_config
    from repro_torch.serve.multi_engine import MultiEngine
    from repro_torch.serve.scheduler import Request, make_scheduler_config
    cfg = smoke_config("deepseek-7b")
    kvcfg = make_paged_config(cfg, seq_len=128, lanes=2, page_size=8,
                              dtype=torch.float32)
    me = MultiEngine(cfg, kvcfg, init_params(cfg, dtype=torch.float32,
                                             device=CPU),
                     n_engines=2, quantum=3, device=CPU,
                     sched_cfg=make_scheduler_config(cfg, kvcfg,
                                                     max_prompt_len=64),
                     prefix_cache=True, eviction="lru", cache_pages=8,
                     prefix_alias="alias")
    shared = np.random.RandomState(0).randint(0, cfg.vocab_size, size=40)
    me.submit([Request(rid=i, tokens=np.concatenate([
        shared, np.random.RandomState(100 + i).randint(
            0, cfg.vocab_size, size=6)]).astype(np.int32), max_new_tokens=6)
        for i in range(10)])
    while me.has_work:
        me.step_window()
    assert len(me.finished) == 10
    kinds = set()
    for e in me.engines:
        c = e.cache
        live = {"hits": c.hits, "misses": c.misses, "inserts": c.inserts,
                "evictions": c.evictions, "dup_skips": c.dup_skips,
                "pages": c.pages, "aliases": c.aliases}
        got = replay_prefix_trace(c.trace, "lru", c.budget, c.page_size)
        assert got == live
        assert jpol.replay_prefix_trace(c.trace, "lru", c.budget,
                                        c.page_size) == live
        kinds |= {ev[0] for ev in c.trace}
    assert {"insert", "probe", "alias", "unalias"} <= kinds
    assert sum(e.cache.hits for e in me.engines) > 0


# --------------------------------------------------------------------------
# the helpers
# --------------------------------------------------------------------------

def _configs(arch="deepseek-7b", lanes=3, seq_len=40):
    from repro.configs import smoke_config as j_smoke_config
    from repro.models import make_paged_config as j_make_paged_config
    from repro_torch.configs import smoke_config
    from repro_torch.models import make_paged_config
    stash = dict(stash_size=4, stash_watermark=1, stash_refill=2)
    jkv = j_make_paged_config(j_smoke_config(arch), seq_len=seq_len,
                              lanes=lanes, page_size=4, dtype=jnp.float32,
                              **stash)
    tkv = make_paged_config(smoke_config(arch), seq_len=seq_len, lanes=lanes,
                            page_size=4, dtype=torch.float32, **stash)
    return jkv, tkv


def _to_jax(tkv, state):
    """The port's paged state as the JAX package's (no sink page)."""
    from repro.core import paged_kv as jpkv
    from repro.core.freelist import FreeListState as JState
    from repro.core.lane_stash import LaneStashState as JStash
    n = tkv.num_pages
    return jpkv.PagedKVState(
        alloc=JState(*[jnp.asarray(t.numpy()) for t in state.alloc]),
        block_tables=jnp.asarray(state.block_tables.numpy()),
        seq_lens=jnp.asarray(state.seq_lens.numpy()),
        active=jnp.asarray(state.active.numpy()),
        k_pages=jnp.asarray(state.k_pages.numpy()[:n]),
        v_pages=jnp.asarray(state.v_pages.numpy()[:n]),
        state_slot=jnp.full((tkv.max_lanes,), -1, jnp.int32),
        lane_state=jnp.zeros((1, 1), jnp.float32),
        stash=JStash(jnp.asarray(state.stash.pages.numpy()),
                     jnp.asarray(state.stash.depth.numpy())),
        scratch_slot=jnp.asarray(state.scratch_slot.numpy()))


def _assert_paged_equal(t, j, ctx):
    for field in FreeListState._fields:
        np.testing.assert_array_equal(getattr(t.alloc, field).numpy(),
                                      np.asarray(getattr(j.alloc, field)),
                                      err_msg=f"{ctx}: alloc.{field}")
    for field in ("block_tables", "seq_lens", "active", "scratch_slot"):
        np.testing.assert_array_equal(getattr(t, field).numpy(),
                                      np.asarray(getattr(j, field)),
                                      err_msg=f"{ctx}: {field}")
    np.testing.assert_array_equal(t.stash.pages.numpy(),
                                  np.asarray(j.stash.pages))
    np.testing.assert_array_equal(t.stash.depth.numpy(),
                                  np.asarray(j.stash.depth))
    n = j.k_pages.shape[0]
    for name in ("k_pages", "v_pages"):
        np.testing.assert_array_equal(getattr(t, name).numpy()[:n],
                                      np.asarray(getattr(j, name)),
                                      err_msg=f"{ctx}: {name}")


def test_admit_prefill_and_gather_kv_match_jax():
    """Three single-lane admissions (the third overflows the lane's table
    and fails) and a release, then every layer's gather: state bit for
    bit, gathered K/V and masks equal."""
    from repro.core import paged_kv as jpkv
    from repro_torch.core import paged_kv as pkv
    jkv, tkv = _configs()
    tenants = pkv.paged_tenants(tkv, CPU)
    state = pkv.init_paged_kv(tkv, tenants)
    jstate = _to_jax(tkv, state)
    rng = np.random.RandomState(5)
    L, kvh, hd = tkv.num_kv_layers, tkv.kv_heads, tkv.head_dim
    T = tkv.max_pages_per_lane * tkv.page_size
    for lane, length, width in ((2, 13, 16), (0, 6, 16), (1, T + 4, T + 4)):
        k = rng.randn(L, width, kvh, hd).astype(np.float32)
        v = rng.randn(L, width, kvh, hd).astype(np.float32)
        state, stats = pkv.admit_prefill(tkv, state, lane,
                                         torch.from_numpy(k),
                                         torch.from_numpy(v), length, tenants)
        jstate, jstats = jpkv.admit_prefill(jkv, jstate, lane, jnp.asarray(k),
                                            jnp.asarray(v), length)
        _assert_paged_equal(state, jstate, f"admit lane {lane}")
        assert int(stats.core.failed) == int(jstats.core.failed)
        assert int(stats.core.mallocs) == int(jstats.core.mallocs)
    assert not bool(state.active[1]) and bool(state.active[2])
    lanes = torch.tensor([0, -1, -1], dtype=torch.int32)
    state, _ = pkv.release_packets(tkv, state, lanes, tenants)
    jstate, _ = jpkv.release_packets(jkv, jstate, jnp.asarray(lanes.numpy()))
    _assert_paged_equal(state, jstate, "release")
    for layer in range(L):
        got = pkv.gather_kv(tkv, state, layer)
        want = jpkv.gather_kv(jkv, jstate, layer)
        for g, w, name in zip(got, want, ("k", "v", "valid")):
            assert tuple(g.shape) == w.shape, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"layer {layer}: {name}")


@pytest.mark.parametrize("arch", ["deepseek-7b", "zamba2-1.2b"])
def test_num_alloc_classes_and_paged_service_match_jax(arch):
    from repro.core import paged_kv as jpkv
    from repro_torch.core import paged_kv as pkv
    jkv, tkv = _configs(arch)
    assert pkv.num_alloc_classes(tkv) == jpkv.num_alloc_classes(jkv)
    svc, jsvc = pkv.paged_service(tkv, CPU), jpkv.paged_service(jkv)
    assert [(t.name, int(t.capacity)) for t in svc.tenants] == \
        [(t.name, int(t.capacity)) for t in jsvc.tenants]
    assert svc.num_classes == jsvc.num_classes == pkv.num_alloc_classes(tkv)
    assert svc.device == torch.device(CPU) and svc.policy.name == "freelist"


def test_stash_push_matches_jax():
    from repro.core import lane_stash as jls
    from repro_torch.core import lane_stash as ls
    rng = np.random.RandomState(7)
    for _ in range(6):
        L, S = int(rng.randint(1, 6)), int(rng.randint(1, 5))
        depth = rng.randint(0, S + 1, L).astype(np.int32)
        pages = np.where(np.arange(S)[None, :] < depth[:, None],
                         rng.randint(0, 50, (L, S)), -1).astype(np.int32)
        new = rng.randint(0, 50, L).astype(np.int32)
        want_mask = rng.rand(L) < 0.7
        got, pushed = ls.stash_push(
            ls.LaneStashState(torch.from_numpy(pages), torch.from_numpy(depth)),
            torch.from_numpy(new), torch.from_numpy(want_mask))
        jgot, jpushed = jls.stash_push(
            jls.LaneStashState(jnp.asarray(pages), jnp.asarray(depth)),
            jnp.asarray(new), jnp.asarray(want_mask))
        np.testing.assert_array_equal(got.pages.numpy(), np.asarray(jgot.pages))
        np.testing.assert_array_equal(got.depth.numpy(), np.asarray(jgot.depth))
        np.testing.assert_array_equal(pushed.numpy(), np.asarray(jpushed))


def test_hmq_packets_freelist_service_helpers_match_jax():
    from repro.alloc import service as jsvc
    from repro.core import freelist as jfl
    from repro.core import hmq as jhmq
    from repro.core import packets as jpk
    from repro_torch.alloc import service as svc
    from repro_torch.core import freelist as fl
    from repro_torch.core import hmq, packets
    for q in (1, 7, 64, 4096, 1 << 20, 1 << 29):
        assert hmq.max_safe_lanes(q) == jhmq.max_safe_lanes(q), q
    rng = np.random.RandomState(2)
    for cap in (1, 9, 33):
        ops, lanes, cls, args = (rng.randint(0, 5, cap), rng.randint(0, 4, cap),
                                 rng.randint(0, 3, cap), rng.randint(-1, 4, cap))
        got = hmq.queue_occupancy(packets.make_queue(ops, lanes, cls, args))
        want = jhmq.queue_occupancy(jpk.make_queue(ops, lanes, cls, args))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == torch.int32 and int(got[k]) == int(want[k])
        empty, jempty = packets.empty_queue(cap), jpk.empty_queue(cap)
        assert empty.capacity == jempty.capacity == cap
        for g, w in zip(empty, jempty):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    state = fl.init_freelist([6, 3, 9])
    jstate = jfl.init_freelist([6, 3, 9])
    np.testing.assert_array_equal(fl.num_free(state).numpy(),
                                  np.asarray(jfl.num_free(jstate)))
    used = torch.tensor([2, 0, 5], dtype=torch.int32)
    for u in (None, used):
        got = svc.empty_burst_stats(3, u)
        want = jsvc.empty_burst_stats(
            3, None if u is None else jnp.asarray(u.numpy()))
        flat = [got.core, got.per_tenant, (got.queue_live, got.queue_capacity)]
        jflat = [want.core, want.per_tenant,
                 (want.queue_live, want.queue_capacity)]
        for g, w in zip(flat, jflat):
            for a, b in zip(g, w):
                assert a.dtype == torch.int32
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_all_configs_are_the_jax_packages():
    """Every arch both packages have, field for field (the port's own
    YaRN fields at their defaults); the port's only others are
    ``PORT_ONLY_ARCH_IDS``."""
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import ARCH_IDS, all_configs
    from _port_only import SHARED_ARCH_IDS, assert_config_is_jaxs
    cfgs = all_configs()
    assert tuple(cfgs) == ARCH_IDS
    for arch in SHARED_ARCH_IDS:
        assert_config_is_jaxs(cfgs[arch], j_get_config(arch))
