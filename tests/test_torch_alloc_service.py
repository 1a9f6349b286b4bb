"""The port's ``AllocService.commit`` against the JAX service.

Both services register the same tenants and commit the same bursts --
staged through the typed builder ops (with ``where`` masks) or as raw
queues -- with state carried.  Responses, status, ``BurstStats`` and
``TenantStats`` must be identical, gated and ungated, all-NOP bursts
included.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.alloc import AllocService as JService  # noqa: E402
from repro.core.packets import RequestQueue as JQueue  # noqa: E402
from repro_torch.alloc import AllocService, get_policy  # noqa: E402
from repro_torch.core.freelist import validate_freelist  # noqa: E402
from repro_torch.core.packets import (FREE_ALL, OP_FREE, OP_MALLOC,  # noqa: E402
                                      OP_NOP, OP_REFILL, RequestQueue)

TENANTS = [("kv_pages", 12), ("scratch", 3), ("state_slots", 5)]


def services():
    js = JService(policy="freelist", backend="jnp")
    ts = AllocService(device="cpu")
    jh = js.register_tenants(TENANTS)
    th = ts.register_tenants(TENANTS)
    return js, ts, jh, th


def jax_commit(js, R, gated=False):
    """The JAX service's commit of a built queue, jitted: the queues of a
    test share one shape, so it traces once."""
    return jax.jit(lambda st, q: js.commit(st, q, max_blocks_per_req=R,
                                           gated=gated))


def assert_commit_equal(j, t, ctx):
    (jst, jres), (tst, tres) = j, t
    for field in jst._fields:
        np.testing.assert_array_equal(getattr(tst, field).numpy(),
                                      np.asarray(getattr(jst, field)),
                                      err_msg=f"{ctx}: state.{field}")
    np.testing.assert_array_equal(tres.blocks.numpy(), np.asarray(jres.blocks),
                                  err_msg=f"{ctx}: blocks")
    np.testing.assert_array_equal(tres.status.numpy(), np.asarray(jres.status),
                                  err_msg=f"{ctx}: status")
    assert int(tres.live) == int(jres.live), ctx
    for f in jres.stats.core._fields:
        assert int(getattr(tres.stats.core, f)) == \
            int(getattr(jres.stats.core, f)), (ctx, f)
    for f in jres.stats.per_tenant._fields:
        np.testing.assert_array_equal(
            getattr(tres.stats.per_tenant, f).numpy(),
            np.asarray(getattr(jres.stats.per_tenant, f)),
            err_msg=f"{ctx}: per_tenant.{f}")
        assert getattr(tres.stats.per_tenant, f).dtype == torch.int32
    assert int(tres.stats.queue_live) == int(jres.stats.queue_live), ctx
    assert int(tres.stats.queue_capacity) == int(jres.stats.queue_capacity)


def stage(builder, h, rng, L):
    """The same typed ops, with the same masks, on either package's builder
    (lanes and masks as numpy; each builder converts to its own arrays)."""
    kv, scratch, slots = h
    lanes = np.arange(L, dtype=np.int32)
    tickets = [
        builder.malloc(kv, lanes, n=rng.randint(0, 4, L).astype(np.int32),
                       where=rng.rand(L) < 0.7),
        builder.refill(kv, lanes, 2, where=rng.rand(L) < 0.4),
        builder.malloc(scratch, lanes, 1, where=rng.rand(L) < 0.5),
        builder.malloc_run(slots, lanes, n=2, where=rng.rand(L) < 0.5),
        builder.free(kv, lanes, rng.randint(-1, 13, L).astype(np.int32),
                     where=rng.rand(L) < 0.5),
        builder.free_all(scratch, lanes, where=rng.rand(L) < 0.3),
        builder.free_all(slots, int(rng.randint(0, L))),
    ]
    return tickets


@pytest.mark.parametrize("gated", [False, True])
def test_commit_matches_jax_builder_bursts(gated):
    js, ts, jh, th = services()
    jst, tst = js.init_state(), ts.init_state()
    commit = jax_commit(js, 4, gated)
    for b in range(8):
        seed = 1000 * gated + b
        jb, tb = js.new_burst(), ts.new_burst()
        jt = stage(jb, jh, np.random.RandomState(seed), 4)
        tt = stage(tb, th, np.random.RandomState(seed), 4)
        assert jt == tt
        j = commit(jst, jb.build_queue())
        t = ts.commit(tst, tb, max_blocks_per_req=4, gated=gated)
        assert_commit_equal(j, t, f"burst {b}")
        for tk in tt:
            np.testing.assert_array_equal(t[1].blocks_for(tk).numpy(),
                                          np.asarray(j[1].blocks_for(tk)))
            np.testing.assert_array_equal(t[1].ok_for(tk).numpy(),
                                          np.asarray(j[1].ok_for(tk)))
        jst, tst = j[0], t[0]
        validate_freelist(tst)


@pytest.mark.parametrize("gated", [False, True])
def test_commit_matches_jax_all_nop_burst(gated):
    """An all-NOP burst after live ones: gated, the JAX service skips the
    step (``lax.cond``) and the port decides the same on the device."""
    js, ts, jh, th = services()
    jst, tst = js.init_state(), ts.init_state()
    jb, tb = js.new_burst(), ts.new_burst()
    for b, h in ((jb, jh), (tb, th)):
        b.malloc(h[0], np.arange(3, dtype=np.int32), n=3)
        b.free_all(h[0], 1)
    j = jax_commit(js, 3, gated)(jst, jb.build_queue())
    t = ts.commit(tst, tb, max_blocks_per_req=3, gated=gated)
    assert_commit_equal(j, t, "live burst")
    jst, tst = j[0], t[0]
    jb, tb = js.new_burst(), ts.new_burst()
    for b, h in ((jb, jh), (tb, th)):
        b.malloc(h[0], np.arange(4, dtype=np.int32), 1, where=np.zeros(4, bool))
        b.refill(h[1], np.arange(4, dtype=np.int32), 2, where=np.zeros(4, bool))
    j = jax_commit(js, 2, gated)(jst, jb.build_queue())
    t = ts.commit(tst, tb, max_blocks_per_req=2, gated=gated)
    assert_commit_equal(j, t, "all-NOP burst")
    assert int(t[1].live) == 0


def test_commit_matches_jax_raw_queues():
    """Raw ``RequestQueue`` commits (out-of-range classes, overwide and
    zero-size mallocs, frees of unowned ids) through both services."""
    js, ts, _, _ = services()
    jst, tst = js.init_state(), ts.init_state()
    commit = jax_commit(js, 4)
    rng = np.random.RandomState(3)
    for b in range(6):
        Q = 10
        ops = rng.choice([OP_MALLOC, OP_REFILL, OP_FREE, OP_NOP], Q)
        args = np.where(ops == OP_FREE,
                        np.where(rng.rand(Q) < 0.4, FREE_ALL,
                                 rng.randint(0, 14, Q)),
                        rng.randint(-1, 6, Q))
        cols = [np.asarray(x, np.int32) for x in
                (ops, rng.randint(0, 5, Q), rng.randint(-1, 4, Q), args)]
        j = commit(jst, JQueue(*[jnp.asarray(c) for c in cols]))
        t = ts.commit(tst, RequestQueue(*[torch.from_numpy(c) for c in cols]),
                      max_blocks_per_req=4)
        assert_commit_equal(j, t, f"raw burst {b}")
        jst, tst = j[0], t[0]


def test_only_freelist_policy_is_ported():
    assert get_policy("freelist").name == "freelist"
    for name in ("bitmap", "buddy"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            AllocService(policy=name, device="cpu")


def test_commit_rejects_mismatched_state():
    _, ts, _, _ = services()
    other = AllocService(device="cpu")
    other.register_tenant("only", 4)
    queue = RequestQueue(*[torch.zeros(1, dtype=torch.int32)
                           for _ in range(4)])
    with pytest.raises(ValueError, match="size classes"):
        ts.commit(other.init_state(), queue)
