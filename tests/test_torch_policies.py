"""The port's bitmap and buddy allocator policies (``repro_torch.alloc
.policies``) against the JAX package's jnp policies, on the CPU.

The same scheduled bursts, drawn from numpy seeds, go through both
packages' ``step_scheduled`` with the state carried: state (free stack,
counters and the buddy split/merge counts included), blocks and ok must
be bit-identical.  Directed ``OP_MALLOC_RUN`` cases pin the buddy
placement (an aligned run, the fallback to singles, split and merge
counts), the gated all-NOP burst must leave a state bit-identical, a
registered custom policy must plug into ``AllocService``, and the
fragmentation report must equal the JAX dict.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.alloc import AllocService as JService  # noqa: E402
from repro.alloc.policies import _pow2_ceil as j_pow2_ceil  # noqa: E402
from repro.alloc.policies import get_policy as j_get_policy  # noqa: E402
from repro.core.freelist import FreeListState as JState  # noqa: E402
from repro.core.freelist import fragmentation_report as j_frag  # noqa: E402
from repro.core.hmq import schedule as j_schedule  # noqa: E402
from repro.core.packets import RequestQueue as JQueue  # noqa: E402
from repro_torch.alloc import (ALLOC_POLICIES, AllocService,  # noqa: E402
                               BitmapPolicy, get_policy, register_policy)
from repro_torch.alloc.policies import _pow2_ceil  # noqa: E402
from repro_torch.core.freelist import (FreeListState,  # noqa: E402
                                       fragmentation_report, init_freelist,
                                       validate_freelist)
from repro_torch.core.hmq import schedule  # noqa: E402
from repro_torch.core.packets import (FREE_ALL, NO_BLOCK, OP_FREE,  # noqa: E402
                                      OP_MALLOC, OP_MALLOC_RUN, OP_NOP,
                                      OP_REFILL, RequestQueue)

CAPS = [37, 8, 64]
NAMES = ["kv_pages", "scratch", "slots"]
Q = 12


def to_jax(state: FreeListState) -> JState:
    return JState(*[jnp.asarray(t.numpy()) for t in state])


def assert_state_equal(t: FreeListState, j: JState, ctx: str) -> None:
    for field in JState._fields:
        np.testing.assert_array_equal(getattr(t, field).numpy(),
                                      np.asarray(getattr(j, field)),
                                      err_msg=f"{ctx}: state.{field}")
        assert getattr(t, field).dtype == torch.int32, (ctx, field)


@functools.lru_cache(maxsize=None)
def j_step(policy: str, R: int):
    """The JAX policy's scheduled step, jitted once per (policy, R): the
    bursts of a test share one queue capacity."""
    pol = j_get_policy(policy)
    return jax.jit(lambda st, q: pol.step_scheduled(st, q, R, "jnp"))


def random_cols(rng, C, N, R, q=Q, all_nop=False):
    ops = rng.choice([OP_MALLOC, OP_REFILL, OP_MALLOC_RUN, OP_MALLOC_RUN,
                      OP_FREE, OP_FREE, OP_NOP], q)
    if all_nop:
        ops[:] = OP_NOP
    args = np.where(ops == OP_FREE,
                    np.where(rng.rand(q) < 0.4, FREE_ALL,
                             rng.randint(0, N + 2, q)),
                    rng.randint(-1, R + 2, q))        # incl. 0 and overwide
    return [np.asarray(x, np.int32) for x in
            (ops, rng.randint(0, 5, q), rng.randint(-1, C + 1, q), args)]


def both_steps(policy, tst, jst, cols, R, gated=False, ctx=""):
    """One scheduled burst through both packages; asserts bit identity and
    returns the new states."""
    tsched, _ = schedule(RequestQueue(*[torch.from_numpy(c) for c in cols]))
    jsched, _ = j_schedule(JQueue(*[jnp.asarray(c) for c in cols]))
    t_new, t_blocks, t_ok = get_policy(policy).step_scheduled(
        tst, tsched, R, gated=gated)
    if gated and not (cols[0] != OP_NOP).any():
        # the JAX service's lax.cond skip branch
        j_new, j_blocks, j_ok = (jst, np.full((Q, R), NO_BLOCK, np.int32),
                                 np.zeros((Q,), np.int32))
    else:
        j_new, j_blocks, j_ok = j_step(policy, R)(jst, jsched)
    assert_state_equal(t_new, j_new, ctx)
    np.testing.assert_array_equal(t_blocks.numpy(), np.asarray(j_blocks),
                                  err_msg=f"{ctx}: blocks")
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok),
                                  err_msg=f"{ctx}: ok")
    validate_freelist(t_new)
    return t_new, j_new


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", ["bitmap", "buddy"])
def test_random_bursts_match_jax(policy, seed):
    """30 random bursts, state carried: malloc / refill / run / single and
    FREE_ALL frees, overwide and zero-size requests, out-of-range classes,
    some bursts all-NOP, half gated."""
    rng = np.random.RandomState(seed)
    tst = get_policy(policy).init(CAPS, torch.device("cpu"))
    jst = j_get_policy(policy).init(CAPS)
    assert_state_equal(tst, jst, "init")
    for b in range(30):
        R = int(rng.choice([1, 4, 8]))
        cols = random_cols(rng, len(CAPS), max(CAPS), R,
                           all_nop=b % 9 == 4)
        tst, jst = both_steps(policy, tst, jst, cols, R,
                              gated=bool(rng.rand() < 0.5),
                              ctx=f"{policy} seed {seed} burst {b}")
    if policy == "buddy":
        assert int(tst.split_count.sum()) > 0
        assert int(tst.merge_count.sum()) > 0
    else:
        assert not tst.split_count.any() and not tst.merge_count.any()


def _q(*rows):
    """A Q-slot queue from ``(op, lane, class, arg)`` rows, NOP-padded."""
    cols = np.zeros((4, Q), np.int32)
    for i, r in enumerate(rows):
        cols[:, i] = r
    return list(cols)


def test_buddy_directed_runs_fallback_and_counts():
    """Directed ``OP_MALLOC_RUN`` cases on one class of 16 blocks."""
    caps = [16]
    tst = get_policy("buddy").init(caps, torch.device("cpu"))
    jst = j_get_policy("buddy").init(caps)

    # 3 blocks -> the lowest aligned run of 4 (ids 0-2); 2 blocks -> the
    # next aligned run of 2 (ids 4-5): the 16-run, the 8-run at 0, the
    # 4-runs at 0 and 4 and the 2-runs at 0, 2 and 4 split
    tst, jst = both_steps("buddy", tst, jst, _q((OP_MALLOC_RUN, 0, 0, 3),
                                                (OP_MALLOC_RUN, 1, 0, 2)),
                          4, ctx="aligned runs")
    assert tst.owner[0, :6].tolist() == [0, 0, 0, -1, 1, 1]
    assert tst.split_count.tolist() == [7]
    assert tst.merge_count.tolist() == [0]

    # fragment: lane 2 takes 8 blocks (the run at 8), then frees every
    # other one, leaving no aligned free run of 4 anywhere
    tst, jst = both_steps("buddy", tst, jst, _q((OP_MALLOC_RUN, 2, 0, 8)), 8,
                          ctx="fill")
    assert tst.owner[0, 8:16].tolist() == [2] * 8
    frees = [(OP_FREE, 2, 0, b) for b in (8, 10, 12, 14)] \
        + [(OP_FREE, 0, 0, 1)]
    tst, jst = both_steps("buddy", tst, jst, _q(*frees), 1, ctx="holes")
    # a run of 3 finds no aligned 4: first-fit singles 1, 3, 6
    tst, jst = both_steps("buddy", tst, jst, _q((OP_MALLOC_RUN, 3, 0, 3)),
                          4, ctx="fallback")
    assert sorted(np.flatnonzero(tst.owner[0].numpy() == 3).tolist()) == \
        [1, 3, 6]
    # releasing everything merges back to the whole tree
    tst, jst = both_steps("buddy", tst, jst,
                          _q(*[(OP_FREE, lane, 0, FREE_ALL)
                               for lane in range(4)]), 1, ctx="merge")
    assert int(tst.used[0]) == 0
    frag = fragmentation_report(tst)["class0"]
    assert frag["largest_aligned_run"] == 16 and frag["free_extents"] == 1
    assert frag["split_count"] == int(tst.split_count[0]) > 7
    assert frag["merge_count"] == int(tst.merge_count[0]) > 0


@pytest.mark.parametrize("policy", ["bitmap", "buddy"])
def test_gated_all_nop_leaves_state_bit_identical(policy):
    """A state whose stack is not the ascending bitmap order (a free-list
    state): gated, an all-NOP burst keeps it bit for bit and reports
    nothing granted; ungated, the policy rebuilds the stack, as JAX's
    does."""
    rng = np.random.RandomState(5)
    state = init_freelist(CAPS)
    for _ in range(3):
        sched, _ = schedule(RequestQueue(*[torch.from_numpy(c) for c in
                                           random_cols(rng, 3, 64, 4)]))
        state = get_policy("freelist").step_scheduled(state, sched, 4)[0]
    nop = _q()
    new, blocks, ok = get_policy(policy).step_scheduled(
        state, schedule(RequestQueue(*[torch.from_numpy(c)
                                       for c in nop]))[0], 4, gated=True)
    for a, b in zip(new, state):
        assert torch.equal(a, b)
    assert (blocks == NO_BLOCK).all() and not ok.any()
    both_steps(policy, state, to_jax(state), nop, 4, gated=False,
               ctx=f"{policy} ungated all-NOP")
    both_steps(policy, state, to_jax(state), nop, 4, gated=True,
               ctx=f"{policy} gated all-NOP")


def test_pow2_ceil_matches_jax():
    # every request width R the service allows, and past it up to 2**24
    # (above that the JAX package's float32 log2 rounds n itself)
    n = np.concatenate([np.arange(0, 4100), [2**20 - 1, 2**20, 2**20 + 1,
                                             2**24 - 1, 2**24]]).astype(np.int32)
    np.testing.assert_array_equal(
        _pow2_ceil(torch.from_numpy(n)).numpy(),
        np.asarray(j_pow2_ceil(jnp.asarray(n))))


class ReverseFit(BitmapPolicy):
    """A custom design: the bitmap policy with its ids mirrored, so a grant
    takes the highest free ids (every class here has the same capacity)."""

    name = "reverse_fit"
    calls = 0

    def step_scheduled(self, state, sched, max_blocks_per_req, gated=False):
        type(self).calls += 1
        N = state.max_capacity
        mirror = lambda t: t.flip(1)                           # noqa: E731
        flipped = state._replace(owner=mirror(state.owner),
                                 refcount=mirror(state.refcount))
        sched = sched._replace(arg=torch.where(
            (sched.op == OP_FREE) & (sched.arg >= 0), N - 1 - sched.arg,
            sched.arg))
        new, blocks, ok = super().step_scheduled(flipped, sched,
                                                 max_blocks_per_req, gated)
        stack = torch.where(new.free_stack >= 0, N - 1 - new.free_stack,
                            new.free_stack)
        new = new._replace(owner=mirror(new.owner),
                           refcount=mirror(new.refcount), free_stack=stack)
        return new, torch.where(blocks >= 0, N - 1 - blocks, blocks), ok


def test_register_policy_plugs_a_custom_design_into_the_service():
    register_policy(ReverseFit())
    assert get_policy("reverse_fit").name == "reverse_fit"
    assert ALLOC_POLICIES == ("freelist", "bitmap", "buddy")
    svc = AllocService(policy="reverse_fit", device="cpu")
    kv = svc.register_tenant("kv_pages", 8)
    state = svc.init_state()
    b = svc.new_burst()
    t = b.malloc(kv, [0, 1], n=2)
    b.malloc_run(kv, 2, n=2)                   # no run support: a malloc
    assert b.build_queue().op.tolist() == [OP_MALLOC] * 3
    state, res = svc.commit(state, b, max_blocks_per_req=2)
    assert res.blocks_for(t).tolist() == [[7, 6], [5, 4]]
    assert ReverseFit.calls == 1
    validate_freelist(state)
    b = svc.new_burst()
    b.free_all(kv, [0, 1, 2])
    state, _ = svc.commit(state, b)
    assert int(state.used[0]) == 0 and int(state.free_count[0]) == 6
    validate_freelist(state)


@pytest.mark.parametrize("policy", ALLOC_POLICIES)
def test_malloc_run_lowering_and_service_commits_match_jax(policy):
    """Through both services, typed builder ops with ``where`` masks:
    ``malloc_run`` stages ``OP_MALLOC_RUN`` only under buddy; responses,
    state and the fragmentation report (service and engine subset) equal
    the JAX service's, burst after burst."""
    spec = list(zip(NAMES, CAPS))
    js = JService(policy=policy, backend="jnp")
    ts = AllocService(policy=policy, device="cpu")
    jh, th = js.register_tenants(spec), ts.register_tenants(spec)
    jst, tst = js.init_state(), ts.init_state()
    jcommit = jax.jit(lambda st, q: js.commit(st, q, max_blocks_per_req=4))
    rng = np.random.RandomState(7)
    lanes = np.arange(4, dtype=np.int32)
    for b in range(8):
        cols = []
        for svc, h in ((js, jh), (ts, th)):
            r = np.random.RandomState(100 + b)
            bb = svc.new_burst()
            bb.malloc_run(h[0], lanes, n=r.randint(0, 5, 4).astype(np.int32),
                          where=r.rand(4) < 0.7)
            bb.malloc(h[1], lanes, 1, where=r.rand(4) < 0.5)
            bb.refill(h[2], lanes, 3, where=r.rand(4) < 0.5)
            bb.free(h[0], lanes, r.randint(-1, 37, 4).astype(np.int32),
                    where=r.rand(4) < 0.5)
            bb.free_all(h[2], int(r.randint(0, 4)))
            cols.append(bb.build_queue())
        jq, tq = cols
        want_run = OP_MALLOC_RUN if policy == "buddy" else OP_MALLOC
        assert (tq.op[:4] == want_run).sum() + (tq.op[:4] == OP_NOP).sum() \
            == 4
        np.testing.assert_array_equal(tq.op.numpy(), np.asarray(jq.op))
        jst, jres = jcommit(jst, jq)
        tst, tres = ts.commit(tst, tq, max_blocks_per_req=4)
        assert_state_equal(tst, jst, f"{policy} burst {b}")
        np.testing.assert_array_equal(tres.blocks.numpy(),
                                      np.asarray(jres.blocks))
        np.testing.assert_array_equal(tres.status.numpy(),
                                      np.asarray(jres.status))
        assert ts.fragmentation_report(tst) == js.fragmentation_report(jst)
        assert fragmentation_report(tst, NAMES) == j_frag(jst, NAMES)
        sub = ts.fragmentation_report(tst, tenants=th[1:])
        assert list(sub) == NAMES[1:]
        rng.rand()
