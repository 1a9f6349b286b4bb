"""The support-core burst's plan and its sliced algorithm, on the CPU.

The CUDA kernel cuts each size class's ids into contiguous slices, one per
block of a thread-block cluster, and grants with a fast path or a warp-
batched sequential skip.  Here:

* ``plan_burst`` is checked over a sweep of N from 1 to 2**18: its slices
  cover ``[0, N)`` contiguously in rank order, each fits a block's shared
  memory, and the path follows the shapes (one block, a cluster, device
  memory);
* the plain sliced model of the kernel's algorithm
  (``kernels/support_core/ref.py::support_core_burst_sliced``) is held bit
  for bit against the plain step ``_step_scheduled_torch`` and the JAX
  package's ``_step_scheduled_jnp`` at the card-sized pools (N = 35840 and
  65536) and at a small N with forced slices;
* the plain step is held against the JAX oracle at the decode burst's
  shape of a card-sized gemma3-1b pool (Q=512 C=2 N=35840 R=8).

The same seeded numpy inputs go to both packages; no tolerance.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import freelist as jfl  # noqa: E402
from repro.core import hmq as jhmq  # noqa: E402
from repro.core import packets as jpk  # noqa: E402
from repro.core.support_core import _step_scheduled_jnp  # noqa: E402
from repro_torch.core.freelist import FreeListState  # noqa: E402
from repro_torch.core.packets import (  # noqa: E402
    FREE_ALL, OP_FREE, OP_MALLOC, OP_MALLOC_RUN, OP_NOP, OP_REFILL,
    RequestQueue)
from repro_torch.core.support_core import _step_scheduled_torch  # noqa: E402
from repro_torch.kernels.support_core.ops import (  # noqa: E402
    H100_SMEM_OPTIN, MAX_CLUSTER, STATIC_SMEM, block_ids, head_words,
    plan_burst)
from repro_torch.kernels.support_core.ref import (  # noqa: E402
    support_core_burst_sliced, warp_grant)

J_STEP = jax.jit(_step_scheduled_jnp, static_argnums=(2,))
POOL_LANES = 256


def to_torch(nt, cls):
    return cls(*[torch.from_numpy(np.array(x)) for x in nt])


def jax_sched(ops, lanes, classes, args, capacity=None):
    q = jpk.make_queue(*[np.asarray(x, np.int32)
                         for x in (ops, lanes, classes, args)],
                       capacity=capacity)
    return jhmq.schedule(q)[0]


def assert_same(want, got, ctx):
    (ws, wb, wok), (gs, gb, gok) = want, got
    for field in FreeListState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(gs, field)),
                                      np.asarray(getattr(ws, field)),
                                      err_msg=f"{ctx}: {field}")
    np.testing.assert_array_equal(np.asarray(gb), np.asarray(wb), err_msg=ctx)
    np.testing.assert_array_equal(np.asarray(gok), np.asarray(wok),
                                  err_msg=ctx)


def three_ways(jstate, jsched, R, slice_ids, gated=False, ctx=""):
    """The JAX oracle, the plain step and the sliced model on one burst;
    returns the JAX result (the next state)."""
    j_out = J_STEP(jstate, jsched, R)
    if gated and not np.asarray(jsched.op).any():   # the gate's skip branch
        j_out = (j_out[0]._replace(peak_used=jstate.peak_used),) + j_out[1:]
    tstate = to_torch(jstate, FreeListState)
    tsched = to_torch(jsched, RequestQueue)
    plain = _step_scheduled_torch(tstate, tsched, R, gated=gated)
    sliced = support_core_burst_sliced(tstate, tsched, R, slice_ids,
                                       gated=gated)
    assert_same(j_out, plain, f"{ctx} plain")
    assert_same(plain, sliced, f"{ctx} sliced x {slice_ids}")
    return j_out


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

QS = [1, 8, 64, 256, 512, 1024]


def sweep_ns(Q):
    cap = block_ids(Q)
    ns = set(range(1, 1025)) | set(range(1025, 2**18 + 1, 509))
    ns |= {2**e + d for e in range(10, 19) for d in (-1, 0, 1)}
    ns |= {m * cap + d for m in (1, 2, 7, 8) for d in (-129, -1, 0, 1, 128)}
    return sorted(n for n in ns if 1 <= n <= 2**18)


@pytest.mark.parametrize("Q", QS)
def test_plan_slices_cover_ids_in_rank_order(Q):
    """Every plan: contiguous, non-empty slices of whole sweep tiles that
    cover [0, N) in rank order, each fitting a block's shared memory; the
    path is one block up to a block's capacity, a cluster up to 8 blocks'
    and device memory beyond."""
    cap = block_ids(Q)
    for N in sweep_ns(Q):
        plan = plan_burst(Q, 2, N)
        slices = plan.slices(N)
        assert len(slices) == plan.cluster and 1 <= plan.cluster <= MAX_CLUSTER
        assert slices[0][0] == 0 and slices[-1][1] == N, (N, plan)
        assert all(hi > lo for lo, hi in slices), (N, plan)
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
        assert all(hi - lo <= plan.slice for lo, hi in slices)
        tile = 32 if plan.path == "global" else 128
        assert plan.slice % tile == 0, (N, plan)
        assert plan.smem_bytes + STATIC_SMEM <= H100_SMEM_OPTIN, (N, plan)
        want = "block" if N <= cap else "cluster" if N <= 8 * cap else "global"
        assert plan.path == want, (N, plan)
        if plan.path == "global":
            assert plan.smem_bytes == 4 * head_words(Q)
        else:
            assert plan.smem_bytes == 4 * head_words(Q) + 16 * plan.slice
            assert plan.slice <= cap
        if plan.path == "block":
            assert plan.cluster == 1


@pytest.mark.parametrize("Q,N,path,cluster", [
    (8, 512, "block", 1),            # the serve's burst
    (24, 512, "block", 1),
    (512, 35840, "cluster", 8),      # a card-sized gemma3-1b pool
    (64, 35840, "cluster", 8),
    (256, 65536, "cluster", 8),
    (512, 65536, "cluster", 8),
    (512, 131072, "global", 8),      # past a cluster's shared memory
    (512, 2**18, "global", 8),
])
def test_plan_named_shapes(Q, N, path, cluster):
    plan = plan_burst(Q, 2, N)
    assert (plan.path, plan.cluster) == (path, cluster)


def test_plan_reads_only_shapes():
    """The plan is a function of (Q, C, N) and the limits: the same for any
    class count, and it rejects a queue too large for one block."""
    assert plan_burst(512, 2, 35840) == plan_burst(512, 9, 35840)
    assert plan_burst(512, 2, 35840, smem_optin=H100_SMEM_OPTIN // 2).cluster \
        == 8
    with pytest.raises(ValueError):
        plan_burst(8000, 2, 512)
    with pytest.raises(ValueError):
        plan_burst(8, 2, 0)


class _FakeLib:
    """Stands in for the built library: the card's limits, as a card that
    can hold no cluster would report them."""

    def support_core_smem_optin(self):
        return H100_SMEM_OPTIN

    def support_core_max_active_clusters(self, *args):
        return 0


def test_unschedulable_cluster_raises(monkeypatch):
    """A cluster the card cannot hold raises; the wrapper never falls back
    to another path.  One block needs no cluster and passes."""
    from repro_torch.kernels.support_core import ops
    monkeypatch.setattr(ops.KERNEL, "lib", _FakeLib())
    ops.card_plan.cache_clear()
    try:
        assert ops.card_plan(8, 2, 512).path == "block"
        with pytest.raises(RuntimeError, match="cannot be scheduled"):
            ops.card_plan(512, 2, 35840)
    finally:
        ops.card_plan.cache_clear()


# --------------------------------------------------------------------------
# the kernel's grant recurrence
# --------------------------------------------------------------------------

def sequential_skip(want, top):
    granted = np.zeros(len(want), np.int64)
    offset = np.zeros(len(want), np.int64)
    consumed = fails = 0
    for i, w in enumerate(want):
        if w < 0:
            continue
        if w > 0 and consumed + w <= top:
            granted[i], offset[i] = w, consumed
            consumed += w
        else:
            fails += 1
    return granted, offset, fails


@pytest.mark.parametrize("seed", range(6))
def test_warp_grant_is_the_sequential_skip(seed):
    """Batches of 32, requests wanting more than what is left failing at
    once, a prefix sum up to the first misfit: the same grants, offsets
    and fail count as the one-at-a-time recurrence."""
    rng = np.random.RandomState(seed)
    for _ in range(40):
        Q = int(rng.randint(1, 200))
        want = rng.randint(-1, 10, Q)
        top = int(rng.randint(0, max(1, want.clip(0).sum() + 3)))
        g, off, fails = warp_grant(want, top)
        rg, roff, rfails = sequential_skip(want, top)
        np.testing.assert_array_equal(g, rg)
        np.testing.assert_array_equal(off[rg > 0], roff[rg > 0])
        assert fails == rfails


# --------------------------------------------------------------------------
# the sliced model at the card-sized pools
# --------------------------------------------------------------------------

def warm_pool(pages, warm=26000, seed=11):
    """``[pages, 256]`` classes with about ``warm`` pages in use across
    lanes 0-255, from bursts of up to 512 mallocs of 1-8 pages."""
    rng = np.random.RandomState(seed)
    wants = rng.randint(1, 9, 2 * warm // 4)
    wants = wants[:int(np.searchsorted(np.cumsum(wants), warm)) + 1]
    state = jfl.init_freelist([pages, POOL_LANES])
    for lo in range(0, len(wants), 512):
        w = wants[lo:lo + 512]
        sched = jax_sched(np.full(len(w), OP_MALLOC),
                          (np.arange(len(w)) + lo) % POOL_LANES,
                          np.zeros(len(w)), w, capacity=512)
        state = J_STEP(state, sched, 8)[0]
    return state


def pool_burst(kind, state, seed=12):
    """The decode burst (MALLOC(1) and REFILL(8) slots of 256 lanes, live
    for ~1/16 and ~1/8 of them), the release burst (32 FREE_ALLs, 32 single
    frees of owned pages) or the all-NOP burst, scheduled."""
    rng = np.random.RandomState(seed)
    lanes = np.repeat(np.arange(POOL_LANES), 2)
    slot = np.tile([OP_MALLOC, OP_REFILL], POOL_LANES)
    zeros = np.zeros(2 * POOL_LANES)
    if kind == "decode":
        live = rng.rand(2 * POOL_LANES) < np.tile([1 / 16, 1 / 8], POOL_LANES)
        return jax_sched(np.where(live, slot, OP_NOP), lanes, zeros,
                         np.where(slot == OP_MALLOC, 1, 8))
    if kind == "all_nop":
        return jax_sched(zeros, lanes, zeros, zeros)
    owner = np.asarray(state.owner)[0]
    pages = rng.choice(np.flatnonzero(owner >= 0), 32, replace=False)
    fa = rng.choice(POOL_LANES, 32, replace=False)
    return jax_sched(np.full(64, OP_FREE), np.concatenate([fa, owner[pages]]),
                     np.zeros(64), np.concatenate([np.full(32, FREE_ALL),
                                                   pages]))


@pytest.fixture(scope="module")
def pools():
    return {n: warm_pool(n) for n in (35840, 65536)}


@pytest.mark.parametrize("kind", ["decode", "release", "all_nop"])
@pytest.mark.parametrize("pages", [35840, 65536])
def test_sliced_matches_plain_and_jax_at_pool(pools, pages, kind):
    """Each burst, gated and ungated, through the planner's slices (8 of
    4480 or 8192 ids): the release burst returns ids in several slices and
    the stack top straddles a slice boundary."""
    state = pools[pages]
    sched = pool_burst(kind, state)
    plan = plan_burst(sched.capacity, 2, pages)
    assert plan.path == "cluster" and plan.cluster == 8
    for gated in (False, True):
        three_ways(state, sched, 8, plan.slice, gated=gated,
                   ctx=f"{kind} N={pages} gated={gated}")


@pytest.mark.parametrize("kind", ["decode", "release", "all_nop"])
def test_plain_matches_jax_at_card_pool_shape(pools, kind):
    """The plain step against the jitted JAX oracle at Q=512 C=2 N=35840
    R=8 (the release burst at Q=64), carried over the three bursts."""
    state = pools[35840]
    for step in range(2):
        sched = pool_burst(kind, state, seed=20 + step)
        j_out = J_STEP(state, sched, 8)
        t_out = _step_scheduled_torch(to_torch(state, FreeListState),
                                      to_torch(sched, RequestQueue), 8)
        assert_same(j_out, t_out, f"{kind} step {step}")
        state = j_out[0]


# --------------------------------------------------------------------------
# the sliced model at a small N with forced slices
# --------------------------------------------------------------------------

def small_state():
    """96 ids, all granted round-robin to lanes 0-3 (4 each, from the top):
    every lane owns ids in each 32-id slice."""
    state = jfl.init_freelist([96, 8])
    sched = jax_sched(np.full(24, OP_MALLOC), np.arange(24) % 4,
                      np.zeros(24), np.full(24, 4))
    return J_STEP(state, sched, 8)[0]


def small_case(case):
    """(state, sched, R) of a directed case."""
    if case == "top_straddles_slices":
        state = jfl.init_freelist([96, 8])
        state = J_STEP(state, jax_sched([OP_MALLOC] * 7, range(7), [0] * 7,
                                        [8] * 7), 8)[0]     # top 96 -> 40
        return state, jax_sched([OP_MALLOC, OP_REFILL, OP_MALLOC_RUN],
                                [7, 8, 9], [0, 0, 0], [8, 5, 3]), 8
    if case == "returns_in_every_slice":
        state = small_state()
        return state, jax_sched(
            [OP_FREE, OP_FREE, OP_FREE, OP_FREE, OP_MALLOC],
            [0, 1, 2, 3, 5], [0, 0, 0, 1, 1],
            [FREE_ALL, FREE_ALL, 50, FREE_ALL, 2]), 4
    state = small_state()
    state = J_STEP(state, jax_sched([OP_FREE] * 3, [0, 1, 2], [0] * 3,
                                    [FREE_ALL] * 3), 8)[0]   # top 72
    top = int(np.asarray(state.free_top)[0])
    extra = {"want_is_top": 0, "want_is_top_plus_1": 1}[case]
    wants = [8] * (top // 8) + ([top % 8] if top % 8 else [])
    wants[-1] += extra
    if wants[-1] > 8:
        wants[-1] -= 1
        wants.append(1)
    n = len(wants)
    return state, jax_sched([OP_MALLOC] * n + [OP_FREE],
                            list(range(n)) + [3], [0] * (n + 1),
                            wants + [FREE_ALL]), 8


@pytest.mark.parametrize("case", ["top_straddles_slices",
                                  "returns_in_every_slice", "want_is_top",
                                  "want_is_top_plus_1"])
@pytest.mark.parametrize("slice_ids", [32, 64, 96])
def test_sliced_small_forced_slices(case, slice_ids):
    state, sched, R = small_case(case)
    for gated in (False, True):
        three_ways(state, sched, R, slice_ids, gated=gated,
                   ctx=f"{case} gated={gated}")


def test_small_cases_hit_their_edges():
    """The directed cases do what their names say."""
    state, sched, R = small_case("top_straddles_slices")
    top = int(np.asarray(state.free_top)[0])
    assert top == 40 and top - 16 < 32 < top      # positions 39..24
    for case, extra in (("want_is_top", 0), ("want_is_top_plus_1", 1)):
        state, sched, R = small_case(case)
        ops, args = np.asarray(sched.op), np.asarray(sched.arg)
        want = args[(ops == OP_MALLOC) & (args <= R)].sum()
        assert want == int(np.asarray(state.free_top)[0]) + extra
    state, sched, R = small_case("returns_in_every_slice")
    new = J_STEP(state, sched, R)[0]
    freed = np.flatnonzero((np.asarray(state.owner)[0] >= 0)
                           & (np.asarray(new.owner)[0] < 0))
    assert {int(b) // 32 for b in freed} == {0, 1, 2}
    assert len(freed) > 32                          # the append straddles


def test_scarce_random_bursts_take_the_slow_path():
    """Random bursts on small scarce pools (the grant's slow path, more
    than 32 requests per class) through several slicings."""
    rng = np.random.RandomState(3)
    R, C, N = 4, 2, 160
    state = jfl.init_freelist([150, 40])
    slow = 0
    for b in range(12):
        Q = int(rng.randint(40, 120))
        ops = rng.choice([OP_MALLOC, OP_REFILL, OP_MALLOC_RUN, OP_FREE,
                          OP_NOP], Q)
        args = np.where(ops == OP_FREE,
                        np.where(rng.rand(Q) < 0.3, FREE_ALL,
                                 rng.randint(0, N + 2, Q)),
                        rng.randint(0, R + 2, Q))
        sched = jax_sched(ops, rng.randint(0, 6, Q), rng.randint(-1, C + 1, Q),
                          args, capacity=120)
        top = np.asarray(state.free_top)
        cls = np.clip(np.asarray(sched.size_class), 0, C - 1)
        is_m = np.isin(np.asarray(sched.op),
                       [OP_MALLOC, OP_REFILL, OP_MALLOC_RUN])
        a = np.asarray(sched.arg)
        want = np.where(is_m & (a > 0) & (a <= R), a, 0)
        slow += sum(int(want[cls == c].sum() > top[c]) for c in range(C))
        for slice_ids in (32, 64):
            out = three_ways(state, sched, R, slice_ids, ctx=f"burst {b}")
        state = out[0]
    assert slow >= 3


@pytest.mark.cuda
def test_kernel_matches_plain_on_card_at_pool_shapes(request):
    """The CUDA kernel on its cluster path (N = 35840, 65536) against the
    plain step on the card, every burst gated and ungated, and two launches
    bit-identical (skips on a host without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    pools = request.getfixturevalue("pools")
    from repro_torch.kernels.support_core.ops import (card_plan,
                                                      support_core_burst)
    dev = torch.device("cuda")
    for pages, jstate in pools.items():
        state = FreeListState(*[t.to(dev) for t in
                                to_torch(jstate, FreeListState)])
        for kind in ("decode", "release", "all_nop"):
            jsched = pool_burst(kind, jstate)
            sched = RequestQueue(*[t.to(dev) for t in
                                   to_torch(jsched, RequestQueue)])
            assert card_plan(sched.capacity, 2, pages).path == "cluster"
            for gated in (False, True):
                a = support_core_burst(state, sched, 8, gated=gated)
                b = _step_scheduled_torch(state, sched, 8, gated=gated)
                again = support_core_burst(state, sched, 8, gated=gated)
                for x, y, z in zip((*a[0], a[1], a[2]), (*b[0], b[1], b[2]),
                                   (*again[0], again[1], again[2])):
                    assert torch.equal(x, y) and torch.equal(x, z)
