"""The port's support-core step and HMQ schedule against the JAX package.

The same seeded numpy inputs go through ``repro`` (the jnp oracle
``_step_scheduled_jnp``, and the Pallas kernel in interpret mode) and
through ``repro_torch``'s plain step on the CPU.  Allocator metadata,
grants and grant flags must be bit-identical: no tolerance.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import freelist as jfl  # noqa: E402
from repro.core import hmq as jhmq  # noqa: E402
from repro.core import packets as jpk  # noqa: E402
from repro.core.support_core import _step_scheduled_jnp  # noqa: E402
from repro.kernels.support_core.ops import \
    support_core_burst as pallas_burst  # noqa: E402
from repro_torch.core.freelist import (FreeListState, init_freelist,  # noqa: E402
                                       validate_freelist)
from repro_torch.core.hmq import schedule  # noqa: E402
from repro_torch.core.packets import (FREE_ALL, OP_FREE, OP_MALLOC,  # noqa: E402
                                      OP_MALLOC_RUN, OP_NOP, OP_REFILL,
                                      RequestQueue)
from repro_torch.core.support_core import _step_scheduled_torch  # noqa: E402
from repro_torch.kernels.support_core.ops import support_core_burst  # noqa: E402


#: the jnp oracle, jitted so each (shape, R) traces once per test
J_STEP = jax.jit(_step_scheduled_jnp, static_argnums=(2,))


def pallas_step(state, sched, R):
    return pallas_burst(state, sched, max_blocks_per_req=R, interpret=True)


#: the two JAX references: the jnp oracle and the Pallas kernel run in
#: interpret mode (which does not grant OP_MALLOC_RUN: its queues carry none)
ORACLES = {"jnp": J_STEP, "pallas": pallas_step}


def to_torch(nt, cls):
    return cls(*[torch.from_numpy(np.array(x)) for x in nt])


def assert_step_equal(j_out, t_out, ctx=""):
    js, jb, jok = j_out
    ts, tb, tok = t_out
    for field in FreeListState._fields:
        np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                      np.asarray(getattr(js, field)),
                                      err_msg=f"{ctx}: {field}")
        assert getattr(ts, field).dtype == torch.int32, field
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb), err_msg=ctx)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok), err_msg=ctx)


def jax_sched(ops, lanes, classes, args, capacity=None):
    q = jpk.make_queue(*[np.asarray(x, np.int32)
                         for x in (ops, lanes, classes, args)],
                       capacity=capacity)
    sched, _ = jhmq.schedule(q)
    return sched


def mixed_queue(rng, Q, C, N, R, run_ops=True):
    pool = [OP_MALLOC, OP_REFILL, OP_FREE, OP_FREE, OP_NOP]
    if run_ops:
        pool.append(OP_MALLOC_RUN)
    ops = rng.choice(pool, Q)
    args = np.where(ops == OP_FREE,
                    np.where(rng.rand(Q) < 0.5, FREE_ALL,
                             rng.randint(0, N + 2, Q)),
                    rng.randint(0, R + 2, Q))            # incl. 0 and overwide
    return ops, rng.randint(0, 8, Q), rng.randint(-1, C + 1, Q), args


def warm_state(rng, Q, C, N, R, scarce):
    caps = [int(c) for c in (rng.randint(2, max(3, N // 4), C) if scarce
                             else rng.randint(N // 2, N + 1, C))]
    state = jfl.init_freelist(caps)
    warm = jax_sched(np.full(Q, OP_MALLOC), rng.randint(0, 8, Q),
                     rng.randint(0, C, Q), rng.randint(1, R + 1, Q))
    state, _, _ = J_STEP(state, warm, R)
    return state


SWEEP = [(16, 2, 32, 4, False), (64, 4, 128, 8, False), (32, 3, 16, 4, True)]


@pytest.mark.parametrize("Q,C,N,R,scarce", SWEEP)
def test_step_matches_jnp_oracle(Q, C, N, R, scarce):
    """Plain torch step == ``_step_scheduled_jnp`` bit for bit, OP_MALLOC_RUN
    and out-of-range size classes included, over three carried bursts."""
    rng = np.random.RandomState(Q + C)
    jstate = warm_state(rng, Q, C, N, R, scarce)
    tstate = to_torch(jstate, FreeListState)
    for b in range(3):
        sched = jax_sched(*mixed_queue(rng, Q, C, N, R))
        j_out = J_STEP(jstate, sched, R)
        t_out = _step_scheduled_torch(tstate, to_torch(sched, RequestQueue), R)
        assert_step_equal(j_out, t_out, ctx=f"burst {b}")
        jstate, tstate = j_out[0], t_out[0]
        validate_freelist(tstate)


@pytest.mark.parametrize("Q,C,N,R,scarce", SWEEP)
def test_step_matches_pallas_interpret(Q, C, N, R, scarce):
    """Plain torch step == the Pallas kernel (interpret mode).  The Pallas
    kernel does not grant OP_MALLOC_RUN (the JAX builder lowers it), so
    these queues carry none."""
    rng = np.random.RandomState(100 + Q)
    jstate = warm_state(rng, Q, C, N, R, scarce)
    sched = jax_sched(*mixed_queue(rng, Q, C, N, R, run_ops=False))
    j_out = pallas_step(jstate, sched, R)
    t_out = _step_scheduled_torch(to_torch(jstate, FreeListState),
                                  to_torch(sched, RequestQueue), R)
    assert_step_equal(j_out, t_out)


DIRECTED = {
    # exhaust class 0, overwide lane, same-step FREE_ALL; double free, free
    # of an unowned id, FREE_ALL of an empty lane; cross-class FREE_ALL;
    # refill loses to a plain malloc under scarcity
    "free_all_double_free_refill": ([3, 2], 3, [
        [(OP_MALLOC, 0, 0, 2), (OP_MALLOC, 1, 0, 4), (OP_MALLOC, 2, 0, 2),
         (OP_FREE, 0, 0, FREE_ALL)],
        [(OP_FREE, 0, 0, 2), (OP_FREE, 0, 0, 2), (OP_FREE, 3, 0, 1),
         (OP_FREE, 4, 1, FREE_ALL)],
        [(OP_MALLOC, 2, 1, 2), (OP_FREE, 2, 0, FREE_ALL),
         (OP_FREE, 2, 1, FREE_ALL)],
        [(OP_REFILL, 1, 0, 3), (OP_MALLOC, 0, 0, 1),
         (OP_FREE, 1, 0, FREE_ALL)],
    ]),
    # drain, overdraw, free everything in one step, refill the full stack
    "full_stack": ([4, 6], 4, [
        [(OP_MALLOC, 0, 0, 2), (OP_MALLOC, 1, 0, 2),
         (OP_MALLOC, 0, 1, 3), (OP_MALLOC, 1, 1, 3)],
        [(OP_MALLOC, 2, 0, 1), (OP_MALLOC, 2, 1, 1)],
        [(OP_FREE, 0, 0, FREE_ALL), (OP_FREE, 1, 0, FREE_ALL),
         (OP_FREE, 0, 1, FREE_ALL), (OP_FREE, 1, 1, FREE_ALL)],
        [(OP_MALLOC, 3, 0, 4), (OP_MALLOC, 3, 1, 4)],
    ]),
    # R wider than the class: grants fail rather than go partial
    "overwide": ([2], 8, [[(OP_MALLOC, 0, 0, 2), (OP_MALLOC, 1, 0, 8)],
                          [(OP_FREE, 0, 0, FREE_ALL)],
                          [(OP_MALLOC, 1, 0, 2)]]),
    # malloc with arg <= 0 fails; MALLOC_RUN is granted like a malloc;
    # a block granted in a burst is freed in the same burst
    "zero_want_and_runs": ([5], 3, [
        [(OP_MALLOC, 0, 0, 0), (OP_MALLOC, 1, 0, -3),
         (OP_MALLOC_RUN, 2, 0, 3), (OP_FREE, 2, 0, FREE_ALL)],
        [(OP_MALLOC_RUN, 1, 0, 2), (OP_FREE, 1, 0, 4), (OP_FREE, 1, 0, 4)],
    ]),
}


def _has_runs(name):
    return any(r[0] == OP_MALLOC_RUN for reqs in DIRECTED[name][2]
               for r in reqs)


@pytest.mark.parametrize("name,oracle", [
    (name, oracle) for name in sorted(DIRECTED) for oracle in sorted(ORACLES)
    if not (oracle == "pallas" and _has_runs(name))])
def test_step_matches_jax_directed(name, oracle):
    caps, R, steps = DIRECTED[name]
    jstate = jfl.init_freelist(caps)
    tstate = init_freelist(caps)
    for b, reqs in enumerate(steps):
        sched = jax_sched(*zip(*reqs), capacity=6)
        j_out = ORACLES[oracle](jstate, sched, R)
        t_out = _step_scheduled_torch(tstate, to_torch(sched, RequestQueue), R)
        assert_step_equal(j_out, t_out, ctx=f"{name} step {b}")
        jstate, tstate = j_out[0], t_out[0]
        validate_freelist(tstate)


@pytest.mark.parametrize("oracle", sorted(ORACLES))
def test_step_matches_jax_20_burst_trace(oracle):
    """Twenty bursts with state carried on both sides, gated bursts among
    them (an all-NOP gated burst must leave even ``peak_used`` alone)."""
    rng = np.random.RandomState(20)
    caps, R = [24, 6, 11], 4
    jstate = jfl.init_freelist(caps)
    tstate = init_freelist(caps)
    for b in range(20):
        Q = int(rng.randint(4, 24))
        ops, lanes, classes, args = mixed_queue(rng, Q, len(caps), 24, R,
                                                run_ops=oracle == "jnp")
        if b % 7 == 6:
            ops = np.zeros_like(ops)
        sched = jax_sched(ops, lanes, classes, args, capacity=24)
        j_out = ORACLES[oracle](jstate, sched, R)
        gated = b % 2 == 0
        t_out = _step_scheduled_torch(tstate, to_torch(sched, RequestQueue), R,
                                      gated=gated)
        if gated and not ops.any():
            j_out = (j_out[0]._replace(peak_used=jstate.peak_used),) + j_out[1:]
        assert_step_equal(j_out, t_out, ctx=f"burst {b}")
        jstate, tstate = j_out[0], t_out[0]
        validate_freelist(tstate)


@pytest.mark.parametrize("lane_hi", [8, 2**20, 2**27, 2**30])
def test_schedule_permutation_matches_jax(lane_hi):
    """Same scheduled queue and unpermutation as ``repro.core.hmq``; lane
    ids up to 2**30 lie far beyond ``max_safe_lanes`` (where JAX switches to
    its lexicographic sort) and the int64 key still agrees."""
    rng = np.random.RandomState(lane_hi % 1000)
    for Q in (1, 7, 33, 64):
        ops = rng.choice([OP_MALLOC, OP_REFILL, OP_FREE, OP_NOP,
                          OP_MALLOC_RUN], Q)
        lanes = rng.randint(0, lane_hi, Q)
        lanes[rng.rand(Q) < 0.3] = lanes[0]          # repeated lanes -> rounds
        lanes[-1] = lane_hi - 1
        classes = rng.randint(0, 3, Q)
        args = rng.randint(-1, 5, Q)
        jq = jpk.RequestQueue(*[jnp.asarray(np.asarray(x, np.int32))
                                for x in (ops, lanes, classes, args)])
        j_sched, j_unperm = jhmq.schedule(jq)
        t_sched, t_unperm = schedule(to_torch(jq, RequestQueue))
        for a, b in zip(j_sched, t_sched):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(t_unperm.numpy(), np.asarray(j_unperm))
    if lane_hi >= 2**27:       # the 64-slot queue took JAX's lexsort branch
        assert lane_hi - 1 > jhmq.max_safe_lanes(64)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card (skips on a
    host without one; ``chip_smoke.py`` runs the full comparison)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.RandomState(7)
    for Q, C, N, R, scarce in SWEEP:
        jstate = warm_state(rng, Q, C, N, R, scarce)
        state = FreeListState(*[t.to(dev) for t in
                                to_torch(jstate, FreeListState)])
        for gated in (False, True):
            ops, lanes, classes, args = mixed_queue(rng, Q, C, N, R)
            q = RequestQueue(*[torch.as_tensor(np.asarray(x, np.int32),
                                               device=dev)
                               for x in (ops, lanes, classes, args)])
            sched, _ = schedule(q)
            a = support_core_burst(state, sched, R, gated=gated)
            b = _step_scheduled_torch(state, sched, R, gated=gated)
            for x, y in zip((*a[0], a[1], a[2]), (*b[0], b[1], b[2])):
                assert torch.equal(x, y)
            state = a[0]
