"""Two engine shards of the hybrid family on one support core, in the port
on the CPU, against the JAX package's ``MultiEngine``
(``alloc_backend="jnp"``): ``smoke_config("zamba2-1.2b")`` in f32 with the
JAX parameters carried across, 2 lanes a shard, 4-token pages, burst
windows of 2 steps, preemption on.

Four requests fill both shards; a priority-3 request then preempts a
running lane, which resumes by re-prefilling its prompt and output at
their exact length.  Both deployments step window by window: the one
shared allocator state (six classes: each shard's ``kv_pages``,
``state_slots`` and ``scratch``) must be bit-identical after every window,
the tokens equal, and the cross-engine rollup equal with nothing in use.
The port's run is recorded: the trace's tenant header follows the
registration order, and its model-free replay ends in the live state.
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
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.freelist import FreeListState  # noqa: E402
from repro_torch.loadgen import (certify_complete, record_service,  # noqa: E402
                                 replay_trace)
from repro_torch.models import make_paged_config, params_from_numpy  # noqa: E402
from repro_torch.serve.multi_engine import MultiEngine  # noqa: E402
from repro_torch.serve.scheduler import Request, make_scheduler_config  # noqa: E402

ARCH = "zamba2-1.2b"


@pytest.fixture(scope="module")
def windows():
    jcfg, cfg = j_smoke_config(ARCH), smoke_config(ARCH)
    jparams = j_init_params(jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    jkv = j_make_paged_config(jcfg, seq_len=64, lanes=2, page_size=4,
                              dtype=jnp.float32)
    tkv = make_paged_config(cfg, seq_len=64, lanes=2, page_size=4,
                            dtype=torch.float32)
    scfg = make_scheduler_config(cfg, tkv, max_prompt_len=32)
    assert scfg.exact_buckets
    me = MultiEngine(cfg, tkv, tparams, n_engines=2, sched_cfg=scfg,
                     quantum=2, preemption=True, device="cpu")
    jme = JMultiEngine(jcfg, jkv, jparams, n_engines=2, dtype=jnp.float32,
                       sched_cfg=scfg, quantum=2, preemption=True,
                       alloc_backend="jnp", alloc_policy="freelist")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, 8).astype(np.int32)
               for _ in range(5)]
    lengths = []                    # every prefill row's length, per shard
    for i, eng in enumerate(me.engines):
        inner = eng._prefill

        def spy(params, batch, inner=inner, i=i):
            lengths.append((i, batch["tokens"].shape[1],
                            batch["lengths"].tolist()))
            return inner(params, batch)
        eng._prefill = spy
    rec = record_service(me.service)
    diffs = []

    def window():
        progress = (me.step_window(validate=True), jme.step_window())
        diffs.append([f for f in FreeListState._fields
                      if not np.array_equal(getattr(me.alloc, f).numpy(),
                                            np.asarray(getattr(jme.alloc,
                                                               f)))])
        return progress

    for m, cls in ((me, Request), (jme, JRequest)):
        m.submit([cls(rid=i, tokens=prompts[i].copy()) for i in range(4)],
                 max_new_tokens=8)
    assert window() == (True, True)
    for m, cls in ((me, Request), (jme, JRequest)):
        m.submit([cls(rid=4, tokens=prompts[4].copy(), priority=3)],
                 max_new_tokens=8)
    while me.has_work or jme.has_work:
        assert window() == (True, True)
        assert len(diffs) < 40
    me.service.recorder = None
    trace = certify_complete(rec.finish(), me.engines,
                             me.stats.window_bursts)
    return me, jme, diffs, lengths, trace


def test_shared_state_bit_identical_after_every_window(windows):
    me, _, diffs, _, _ = windows
    assert len(me.alloc.free_top) == 6          # 2 shards x 3 tenants
    for i, diff in enumerate(diffs):
        assert not diff, f"window {i}: fields {diff} differ from JAX"


def test_tokens_and_preemption_equal_jax(windows):
    me, jme, _, _, _ = windows
    assert me.stats.preemptions == jme.stats.preemptions == 1
    assert any(r.preemptions for r in me.finished)
    out = {r.rid: list(r.output) for r in me.finished}
    assert out == {r.rid: list(r.output) for r in jme.finished}
    assert sorted(out) == list(range(5))
    assert all(len(o) == 8 for o in out.values())


def test_rollup_covers_the_state_tenant(windows):
    me, jme, _, _, _ = windows
    roll = me.tenant_rollup()
    assert roll == jme.tenant_rollup()
    assert sorted(roll) == ["kv_pages", "scratch", "state_slots"]
    # five admissions and one re-admission after the preemption
    assert roll["state_slots"]["alloc_count"] == 6
    for d in roll.values():
        assert d["used"] == 0 and d["alloc_count"] == d["free_count"]


def test_no_prefill_row_is_padded(windows):
    """Every real prefill row fills its batch's length: the resumed request
    prefills prompt + output (8 + its tokens so far) unpadded."""
    _, _, _, lengths, _ = windows
    assert any(T > 8 for _, T, _ in lengths)
    for _, T, rows in lengths:
        assert rows[0] == T


def test_trace_follows_the_class_order_and_replays(windows):
    """The recorded trace names the six tenants in class order (each
    shard's ``kv_pages``, ``state_slots``, ``scratch``), and replaying it
    with no model ends in the live shared state, counters and all."""
    me, _, _, _, trace = windows
    assert [name for name, _ in trace.header["tenants"]] == [
        f"e{i}/{t}" for i in range(2)
        for t in ("kv_pages", "state_slots", "scratch")]
    res = replay_trace(trace, device="cpu")
    for f in FreeListState._fields:
        assert torch.equal(getattr(res.state, f), getattr(me.alloc, f)), f
    assert res.report == me.service.tenant_report(me.alloc)
