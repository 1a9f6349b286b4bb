"""The port's KV compaction (``repro_torch.core.paged_kv.compact_kv``,
``ServingEngine.compact``) and extent telemetry against the JAX package,
on the CPU.

* ``compact_kv`` on one state -- built through the port's library surface
  and carried over to JAX array for array -- must make the JAX package's
  moves: the same count, block tables, allocator rows and payload, with
  ``max_moves`` truncation, and leave aliased pages, cache residents,
  stash pages and the sink page where they are.
* ``extent_stats`` equals the JAX count on the same block tables.
* Smoke deepseek-7b engines (f32, the JAX parameters carried across),
  compacted mid-serve under ``freelist`` and ``buddy``: tokens equal to
  the JAX engine's at every step, the allocator state, block tables and
  stash bit-identical after the pass, the same pages moved.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.alloc.policies import BuddyPolicy as JBuddyPolicy  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.core import paged_kv as jpkv  # noqa: E402
from repro.core.freelist import FreeListState as JState  # noqa: E402
from repro.core.lane_stash import LaneStashState as JStash  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_paged_config as j_make_paged_config  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import paged_kv as pkv  # noqa: E402
from repro_torch.core.freelist import FreeListState, validate_freelist  # noqa: E402
from repro_torch.models import make_paged_config, params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402

ARCH = "deepseek-7b"
STASH = dict(stash_size=4, stash_watermark=1, stash_refill=2)


def configs(lanes=4, seq_len=48):
    jcfg, cfg = j_smoke_config(ARCH), smoke_config(ARCH)
    jkv = j_make_paged_config(jcfg, seq_len=seq_len, lanes=lanes, page_size=4,
                              dtype=jnp.float32, **STASH)
    tkv = make_paged_config(cfg, seq_len=seq_len, lanes=lanes, page_size=4,
                            dtype=torch.float32, **STASH)
    assert (tkv.num_pages, tkv.max_pages_per_lane, tkv.scratch_slots) == \
        (jkv.num_pages, jkv.max_pages_per_lane, jkv.scratch_slots)
    return jcfg, cfg, jkv, tkv


def fragmented_state(policy: str):
    """Four lanes admitted, lanes 0 and 1 released (holes low in the id
    space), lane 0 re-admitted over an aliased two-page prefix of lane 2
    (refcount 2), and lane 3's first page demoted to ``CACHE_OWNER``; the
    stash holds each lane's pre-charge."""
    _, cfg, _, tkv = configs()
    tenants = pkv.paged_tenants(tkv, "cpu", policy=policy)
    state = pkv.init_paged_kv(tkv, tenants)
    rng = np.random.RandomState(0)
    L, kvh, hd = tkv.num_kv_layers, tkv.kv_heads, tkv.head_dim

    def kv(b, t):
        return torch.from_numpy(rng.randn(b, L, t, kvh, hd)
                                .astype(np.float32))

    state, _ = pkv.admit_prefill_many(
        tkv, state, torch.arange(4, dtype=torch.int32), kv(4, 16), kv(4, 16),
        torch.tensor([9, 14, 11, 16], dtype=torch.int32), tenants)
    state, _ = pkv.release_packets(
        tkv, state, torch.tensor([0, 1, -1, -1], dtype=torch.int32), tenants)
    tbl = state.block_tables.numpy()
    state, _ = pkv.admit_prefill_many(
        tkv, state, torch.tensor([0], dtype=torch.int32), kv(1, 8), kv(1, 8),
        torch.tensor([7], dtype=torch.int32), tenants,
        prefix_blocks=torch.from_numpy(tbl[2:3, :2].copy()),
        prefix_lens=torch.tensor([8], dtype=torch.int32))
    alloc = tenants.service.retag_blocks(state.alloc, tenants.kv,
                                         [int(tbl[3, 0])], pkv.CACHE_OWNER)
    state = state._replace(alloc=alloc)
    validate_freelist(state.alloc)
    return tkv, tenants, state


def to_jax(tkv, state):
    """The port's paged state as the JAX package's (no sink page, no
    recurrent-state tenant)."""
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


def assert_paged_equal(t, j, ctx, payload=True):
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
    if payload:
        n = j.k_pages.shape[0]
        for name in ("k_pages", "v_pages"):
            np.testing.assert_array_equal(getattr(t, name).numpy()[:n],
                                          np.asarray(getattr(j, name)),
                                          err_msg=f"{ctx}: {name}")


@pytest.mark.parametrize("max_moves", [None, 5, 3])
@pytest.mark.parametrize("policy", ["freelist", "bitmap", "buddy"])
def test_compact_kv_matches_jax(policy, max_moves):
    """The full pass moves 4 pages here; a cap of 3 would leave the free
    space no more coalesced, so both packages skip it."""
    tkv, tenants, state = fragmented_state(policy)
    jstate = to_jax(tkv, state)
    jkvcfg = configs()[2]
    owner0 = state.alloc.owner[0].clone()
    refc0 = state.alloc.refcount[0].clone()
    stash0 = state.stash.pages.clone()
    sink = (state.k_pages[-1].clone(), state.v_pages[-1].clone())
    want, j_moved = jpkv.compact_kv(jkvcfg, jstate, max_moves=max_moves)
    got, moved = pkv.compact_kv(tkv, state, tenants, max_moves=max_moves)
    assert moved == j_moved
    # a truncated plan that would not coalesce the free space is a no-op
    assert moved > 0 if max_moves is None else moved <= max_moves
    assert_paged_equal(got, want, f"{policy} max_moves={max_moves}")
    # what never moves: aliased pages, cache residents, stash pages, sink
    owner = owner0.numpy()
    fixed = np.flatnonzero((refc0.numpy() >= 2)
                           | (owner == pkv.CACHE_OWNER))
    assert fixed.size >= 3
    np.testing.assert_array_equal(got.alloc.owner[0].numpy()[fixed],
                                  owner[fixed])
    np.testing.assert_array_equal(got.alloc.refcount[0].numpy()[fixed],
                                  refc0.numpy()[fixed])
    assert torch.equal(got.stash.pages, stash0)
    assert torch.equal(got.k_pages[-1], sink[0])
    assert torch.equal(got.v_pages[-1], sink[1])
    for field in ("free_top", "used", "alloc_count", "free_count"):
        assert torch.equal(getattr(got.alloc, field),
                           getattr(state.alloc, field))
    validate_freelist(got.alloc)


def test_compact_kv_noop_on_packed_state():
    tkv, tenants, state = fragmented_state("buddy")
    state, moved = pkv.compact_kv(tkv, state, tenants)
    assert moved > 0
    again, moved = pkv.compact_kv(tkv, state, tenants)
    assert moved == 0 and again is state
    want, j_moved = jpkv.compact_kv(configs()[2], to_jax(tkv, state))
    assert j_moved == 0


def test_extent_stats_matches_jax():
    rng = np.random.RandomState(3)
    for _ in range(20):
        tbl = np.full((5, 9), -1, np.int32)
        for lane in range(5):
            n = rng.randint(0, 10)
            start = rng.randint(0, 40)
            row = start + np.cumsum(rng.choice([1, 1, 1, 2, 5], n)) - 1
            tbl[lane, :n] = row
        lanes = rng.choice(5, rng.randint(1, 6), replace=False)
        for sel in (None, lanes):
            assert pkv.extent_stats(torch.from_numpy(tbl), sel) == \
                jpkv.extent_stats(jnp.asarray(tbl), sel)
    assert pkv.extent_stats(torch.tensor([[4, 5, 6, -1], [9, 3, 4, -1]])) \
        == (3, 6)


@pytest.fixture(scope="module")
def params():
    jcfg, cfg = j_smoke_config(ARCH), smoke_config(ARCH)
    jparams = j_init_params(jcfg, dtype=jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      cfg, device="cpu")


@pytest.mark.parametrize("policy", ["freelist", "buddy"])
def test_engine_compacted_mid_serve_matches_jax(params, policy, monkeypatch):
    jparams, tparams = params
    # the JAX engine admits and releases eagerly, where the buddy body's
    # lax.scan compiles op by op; jit the body (the same function)
    pol, step = JBuddyPolicy(), JBuddyPolicy.step_scheduled
    body = jax.jit(lambda st, q, r: step(pol, st, q, r, "jnp"),
                   static_argnums=2)
    monkeypatch.setattr(JBuddyPolicy, "step_scheduled",
                        lambda self, st, q, r, backend: body(st, q, r))
    jcfg, cfg, jkv, tkv = configs()
    jeng = JEngine(jcfg, jkv, jparams, dtype=jnp.float32,
                   alloc_backend="jnp", alloc_policy=policy)
    teng = ServingEngine(cfg, tkv, tparams, device="cpu", alloc_policy=policy)
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 14, 6, 11, 7, 13)]
    for lane in range(4):
        assert jeng.admit(lane, prompts[lane])
        assert teng.admit(lane, prompts[lane])

    def steps(n):
        for i in range(n):
            np.testing.assert_array_equal(teng.step(),
                                          np.asarray(jeng.step()),
                                          err_msg=f"{policy} step {i}")

    steps(3)
    jeng.release([0, 1])
    teng.release([0, 1])
    frag0 = teng.fragmentation_report()
    assert frag0 == jeng.fragmentation_report()
    moved = teng.compact()
    assert moved == jeng.compact() > 0
    assert_paged_equal(teng.state.paged, jeng.state.paged,
                       f"{policy} after compaction", payload=False)
    frag1 = teng.fragmentation_report()
    assert frag1 == jeng.fragmentation_report()
    kv = teng.tenants.kv.name
    def score(f):                 # what the pass maximises
        return f["largest_free_run"], -f["free_extents"]
    assert score(frag1[kv]) > score(frag0[kv])
    pkv.validate_paged_kv(teng.kvcfg, teng.state.paged, teng.tenants)
    steps(2)
    for lane, p in ((0, prompts[4]), (1, prompts[5])):
        assert jeng.admit(lane, p) and teng.admit(lane, p)
    steps(4)
    for f in ("compactions", "compaction_moves", "contiguous_extents",
              "extent_pages"):
        assert getattr(teng.stats, f) == getattr(jeng.stats, f), f
    assert teng.stats.mean_run_len == jeng.stats.mean_run_len
    if policy == "buddy":
        assert teng.stats.mean_run_len > 1
