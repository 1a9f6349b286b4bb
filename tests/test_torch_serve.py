"""The port's ServingEngine on the CPU against the JAX ServingEngine
(``alloc_backend="jnp"``), on the setup of the JAX package's kernel-backend
engine test: smoke deepseek-7b in f32 with the JAX parameters carried
across, a 2-lane pool of 4-token pages, stash 4/1/2, prompts of 7 and 5
tokens, 6 decode steps, then lane 0 released.

Tokens must be equal at every step; the allocator state, block tables and
stash bit-identical; the invariants must hold; the stash and burst
counters of both engines equal.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_paged_config as j_make_paged_config  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.freelist import FreeListState, validate_freelist  # noqa: E402
from repro_torch.core.paged_kv import validate_paged_kv  # noqa: E402
from repro_torch.models import make_paged_config, params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402

ARCH = "deepseek-7b"
STASH = dict(stash_size=4, stash_watermark=1, stash_refill=2)


@pytest.fixture(scope="module")
def engines():
    jcfg, cfg = j_smoke_config(ARCH), smoke_config(ARCH)
    jparams = j_init_params(jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    jkv = j_make_paged_config(jcfg, seq_len=48, lanes=2, page_size=4,
                              dtype=jnp.float32, **STASH)
    tkv = make_paged_config(cfg, seq_len=48, lanes=2, page_size=4,
                            dtype=torch.float32, **STASH)
    assert (tkv.num_pages, tkv.max_pages_per_lane, tkv.scratch_slots) == \
        (jkv.num_pages, jkv.max_pages_per_lane, jkv.scratch_slots)
    jeng = JEngine(jcfg, jkv, jparams, dtype=jnp.float32, alloc_backend="jnp")
    teng = ServingEngine(cfg, tkv, tparams, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (7, 5)]
    for lane, p in enumerate(prompts):
        assert jeng.admit(lane, p)
        assert teng.admit(lane, p)
    np.testing.assert_array_equal(teng.state.tokens.numpy(),
                                  np.asarray(jeng.state.tokens))
    steps = [(np.asarray(jeng.step()), teng.step()) for _ in range(6)]
    jeng.release([0])
    teng.release([0])
    return jeng, teng, steps


def test_tokens_equal_every_step(engines):
    _, _, steps = engines
    for i, (j, t) in enumerate(steps):
        np.testing.assert_array_equal(t, j, err_msg=f"decode step {i}")


def test_allocator_state_bit_identical(engines):
    jeng, teng, _ = engines
    jp, tp = jeng.state.paged, teng.state.paged
    for field in FreeListState._fields:
        np.testing.assert_array_equal(getattr(tp.alloc, field).numpy(),
                                      np.asarray(getattr(jp.alloc, field)),
                                      err_msg=field)
    for field in ("block_tables", "seq_lens", "active", "scratch_slot"):
        np.testing.assert_array_equal(getattr(tp, field).numpy(),
                                      np.asarray(getattr(jp, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(tp.stash.pages.numpy(),
                                  np.asarray(jp.stash.pages))
    np.testing.assert_array_equal(tp.stash.depth.numpy(),
                                  np.asarray(jp.stash.depth))


def test_kv_pages_match(engines):
    """The pages the allocator handed out hold the same K/V on both sides
    (f32, rtol = atol = 2e-4: the prefill and decode sums run in another
    order).  The port's pool has one sink page past the end."""
    jeng, teng, _ = engines
    jp, tp = jeng.state.paged, teng.state.paged
    tbl = tp.block_tables.numpy()
    live = np.unique(tbl[tbl >= 0])
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(getattr(tp, name).numpy()[live],
                                   np.asarray(getattr(jp, name))[live],
                                   rtol=2e-4, atol=2e-4, err_msg=name)


def test_invariants_hold(engines):
    _, teng, _ = engines
    validate_freelist(teng.state.paged.alloc)
    validate_paged_kv(teng.kvcfg, teng.state.paged, teng.tenants)


def test_engine_counters_equal(engines):
    jeng, teng, _ = engines
    sj, st = jeng.stats, teng.stats
    for f in ("admitted", "completed", "decode_steps", "alloc_failures",
              "hmq_admit_bursts", "hmq_release_bursts", "decode_bursts",
              "stash_hits", "stash_misses", "stash_depth_hist",
              "burst_slots_live", "burst_slots_capacity", "tenants"):
        assert getattr(st, f) == getattr(sj, f), f


@pytest.mark.parametrize("prefilled", [0, 9])
def test_init_serve_state_matches_jax(prefilled):
    """The synthetic pre-admitted decode state (dry-run/benchmark helper)
    carries the JAX package's allocator metadata and block tables."""
    from repro.serve.serve_step import init_serve_state as j_init_serve_state
    from repro_torch.core.paged_kv import paged_tenants
    from repro_torch.serve.serve_step import init_serve_state
    jcfg, cfg = j_smoke_config(ARCH), smoke_config(ARCH)
    jkv = j_make_paged_config(jcfg, seq_len=48, lanes=2, page_size=4,
                              dtype=jnp.float32, **STASH)
    tkv = make_paged_config(cfg, seq_len=48, lanes=2, page_size=4,
                            dtype=torch.float32, **STASH)
    js = j_init_serve_state(jcfg, jkv, 2, prefilled, dtype=jnp.float32)
    ts = init_serve_state(cfg, tkv, 2, paged_tenants(tkv, "cpu"), prefilled)
    for field in FreeListState._fields:
        np.testing.assert_array_equal(getattr(ts.paged.alloc, field).numpy(),
                                      np.asarray(getattr(js.paged.alloc,
                                                         field)),
                                      err_msg=field)
    for field in ("block_tables", "seq_lens", "active"):
        np.testing.assert_array_equal(getattr(ts.paged, field).numpy(),
                                      np.asarray(getattr(js.paged, field)),
                                      err_msg=field)
    validate_freelist(ts.paged.alloc)
