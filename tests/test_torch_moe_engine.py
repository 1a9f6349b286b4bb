"""Serving the moe family in the port against the JAX package's engine,
on the CPU: smoke mixtral-8x7b (sliding window of 64, 4 experts top-2)
and phi3.5-moe (full attention) in f32 with the JAX parameters carried
across.  One engine, prompts crossing mixtral's window: tokens equal at
every step; after every step the allocator state, block tables (with the
recycled holes) and stash bit-identical; invariants hold; nothing in use
after the release.  With the stash on the recycled pages feed it; off,
every recycle is a single free on the step's burst.
``tests/test_torch_moe_multi.py`` holds two shards, and
``tests/test_torch_swa_cache.py`` the prefix cache under the window.
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
from repro_torch.core.freelist import FreeListState  # noqa: E402
from repro_torch.core.packets import NO_BLOCK  # noqa: E402
from repro_torch.core.paged_kv import validate_paged_kv  # noqa: E402
from repro_torch.models import make_paged_config, params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402

MIXTRAL, PHI = "mixtral-8x7b", "phi3.5-moe-42b-a6.6b"


@pytest.fixture(scope="module", params=[MIXTRAL, PHI])
def models(request):
    arch = request.param
    jcfg, cfg = j_smoke_config(arch), smoke_config(arch)
    jparams = j_init_params(jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    return jcfg, cfg, jparams, tparams


def _alloc_diff(t_alloc, j_alloc) -> list[str]:
    return [f for f in FreeListState._fields
            if not np.array_equal(getattr(t_alloc, f).numpy(),
                                  np.asarray(getattr(j_alloc, f)))]


def _paged_equal(tp, jp, ctx: str) -> None:
    assert not _alloc_diff(tp.alloc, jp.alloc), ctx
    for f in ("block_tables", "seq_lens", "active", "scratch_slot"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)),
                                      err_msg=f"{ctx}: {f}")
    np.testing.assert_array_equal(tp.stash.pages.numpy(),
                                  np.asarray(jp.stash.pages), err_msg=ctx)


@pytest.mark.parametrize("stash", [dict(stash_size=4, stash_watermark=1,
                                        stash_refill=2),
                                   dict(stash_size=0)])
def test_engine_matches_jax_engine(models, stash):
    """Prompts of 70 and 90 tokens, 16 decode steps, both lanes released:
    under mixtral's window of 64 each lane recycles pages and its table
    holds holes."""
    jcfg, cfg, jparams, tparams = models
    jkv = j_make_paged_config(jcfg, seq_len=128, lanes=2, page_size=8,
                              dtype=jnp.float32, **stash)
    tkv = make_paged_config(cfg, seq_len=128, lanes=2, page_size=8,
                            dtype=torch.float32, **stash)
    jeng = JEngine(jcfg, jkv, jparams, dtype=jnp.float32, alloc_backend="jnp")
    teng = ServingEngine(cfg, tkv, tparams, device="cpu")
    assert teng.window == jeng.window == cfg.window
    rng = np.random.RandomState(1)
    for lane, n in enumerate((70, 90)):
        p = rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
        assert jeng.admit(lane, p) and teng.admit(lane, p)
    np.testing.assert_array_equal(teng.state.tokens.numpy(),
                                  np.asarray(jeng.state.tokens))
    for i in range(16):
        np.testing.assert_array_equal(teng.step(), np.asarray(jeng.step()),
                                      err_msg=f"decode step {i}")
        _paged_equal(teng.state.paged, jeng.state.paged, f"step {i}")
        validate_paged_kv(tkv, teng.state.paged, teng.tenants)
    # mixtral: lane 0 (at 86 tokens) recycled pages 0-1; lane 1's 90-token
    # prompt exceeds window + 2 pages, so its pages 0-1 stay mapped (the
    # reference recycles the newest dead page only); at 106 tokens pages
    # 2-4 are holes
    tbl = teng.state.paged.block_tables.numpy()
    holes = [list(np.flatnonzero(row[:6] == NO_BLOCK)) for row in tbl]
    assert holes == ([[0, 1], [2, 3, 4]] if cfg.window else [[], []])
    jeng.release([0, 1])
    teng.release([0, 1])
    _paged_equal(teng.state.paged, jeng.state.paged, "release")
    assert teng.live_pages == 0
    for f in ("decode_steps", "hmq_admit_bursts", "hmq_release_bursts",
              "decode_bursts", "stash_hits", "stash_misses",
              "stash_depth_hist", "burst_slots_live",
              "burst_slots_capacity", "tenants"):
        assert getattr(teng.stats, f) == getattr(jeng.stats, f), f

