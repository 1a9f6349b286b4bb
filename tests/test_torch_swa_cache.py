"""The prefix cache under sliding-window recycling, in the port against
the JAX package's engine, on the CPU: smoke mixtral-8x7b (window 64) in
f32 with the JAX parameters carried across, the cache on.  Alias mode
falls back to copy in both packages (pages recycle in place as the
window slides), and a lane whose block table holds a recycled hole is
not demoted at its release, while a lane short of the window is: the
same cache pages and allocator state in both.
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

MIXTRAL = "mixtral-8x7b"


def _paged_equal(tp, jp, ctx: str) -> None:
    for f in FreeListState._fields:
        np.testing.assert_array_equal(getattr(tp.alloc, f).numpy(),
                                      np.asarray(getattr(jp.alloc, f)),
                                      err_msg=f"{ctx}: alloc.{f}")
    for f in ("block_tables", "seq_lens", "active", "scratch_slot"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)),
                                      err_msg=f"{ctx}: {f}")


def test_recycled_lane_is_not_demoted_and_alias_falls_back_to_copy():
    """mixtral with the prefix cache on and alias mode asked for: both
    packages fall back to copy (pages recycle in place under the window).
    A lane whose table has a recycled hole is not demoted at its release;
    a lane short of the window is: the same cache pages and allocator
    state in both."""
    jcfg, cfg = j_smoke_config(MIXTRAL), smoke_config(MIXTRAL)
    jparams = j_init_params(jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    kw = dict(seq_len=128, lanes=2, page_size=8)
    jkv = j_make_paged_config(jcfg, dtype=jnp.float32, **kw)
    tkv = make_paged_config(cfg, dtype=torch.float32, **kw)
    jeng = JEngine(jcfg, jkv, jparams, dtype=jnp.float32, alloc_backend="jnp",
                   prefix_cache=True, prefix_alias="alias")
    teng = ServingEngine(cfg, tkv, tparams, device="cpu", prefix_cache=True,
                         prefix_alias="alias")
    assert not teng.alias_enabled and not jeng.alias_enabled
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (70, 40)]
    for lane, p in enumerate(prompts):
        assert jeng.admit(lane, p) and teng.admit(lane, p)
    outs = [[int(t)] for t in teng.state.tokens]       # the seeded tokens
    for _ in range(10):
        toks = teng.step()
        np.testing.assert_array_equal(toks, np.asarray(jeng.step()))
        for lane in range(2):
            outs[lane].append(int(toks[lane]))
    tbl = teng.state.paged.block_tables.numpy()
    assert tbl[0, 0] == NO_BLOCK and (tbl[1, :6] >= 0).all()
    # the tokens whose K/V each lane holds: prompt, seed, 9 outputs
    kv_tokens = {lane: np.concatenate([p, outs[lane][:-1]]).astype(np.int32)
                 for lane, p in enumerate(prompts)}
    jeng.release([0, 1], kv_tokens=kv_tokens)
    teng.release([0, 1], kv_tokens=kv_tokens)
    assert teng.cache.pages == jeng.cache.pages == 6   # lane 1's full pages
    np.testing.assert_array_equal(teng.cache.blocks(), jeng.cache.blocks())
    _paged_equal(teng.state.paged, jeng.state.paged, "release")
    validate_paged_kv(tkv, teng.state.paged, teng.tenants, cache=teng.cache)
