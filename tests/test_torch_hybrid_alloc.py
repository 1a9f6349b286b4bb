"""The hybrid family's allocator path in the port, on the CPU, against the
JAX package: ``smoke_config("zamba2-1.2b")`` in f32 with the JAX
parameters carried across, prompts from ``RandomState`` seeds.

* A failed state-slot admission: the lane whose packets fail holds
  nothing in any tenant after the burst and the engine's reclaiming
  release; the allocator state is bit-identical to JAX's.
* The prefix cache stays inert for a recurrent family: no probe hits,
  demotion happens as in JAX, tokens equal the cache-off run's.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_paged_config as j_make_paged_config  # noqa: E402
from repro.serve.engine import AdmissionItem as JItem  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.freelist import FreeListState  # noqa: E402
from repro_torch.core.packets import NO_BLOCK  # noqa: E402
from repro_torch.models import make_paged_config, params_from_numpy  # noqa: E402
from repro_torch.serve.engine import AdmissionItem, ServingEngine  # noqa: E402

ARCH = "zamba2-1.2b"
PAGED = dict(seq_len=48, lanes=2, page_size=4)


@pytest.fixture(scope="module")
def smoke():
    jcfg, cfg = j_smoke_config(ARCH), smoke_config(ARCH)
    jparams = j_init_params(jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    return jcfg, cfg, jparams, tparams


def _paged_diff(tp, jp) -> list[str]:
    out = [f for f in FreeListState._fields
           if not np.array_equal(getattr(tp.alloc, f).numpy(),
                                 np.asarray(getattr(jp.alloc, f)))]
    for f in ("block_tables", "seq_lens", "active", "state_slot",
              "scratch_slot"):
        if not np.array_equal(getattr(tp, f).numpy(),
                              np.asarray(getattr(jp, f))):
            out.append(f)
    return out


@pytest.mark.parametrize("short", ["all", "state_slots"])
def test_failed_state_slot_admission_leaves_nothing_granted(smoke, short):
    """Three lanes admitted in one burst with a tenant short by one:
    ``all`` gives KV pages (stash off, one page a prompt), state slots and
    scratch two places each; ``state_slots`` only the state slots, so the
    last lane is granted its KV pages and scratch while its state-slot
    packet fails.  Either way that lane fails, and after the engine's
    reclaiming release it holds nothing in any tenant; the allocator state
    is bit-identical to JAX's."""
    jcfg, cfg, jparams, tparams = smoke
    lanes = 3
    short_kv = dict(num_pages=lanes - 1, scratch_slots=lanes - 1) \
        if short == "all" else {}
    cfgs = []
    for mk, c, dt in ((j_make_paged_config, jcfg, jnp.float32),
                      (make_paged_config, cfg, torch.float32)):
        kv = mk(c, seq_len=16, lanes=lanes, page_size=4, dtype=dt,
                stash_size=0)
        cfgs.append(dataclasses.replace(kv, state_slots=lanes - 1,
                                        **short_kv))
    jeng = JEngine(jcfg, cfgs[0], jparams, dtype=jnp.float32,
                   alloc_backend="jnp")
    teng = ServingEngine(cfg, cfgs[1], tparams, device="cpu")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, 3).astype(np.int32)
               for _ in range(lanes)]
    jfail = jeng.admit_many([JItem(i, p) for i, p in enumerate(prompts)])
    tfail = teng.admit_many([AdmissionItem(i, p)
                             for i, p in enumerate(prompts)])
    assert tfail == jfail == [lanes - 1]
    assert not _paged_diff(teng.state.paged, jeng.state.paged)
    alloc = teng.state.paged.alloc
    assert not (alloc.owner == lanes - 1).any()      # no tenant, no block
    assert alloc.used.tolist()[:3] == [lanes - 1] * 3
    paged = teng.state.paged
    assert paged.state_slot[lanes - 1] == NO_BLOCK
    assert paged.scratch_slot[lanes - 1] == NO_BLOCK
    assert not paged.active[lanes - 1]
    assert teng.stats.alloc_failures == jeng.stats.alloc_failures > 0
    np.testing.assert_array_equal(teng.step(), np.asarray(jeng.step()))
    assert not _paged_diff(teng.state.paged, jeng.state.paged)


def test_prefix_cache_stays_inert_for_the_hybrid(smoke):
    """With the cache on, a recurrent family never hits: the probe is 0,
    two completed prompts' pages are demoted all the same (as in JAX), and
    a third prompt opening with their shared prefix prefills in full.
    Tokens equal the cache-off port's and the JAX cache-on engine's; the
    allocator state is bit-identical to JAX's after every operation."""
    jcfg, cfg, jparams, tparams = smoke
    jkv = j_make_paged_config(jcfg, dtype=jnp.float32, **PAGED)
    tkv = make_paged_config(cfg, dtype=torch.float32, **PAGED)
    jeng = JEngine(jcfg, jkv, jparams, dtype=jnp.float32,
                   alloc_backend="jnp", prefix_cache=True)
    teng = ServingEngine(cfg, tkv, tparams, device="cpu", prefix_cache=True)
    off = ServingEngine(cfg, tkv, tparams, device="cpu")
    rng = np.random.RandomState(3)
    head = rng.randint(0, cfg.vocab_size, 8)
    prompts = [np.concatenate([head, rng.randint(0, cfg.vocab_size, 4)])
               .astype(np.int32) for _ in range(3)]
    outs: dict = {id(e): [[], []] for e in (jeng, teng, off)}
    for e in (jeng, teng, off):
        assert e.admit(0, prompts[0]) and e.admit(1, prompts[1])
    assert not _paged_diff(teng.state.paged, jeng.state.paged)
    for _ in range(5):
        for e in (jeng, teng, off):
            t = np.asarray(e.step())
            for lane in (0, 1):
                outs[id(e)][lane].append(int(t[lane]))
        assert not _paged_diff(teng.state.paged, jeng.state.paged)
    kv_tokens = {lane: np.concatenate([prompts[lane],
                                       outs[id(teng)][lane][:-1]])
                 for lane in (0, 1)}
    for e in (jeng, teng, off):
        e.release([0, 1], kv_tokens=kv_tokens)
    assert teng.cache.pages > 0 and teng.cache.pages == jeng.cache.pages
    assert not _paged_diff(teng.state.paged, jeng.state.paged)

    class Req:
        tokens = prompts[2]
    assert teng.cache_probe(Req) == jeng.cache_probe(Req) == 0
    for e in (jeng, teng, off):
        assert e.admit(0, prompts[2])
    steps = [[np.asarray(e.step()) for e in (jeng, teng, off)]
             for _ in range(3)]
    for j, t, o in steps:
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[0], o[0])
    assert outs[id(teng)] == outs[id(jeng)] == outs[id(off)]
    assert teng.stats.cache_hits == jeng.stats.cache_hits == 0
    assert teng.stats.prefill_tokens_saved == 0
    assert not _paged_diff(teng.state.paged, jeng.state.paged)
