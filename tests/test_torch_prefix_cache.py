"""The port's prefix cache, its eviction policies, copy and alias hit
admission, and flash prefill over a cached prefix, on the CPU against the
JAX package.

* ``PrefixCache`` under LRU, 2Q and ARC: one random trace of inserts,
  probes, alias pins and evictions through both packages gives the same
  answers, counters and event trace.
* The alias splice at the paged-KV layer and two engine shards serving a
  shared-prefix mix with the cache on (copy mode and alias mode): tokens,
  block tables, stashes, the shared ``FreeListState`` (refcounts included)
  and the cache counters equal the JAX package's after every window, and
  the tokens equal the cache-off run's.
* I5 refuses a leaked demotion and I6 a leaked alias bump; gemma3-1b
  (windowed) falls back to copy mode.
* Attention with a query offset: the plain versions within 2e-5 of JAX's
  ``mea_attention(q_offset=)`` and the model's forward over a cached
  prefix within 2e-4 of JAX's; the CUDA kernel against its plain version
  on the card (``cuda`` marker).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.paged_kv as jpkv  # noqa: E402
from repro.alloc.eviction import get_eviction as j_get_eviction  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_paged_config as j_make_paged_config  # noqa: E402
from repro.models.attention import mea_attention as j_mea  # noqa: E402
from repro.models.transformer import forward as j_forward  # noqa: E402
from repro.serve.multi_engine import MultiEngine as JMultiEngine  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
import repro_torch.core.paged_kv as pkv  # noqa: E402
from repro_torch.alloc.eviction import (EVICTION_POLICIES,  # noqa: E402
                                        get_eviction)
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.freelist import (FreeListState,  # noqa: E402
                                       FreelistInvariantError)
from repro_torch.core.paged_kv import (CACHE_OWNER, PagedKVConfig,  # noqa: E402
                                       PrefixCache)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    FLASH_KERNEL, flash_attention_op)
from repro_torch.models import (init_params, make_paged_config,  # noqa: E402
                                params_from_numpy)
from repro_torch.models.attention import (mea_attention,  # noqa: E402
                                          naive_attention)
from repro_torch.models.transformer import forward  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402
from repro_torch.serve.multi_engine import MultiEngine  # noqa: E402
from repro_torch.serve.scheduler import (Request,  # noqa: E402
                                         make_scheduler_config)

PS = 4
TOL = 2e-5


# ---------------------------------------------------------------------------
# PrefixCache and the eviction policies against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", EVICTION_POLICIES)
def test_cache_and_policy_match_jax_on_one_trace(policy):
    rng = np.random.RandomState(0)
    heads = [rng.randint(0, 50, size=4 * PS).astype(np.int32)
             for _ in range(2)]
    caches = (PrefixCache(PS, budget_pages=12, policy=get_eviction(policy)),
              jpkv.PrefixCache(PS, budget_pages=12,
                               policy=j_get_eviction(policy)))
    next_block, pins, seqs = 0, [], []
    for step in range(160):
        head = heads[rng.randint(len(heads))][: PS * rng.randint(0, 5)]
        toks = np.concatenate([head, rng.randint(0, 50, size=rng.randint(
            1, 2 * PS)).astype(np.int32)])
        op = rng.choice(["insert", "insert", "probe", "probe", "alias",
                         "unalias", "evict"])
        if op == "insert":
            n = len(toks) // PS
            blocks = list(range(next_block, next_block + n))
            next_block += n
            outs = [c.insert(toks, blocks) for c in caches]
        elif op == "probe":
            touch = bool(rng.rand() < 0.7)
            outs = [c.probe(toks, touch=touch) for c in caches]
            seqs.append(toks)
        elif op == "alias" and seqs:
            pick = seqs[rng.randint(len(seqs))]
            n = caches[0].probe(pick)[0] // PS
            assert n == caches[1].probe(pick)[0] // PS
            outs = [n, n]
            if n:
                for c in caches:
                    c.alias(pick, n)
                pins.append((pick, n))
        elif op == "unalias" and pins:
            pick, n = pins.pop(rng.randint(len(pins)))
            outs = [c.unalias(pick, n) for c in caches]
        else:
            k = int(rng.randint(1, 3))
            outs = [c.evict_pages(k) for c in caches]
        assert outs[0] == outs[1], (step, op)
        for c in caches:
            assert len(c.blocks()) == c.pages <= c.budget
        a, b = caches
        assert np.array_equal(a.blocks(), b.blocks()), step
        for f in ("hits", "misses", "inserts", "evictions", "dup_skips",
                  "aliases", "pages", "pinned"):
            assert getattr(a, f) == getattr(b, f), (step, f)
    assert caches[0].trace == caches[1].trace
    assert caches[0].evictions > 0 and caches[0].hits > 0
    assert caches[0].aliases > 0


def test_eviction_registry():
    assert EVICTION_POLICIES == ("lru", "2q", "arc")
    assert get_eviction().name == "lru"          # the JAX package's default
    for name in EVICTION_POLICIES:
        assert get_eviction(name).name == name
    with pytest.raises(ValueError, match="unknown eviction"):
        get_eviction("mru")


# ---------------------------------------------------------------------------
# the alias splice and the leak checks at the paged-KV layer
# ---------------------------------------------------------------------------

def _mini(dtype):
    return dict(num_kv_layers=1, kv_heads=1, head_dim=2, page_size=PS,
                num_pages=16, max_lanes=2, max_pages_per_lane=4, dtype=dtype,
                stash_size=0)


def _state_equal(t_state, j_state) -> list[str]:
    bad = [f for f in FreeListState._fields
           if not np.array_equal(getattr(t_state.alloc, f).numpy(),
                                 np.asarray(getattr(j_state.alloc, f)))]
    return bad + [f for f in ("block_tables", "seq_lens", "active")
                  if not np.array_equal(getattr(t_state, f).numpy(),
                                        np.asarray(getattr(j_state, f)))]


def test_alias_splice_lifecycle_matches_jax():
    """Seed the cache from lane 0, alias its 2 pages into both lanes in one
    burst, release both in one burst (two single frees per shared page),
    evict: the port's state equals the JAX package's after each step and
    the invariants hold."""
    tcfg, jcfg = PagedKVConfig(**_mini(torch.float32)), \
        jpkv.PagedKVConfig(**_mini(jnp.float32))
    tt, jt = pkv.paged_tenants(tcfg, "cpu"), jpkv.paged_tenants(jcfg)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 97, size=8).astype(np.int32)
    kv = rng.randn(1, 1, 8, 1, 2).astype(np.float32)
    ts = pkv.init_paged_kv(tcfg, tt)
    js = jpkv.init_paged_kv(jcfg, tenants=jt)
    ts, _ = pkv.admit_prefill_many(tcfg, ts, torch.tensor([0]),
                                   torch.as_tensor(kv), torch.as_tensor(kv),
                                   torch.tensor([8]), tt)
    js, _ = jpkv.admit_prefill_many(jcfg, js, jnp.asarray([0]),
                                    jnp.asarray(kv), jnp.asarray(kv),
                                    jnp.asarray([8]), tenants=jt)
    tc, jc = PrefixCache(PS, 8), jpkv.PrefixCache(PS, 8)
    kept, _, _ = tc.insert(toks, ts.block_tables[0, :2].numpy())
    assert (kept, [], []) == jc.insert(toks, np.asarray(js.block_tables)[0, :2])
    ts = ts._replace(alloc=tt.service.retag_blocks(ts.alloc, tt.kv, kept,
                                                   CACHE_OWNER))
    js = js._replace(alloc=jt.service.retag_blocks(
        js.alloc, jt.kv, np.asarray(kept, np.int32), jpkv.CACHE_OWNER))

    def release(lanes, extra):
        nonlocal ts, js
        pk = np.full((2,), -1, np.int32)
        pk[: len(lanes)] = lanes
        ts, _ = pkv.release_packets(tcfg, ts, torch.as_tensor(pk), tt,
                                    extra_free=extra)
        js, _ = jpkv.release_packets(jcfg, js, jnp.asarray(pk), tenants=jt,
                                     extra_free=extra)
        assert not _state_equal(ts, js)

    release([0], None)
    pkv.validate_paged_kv(tcfg, ts, tt, cache=tc)
    shared = tc.probe(np.concatenate([toks, toks[:4]]))[1]
    suf = rng.randn(2, 1, 4, 1, 2).astype(np.float32)
    ts, _ = pkv.admit_prefill_many(
        tcfg, ts, torch.tensor([0, 1]), torch.as_tensor(suf),
        torch.as_tensor(suf), torch.tensor([4, 4]), tt,
        prefix_blocks=torch.tensor([shared, shared]),
        prefix_lens=torch.tensor([8, 8]))
    js, _ = jpkv.admit_prefill_many(
        jcfg, js, jnp.asarray([0, 1]), jnp.asarray(suf), jnp.asarray(suf),
        jnp.asarray([4, 4]), tenants=jt,
        prefix_blocks=jnp.asarray([shared, shared]),
        prefix_lens=jnp.asarray([8, 8]))
    assert not _state_equal(ts, js)
    for c in (tc, jc):
        c.alias(toks, 2)
        c.alias(toks, 2)
    assert [int(ts.alloc.refcount[0, b]) for b in shared] == [3, 3]
    assert ts.seq_lens.tolist() == [12, 12]
    pkv.validate_paged_kv(tcfg, ts, tt, cache=tc)
    assert tc.evict_pages(4) == []                  # pinned
    for c in (tc, jc):
        c.unalias(toks, 2)
        c.unalias(toks, 2)
    release([0, 1], shared + shared)
    assert [int(ts.alloc.owner[0, b]) for b in shared] == [CACHE_OWNER] * 2
    pkv.validate_paged_kv(tcfg, ts, tt, cache=tc)
    evicted = tc.evict_pages(tc.pages)
    assert evicted == jc.evict_pages(jc.pages)
    release([], evicted)
    assert int(ts.alloc.used[0]) == 0
    pkv.validate_paged_kv(tcfg, ts, tt, cache=tc)


@pytest.mark.parametrize("leak", ["demotion", "alias_bump"])
def test_i5_i6_catch_leaks(leak):
    """A page retagged to CACHE_OWNER that the cache does not list breaks
    I5; a refcount bump without a block-table or cache reference breaks
    I6."""
    cfg = PagedKVConfig(**_mini(torch.float32))
    t = pkv.paged_tenants(cfg, "cpu")
    kv = torch.as_tensor(np.random.RandomState(0).randn(2, 1, 8, 1, 2)
                         .astype(np.float32))
    st, _ = pkv.admit_prefill_many(cfg, pkv.init_paged_kv(cfg, t),
                                   torch.tensor([0, 1]), kv, kv,
                                   torch.tensor([8, 8]), t)
    cache = PrefixCache(PS, 8)
    pkv.validate_paged_kv(cfg, st, t, cache=cache)
    blk = [int(st.block_tables[0, 0])]
    if leak == "demotion":
        st = st._replace(alloc=t.service.retag_blocks(st.alloc, t.kv, blk,
                                                      CACHE_OWNER))
        match = "I5"
    else:
        st = st._replace(alloc=t.service.bump_refcounts(st.alloc, t.kv, blk))
        match = "I6"
    with pytest.raises(FreelistInvariantError, match=match):
        pkv.validate_paged_kv(cfg, st, t, cache=cache)


# ---------------------------------------------------------------------------
# two shards serving with the cache on, against the JAX package
# ---------------------------------------------------------------------------

def _shared_prefix_prompts(vocab, n=10, prefix_len=40, tail=6):
    shared = np.random.RandomState(0).randint(0, vocab, size=prefix_len)
    return [np.concatenate([shared, np.random.RandomState(100 + rid).randint(
        0, vocab, size=tail)]).astype(np.int32) for rid in range(n)]


def _cache_state(me, jme) -> list[str]:
    bad = [f for f in FreeListState._fields
           if not np.array_equal(getattr(me.alloc, f).numpy(),
                                 np.asarray(getattr(jme.alloc, f)))]
    for i, (e, je) in enumerate(zip(me.engines, jme.engines)):
        p, jp = e.state.paged, je.state.paged
        for f in ("block_tables", "seq_lens", "active"):
            if not np.array_equal(getattr(p, f).numpy(),
                                  np.asarray(getattr(jp, f))):
                bad.append(f"e{i}.{f}")
        if not (np.array_equal(p.stash.pages.numpy(),
                               np.asarray(jp.stash.pages))
                and np.array_equal(p.stash.depth.numpy(),
                                   np.asarray(jp.stash.depth))):
            bad.append(f"e{i}.stash")
        if not np.array_equal(e.cache.blocks(), je.cache.blocks()):
            bad.append(f"e{i}.cache.blocks")
        for f in ("hits", "misses", "inserts", "evictions", "dup_skips",
                  "aliases", "pinned"):
            if getattr(e.cache, f) != getattr(je.cache, f):
                bad.append(f"e{i}.cache.{f}")
    return bad


@pytest.fixture(scope="module")
def cache_runs():
    jcfg, cfg = j_smoke_config("deepseek-7b"), smoke_config("deepseek-7b")
    jparams = j_init_params(jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    jkv = j_make_paged_config(jcfg, seq_len=128, lanes=2, page_size=8,
                              dtype=jnp.float32)
    tkv = make_paged_config(cfg, seq_len=128, lanes=2, page_size=8,
                            dtype=torch.float32)
    scfg = make_scheduler_config(cfg, tkv, max_prompt_len=64)
    prompts = _shared_prefix_prompts(cfg.vocab_size)
    kw = dict(n_engines=2, sched_cfg=scfg, quantum=3, prefix_cache=True,
              eviction="lru", cache_pages=8)
    runs = {}
    for mode in ("copy", "alias"):
        jme = JMultiEngine(jcfg, jkv, jparams, dtype=jnp.float32,
                           alloc_backend="jnp", alloc_policy="freelist",
                           prefix_alias=mode, **kw)
        me = MultiEngine(cfg, tkv, tparams, prefix_alias=mode, device="cpu",
                         **kw)
        jme.submit([JRequest(rid=i, tokens=p.copy(), max_new_tokens=6)
                    for i, p in enumerate(prompts)])
        me.submit([Request(rid=i, tokens=p.copy(), max_new_tokens=6)
                   for i, p in enumerate(prompts)])
        diffs = []
        while jme.has_work or me.has_work:
            jme.step_window()
            me.step_window(validate=True)
            diffs.append(_cache_state(me, jme))
            assert len(diffs) < 40
        runs[mode] = (me, jme, diffs)
    off = MultiEngine(cfg, tkv, tparams, n_engines=2, sched_cfg=scfg,
                      quantum=3, device="cpu")
    off.serve([Request(rid=i, tokens=p.copy()) for i, p in
               enumerate(prompts)], max_new_tokens=6, validate=True)
    runs["off"] = off
    return runs


def _outputs(requests):
    return {r.rid: list(r.output) for r in requests}


@pytest.mark.parametrize("mode", ["copy", "alias"])
def test_cache_admission_matches_jax_every_window(cache_runs, mode):
    me, jme, diffs = cache_runs[mode]
    assert not me.failed and len(me.finished) == 10
    assert _outputs(me.finished) == _outputs(jme.finished)
    for i, bad in enumerate(diffs):
        assert not bad, f"{mode} window {i}: {bad}"
    for e, je in zip(me.engines, jme.engines):
        for f in ("cache_hits", "cache_misses", "cache_inserts",
                  "cache_evictions", "cache_pages", "prefill_tokens_saved",
                  "aliased_pages", "cache_hit_copy_bytes", "cache_hit_admits",
                  "admitted", "completed", "hmq_admit_bursts",
                  "hmq_release_bursts", "decode_steps", "stash_hits",
                  "stash_misses", "tenants"):
            assert getattr(e.stats, f) == getattr(je.stats, f), (mode, f)
    for f in ("window_commits", "window_slots_live", "window_slots_capacity",
              "decode_steps", "preemptions"):
        assert getattr(me.stats, f) == getattr(jme.stats, f), (mode, f)


@pytest.mark.parametrize("mode", ["copy", "alias"])
def test_cache_on_tokens_equal_cache_off(cache_runs, mode):
    me = cache_runs[mode][0]
    assert _outputs(me.finished) == _outputs(cache_runs["off"].finished)
    hits = sum(e.stats.cache_hits for e in me.engines)
    saved = sum(e.stats.prefill_tokens_saved for e in me.engines)
    assert hits > 0 and saved > 0
    assert sum(e.stats.cache_evictions for e in me.engines) > 0
    aliased = sum(e.stats.aliased_pages for e in me.engines)
    copied = sum(e.stats.cache_hit_copy_bytes for e in me.engines)
    assert (aliased > 0 and copied == 0) if mode == "alias" \
        else (aliased == 0 and copied > 0)
    for e in me.engines:
        assert e.cache.pinned == 0
        # the cache's residue is all a shard still holds
        assert e.tenant_report()[e.tenants.kv.name]["used"] == \
            e.stats.cache_pages


def test_windowed_arch_falls_back_to_copy():
    cfg = smoke_config("gemma3-1b")
    assert cfg.attn_pattern == "local_global"
    params = init_params(cfg, dtype=torch.float32, device="cpu")
    kvcfg = make_paged_config(cfg, seq_len=128, lanes=2, page_size=8,
                              dtype=torch.float32)
    eng = ServingEngine(cfg, kvcfg, params, device="cpu", prefix_cache=True,
                        prefix_alias="alias")
    assert eng.prefix_alias == "alias" and not eng.alias_enabled
    # served in copy mode with the window binding: cache-on tokens equal
    # cache-off tokens
    scfg = make_scheduler_config(cfg, kvcfg, max_prompt_len=96)
    prompts = _shared_prefix_prompts(cfg.vocab_size, n=6, prefix_len=72,
                                     tail=5)
    outs = []
    for on in (False, True):
        me = MultiEngine(cfg, kvcfg, params, n_engines=2, sched_cfg=scfg,
                         quantum=3, prefix_cache=on, prefix_alias="alias",
                         device="cpu")
        me.serve([Request(rid=i, tokens=p.copy()) for i, p in
                  enumerate(prompts)], max_new_tokens=4, validate=True)
        outs.append(_outputs(me.finished))
        if on:
            assert sum(e.stats.cache_hits for e in me.engines) > 0
            assert sum(e.stats.aliased_pages for e in me.engines) == 0
    assert outs[0] == outs[1] and len(outs[0]) == 6


# ---------------------------------------------------------------------------
# attention over a cached prefix
# ---------------------------------------------------------------------------

OFFSET_CASES = [(P, Tq, window, KV, G, hd)
                for P in (8, 24, 64, 72)
                for Tq, window in ((13, None), (40, 24))
                for KV, G, hd in ((2, 1, 32), (1, 4, 16))]


@pytest.mark.parametrize("P,Tq,window,KV,G,hd", OFFSET_CASES)
def test_offset_attention_matches_jax(P, Tq, window, KV, G, hd):
    rng = np.random.RandomState(P + Tq)
    q = rng.randn(2, Tq, KV * G, hd).astype(np.float32)
    k = rng.randn(2, P + Tq, KV, hd).astype(np.float32)
    v = rng.randn(2, P + Tq, KV, hd).astype(np.float32)
    want = np.asarray(j_mea(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, window=window, q_offset=P, chunk=16))
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    for got in (mea_attention(tq, tk, tv, window=window, q_offset=P,
                              chunk=16),
                naive_attention(tq, tk, tv, window=window, q_offset=P),
                flash_attention_op(tq, tk, tv, window=window or 1 << 30,
                                   q_offset=P)):
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert FLASH_KERNEL.launches == 0


def test_offset_zero_is_the_plain_call():
    rng = np.random.RandomState(1)
    q, k, v = (torch.as_tensor(rng.randn(1, 20, 2, 16).astype(np.float32))
               for _ in range(3))
    assert torch.equal(flash_attention_op(q, k, v, q_offset=0),
                       flash_attention_op(q, k, v))
    assert torch.equal(mea_attention(q, k, v, q_offset=0),
                       mea_attention(q, k, v))


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma3-1b"])
def test_forward_over_cached_prefix_matches_jax(arch):
    """The suffix's logits and K/V over a 72-token cached prefix: against
    the JAX forward with the same prefix (2e-4, f32 sums in another
    order), and against the port's own forward of the whole sequence."""
    jcfg, cfg = j_smoke_config(arch), smoke_config(arch)
    jparams = j_init_params(jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    rng = np.random.RandomState(3)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 72 + 9)).astype(np.int32)
    full, (ks, vs) = forward(tparams, torch.as_tensor(toks), return_kv=True)
    pk, pv = ks[:, :, :72], vs[:, :, :72]
    got, (sk, sv) = forward(tparams, torch.as_tensor(toks[:, 72:]),
                            return_kv=True, prefix_kv=(pk, pv), pos_offset=72)
    want, (jk, jv) = j_forward(
        jparams, jcfg, jnp.asarray(toks[:, 72:]), remat=False,
        return_kv=True, prefix_kv=(jnp.asarray(pk.numpy()),
                                   jnp.asarray(pv.numpy())), pos_offset=72)
    for a, b in ((got, want), (sk, jk), (sv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4)
    np.testing.assert_allclose(got.numpy(), full[:, 72:].numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.cuda
def test_flash_offset_kernel_matches_plain_on_card():
    """The kernel with a query offset in f32 (2e-5) and bf16 (3e-2) against
    its plain version, offsets cutting tiles at new places, windows none
    and 512, hd 128 and 256, G 1 and 4, ragged Tq; offset 0 bit-identical
    to the call without one, two launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(9)
    for dt, tol in ((torch.float32, TOL), (torch.bfloat16, 3e-2)):
        for P in (0, 8, 24, 64, 72, 1200):
            for Tq in (37, 100):
                for window in (1 << 30, 512):
                    for hd, G in ((128, 1), (256, 4)):
                        q = torch.as_tensor(rng.randn(1, Tq, 2 * G, hd)
                                            ).to(dt)
                        k, v = (torch.as_tensor(rng.randn(1, P + Tq, 2, hd))
                                .to(dt) for _ in range(2))
                        got = flash_attention_op(q.cuda(), k.cuda(), v.cuda(),
                                                 window=window, q_offset=P)
                        assert torch.equal(got, flash_attention_op(
                            q.cuda(), k.cuda(), v.cuda(), window=window,
                            q_offset=P))
                        if P == 0:
                            assert torch.equal(got, flash_attention_op(
                                q.cuda(), k.cuda(), v.cuda(), window=window))
                        want = flash_attention_op(q, k, v, window=window,
                                                  q_offset=P)
                        torch.testing.assert_close(got.cpu().float(),
                                                   want.float(), rtol=tol,
                                                   atol=tol)
