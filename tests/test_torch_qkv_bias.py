"""QKV bias (qwen2-72b) in the port against the JAX package, on the CPU.

``smoke_config("qwen2-72b")`` collapses its GQA to G = 1 (4 heads on 4 KV
heads), so these tests rebuild it on both packages with 8 query heads on
2 KV heads (G = 4) and on 1 (G = 8).  The JAX package initialises the
biases to zero, which would hide a missing bias, so every tree gets
seeded nonzero numpy biases scaled like the weights (``randn /
sqrt(d_model)``) before it is carried across with ``params_from_numpy``.
qwen2's RoPE theta is 1e6; prompts run past position 1000.

f32 throughout: logits, hidden states and K/V within rtol = atol = 2e-4
(sums in another order); decode against forward by the JAX serving
test's criterion (max error relative to max |logit| below 2e-3); served
tokens equal and the allocator state bit-identical after every step and
window.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_paged_config as j_make_paged_config  # noqa: E402
from repro.models.decode import decode_hidden as j_decode_hidden  # noqa: E402
from repro.models.transformer import forward as j_forward  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro.serve.multi_engine import MultiEngine as JMultiEngine  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core.freelist import FreeListState  # noqa: E402
from repro_torch.core.paged_kv import validate_paged_kv  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_op  # noqa: E402
from repro_torch.kernels.paged_attention.ops import \
    paged_decode_attention_op  # noqa: E402
from repro_torch.models import (init_params, make_paged_config,  # noqa: E402
                                params_from_numpy)
from repro_torch.models.decode import decode_hidden  # noqa: E402
from repro_torch.models.transformer import forward  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402
from repro_torch.serve.multi_engine import MultiEngine  # noqa: E402
from repro_torch.serve.scheduler import (Request,  # noqa: E402
                                         make_scheduler_config)

ARCH = "qwen2-72b"
TOL = 2e-4
PROMPTS = (1030, 700)         # the first runs past position 1000


def configs(G: int):
    """Both packages' smoke qwen2 with 8 query heads on 8 / G KV heads."""
    kw = dict(num_heads=8, num_kv_heads=8 // G)
    return (dataclasses.replace(j_smoke_config(ARCH), **kw),
            dataclasses.replace(smoke_config(ARCH), **kw))


def biased(jcfg, seed: int = 0):
    """The JAX parameters with nonzero QKV biases: (JAX tree, numpy tree)."""
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, dtype=jnp.float32))
    rng = np.random.RandomState(seed)
    attn = tree["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = (rng.randn(*attn[name].shape)
                      / np.sqrt(jcfg.d_model)).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), tree


@pytest.fixture(scope="module", params=[4, 8], ids=["G4", "G8"])
def models(request):
    jcfg, cfg = configs(request.param)
    jparams, tree = biased(jcfg)
    return jcfg, cfg, jparams, params_from_numpy(tree, cfg, device="cpu")


def test_config_matches_jax():
    jfull, tfull = j_get_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(jfull):
        assert getattr(tfull, f.name) == getattr(jfull, f.name), f.name
    assert tfull.qkv_bias and tfull.rope_theta == 1e6
    assert smoke_config(ARCH).num_kv_heads == smoke_config(ARCH).num_heads
    for G in (4, 8):
        cfg = configs(G)[1]
        assert cfg.num_heads // cfg.num_kv_heads == G


def test_biases_carried_and_move_the_logits(models):
    """The carried biases are nonzero, and zeroing them moves the logits
    far beyond the tolerance: the parity below sees the bias."""
    _, cfg, jparams, tparams = models
    for name in ("bq", "bk", "bv"):
        want = np.asarray(jparams["layers"]["attn"][name])
        got = np.stack([getattr(b, name).numpy() for b in tparams.layers])
        np.testing.assert_array_equal(got, want)
        assert (np.abs(want) > 0).mean() > 0.99
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (1, 20)).astype(np.int32))
    with_bias = forward(tparams, toks)
    saved = [(b.bq.data, b.bk.data) for b in tparams.layers]
    for b in tparams.layers:
        b.bq.data, b.bk.data = torch.zeros_like(b.bq), torch.zeros_like(b.bk)
    try:
        without = forward(tparams, toks)
    finally:
        for b, (q, k) in zip(tparams.layers, saved):
            b.bq.data, b.bk.data = q, k
    assert float((with_bias - without).abs().max()) > 100 * TOL


def test_init_params_draws_nonzero_biases():
    cfg = configs(8)[1]
    p = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    for b in p.layers:
        assert b.bq.shape == (cfg.num_heads * cfg.head_dim,)
        assert b.bk.shape == b.bv.shape == (cfg.num_kv_heads * cfg.head_dim,)
        for t in (b.bq, b.bk, b.bv):
            assert 0.5 < float(t.std()) * cfg.d_model ** 0.5 < 1.2
    dense = init_params(smoke_config("deepseek-7b"), dtype=torch.float32,
                        device="cpu")
    assert dense.layers[0].bq is None and "bq" not in dict(
        dense.named_parameters())


def test_forward_logits_and_kv_match_jax(models):
    jcfg, cfg, jparams, tparams = models
    toks = np.random.RandomState(5).randint(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jl, (jk, jv) = j_forward(jparams, jcfg, jnp.asarray(toks), remat=False,
                             return_kv=True)
    tl, (tk, tv) = forward(tparams, torch.from_numpy(toks), return_kv=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)


def _state_diff(teng, jeng) -> list[str]:
    tp, jp = teng.state.paged, jeng.state.paged
    bad = [f for f in FreeListState._fields
           if not np.array_equal(getattr(tp.alloc, f).numpy(),
                                 np.asarray(getattr(jp.alloc, f)))]
    for f in ("block_tables", "seq_lens", "active", "scratch_slot"):
        if not np.array_equal(getattr(tp, f).numpy(),
                              np.asarray(getattr(jp, f))):
            bad.append(f)
    if not np.array_equal(tp.stash.pages.numpy(), np.asarray(jp.stash.pages)):
        bad.append("stash")
    return bad


@pytest.fixture(scope="module")
def served(models):
    """Both engines admit prompts of 1030 and 700 tokens (16-token pages),
    then decode 5 steps and release lane 0; the decode stack's hidden
    state and K/V are taken from the first step's state."""
    jcfg, cfg, jparams, tparams = models
    kw = dict(seq_len=1100, lanes=2, page_size=16)
    jkv = j_make_paged_config(jcfg, dtype=jnp.float32, **kw)
    tkv = make_paged_config(cfg, dtype=torch.float32, **kw)
    jeng = JEngine(jcfg, jkv, jparams, dtype=jnp.float32, alloc_backend="jnp")
    teng = ServingEngine(cfg, tkv, tparams, device="cpu")
    rng = np.random.RandomState(1)
    for lane, n in enumerate(PROMPTS):
        p = rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
        assert jeng.admit(lane, p) and teng.admit(lane, p)
    out = dict(seed=(teng.state.tokens.numpy(), np.asarray(jeng.state.tokens)),
               diffs=[_state_diff(teng, jeng)], steps=[])
    jh, (jk, jv), _ = j_decode_hidden(jparams, jcfg, jkv, jeng.state.paged,
                                      None, jeng.state.tokens)
    th, (tk, tv), _ = decode_hidden(tparams, cfg, teng.state.paged,
                                    teng.state.tokens)
    out["hidden"] = ((th.numpy(), tk.numpy(), tv.numpy()),
                     (np.asarray(jh), np.asarray(jk), np.asarray(jv)))
    for _ in range(5):
        out["steps"].append((teng.step(), np.asarray(jeng.step())))
        out["diffs"].append(_state_diff(teng, jeng))
    jeng.release([0])
    teng.release([0])
    out["diffs"].append(_state_diff(teng, jeng))
    validate_paged_kv(teng.kvcfg, teng.state.paged, teng.tenants)
    return out


def test_decode_hidden_matches_jax_past_position_1000(served):
    (th, tk, tv), (jh, jk, jv) = served["hidden"]
    np.testing.assert_allclose(th, jh, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tk, jk, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tv, jv, rtol=TOL, atol=TOL)


def test_serve_tokens_and_state_equal_every_step(served):
    np.testing.assert_array_equal(*served["seed"])
    for i, (t, j) in enumerate(served["steps"]):
        np.testing.assert_array_equal(t, j, err_msg=f"decode step {i}")
    for i, diff in enumerate(served["diffs"]):
        assert not diff, f"after step {i}: {diff} differ from JAX"


def test_decode_matches_forward_past_position_1000(models):
    """RoPE at theta 1e6 in decode and prefill: a 1010-token prompt, then
    4 decode steps fed given tokens against the full forward."""
    _, cfg, _, tparams = models
    n, steps = 1010, 4
    toks = np.random.RandomState(3).randint(
        0, cfg.vocab_size, n + steps).astype(np.int32)
    kvcfg = make_paged_config(cfg, seq_len=1100, lanes=1, page_size=16,
                              dtype=torch.float32)
    eng = ServingEngine(cfg, kvcfg, tparams, device="cpu")
    assert eng.admit(0, toks[:n])
    errs = []
    for t in range(steps):
        tokens = eng.state.tokens.clone()
        tokens[0] = int(toks[n + t])
        eng.state = eng.state._replace(tokens=tokens)
        eng.state, logits, _ = eng._decode(eng.params, eng.state)
        ref = forward(tparams, torch.from_numpy(toks[:n + t + 1])[None])[0, -1]
        errs.append(float((logits[0] - ref).abs().max() / ref.abs().max()))
    assert max(errs) < 2e-3, errs


def _cache_diff(me, jme) -> list[str]:
    bad = [f for f in FreeListState._fields
           if not np.array_equal(getattr(me.alloc, f).numpy(),
                                 np.asarray(getattr(jme.alloc, f)))]
    for i, (e, je) in enumerate(zip(me.engines, jme.engines)):
        for f in ("block_tables", "seq_lens", "active"):
            if not np.array_equal(getattr(e.state.paged, f).numpy(),
                                  np.asarray(getattr(je.state.paged, f))):
                bad.append(f"e{i}.{f}")
        if not np.array_equal(e.cache.blocks(), je.cache.blocks()):
            bad.append(f"e{i}.cache")
        for f in ("hits", "misses", "inserts", "aliases", "pinned"):
            if getattr(e.cache, f) != getattr(je.cache, f):
                bad.append(f"e{i}.cache.{f}")
    return bad


def test_prefix_cache_alias_hit_matches_jax():
    """Two shards with alias-mode prefix caches at G = 8: requests on one
    40-token prefix hit pages that hold biased K/V.  Window by window the
    shared state, tables and caches equal the JAX ``MultiEngine``'s;
    tokens equal JAX's and the cache-off run's."""
    jcfg, cfg = configs(8)
    jparams, tree = biased(jcfg, seed=4)
    tparams = params_from_numpy(tree, cfg, device="cpu")
    kw = dict(seq_len=128, lanes=2, page_size=8)
    jkv = j_make_paged_config(jcfg, dtype=jnp.float32, **kw)
    tkv = make_paged_config(cfg, dtype=torch.float32, **kw)
    scfg = make_scheduler_config(cfg, tkv, max_prompt_len=64)
    shared = np.random.RandomState(0).randint(0, cfg.vocab_size, size=40)
    prompts = [np.concatenate([shared, np.random.RandomState(100 + i).randint(
        0, cfg.vocab_size, size=6)]).astype(np.int32) for i in range(8)]
    mkw = dict(n_engines=2, sched_cfg=scfg, quantum=3, prefix_cache=True,
               eviction="lru", cache_pages=8, prefix_alias="alias")
    jme = JMultiEngine(jcfg, jkv, jparams, dtype=jnp.float32,
                       alloc_backend="jnp", alloc_policy="freelist", **mkw)
    me = MultiEngine(cfg, tkv, tparams, device="cpu", **mkw)
    jme.submit([JRequest(rid=i, tokens=p.copy(), max_new_tokens=6)
                for i, p in enumerate(prompts)])
    me.submit([Request(rid=i, tokens=p.copy(), max_new_tokens=6)
               for i, p in enumerate(prompts)])
    windows = 0
    while jme.has_work or me.has_work:
        jme.step_window()
        me.step_window(validate=True)
        windows += 1
        assert not _cache_diff(me, jme), f"window {windows}"
        assert windows < 40
    outs = {r.rid: list(r.output) for r in me.finished}
    assert outs == {r.rid: list(r.output) for r in jme.finished}
    assert sum(e.stats.cache_hits for e in me.engines) > 0
    assert sum(e.stats.aliased_pages for e in me.engines) > 0
    off = MultiEngine(cfg, tkv, tparams, n_engines=2, sched_cfg=scfg,
                      quantum=3, device="cpu")
    off.serve([Request(rid=i, tokens=p.copy()) for i, p in
               enumerate(prompts)], max_new_tokens=6, validate=True)
    assert outs == {r.rid: list(r.output) for r in off.finished}


@pytest.mark.cuda
def test_kernels_at_qwen2_heads_match_plain_on_card():
    """Both attention kernels at qwen2's head layout (64 heads on 8 KV
    heads x 128, G = 8: the paged kernel's MAXG path) against their plain
    versions on the card, f32 (2e-5) and bf16 (2e-2 paged, 3e-2 flash)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(0)
    H, KV, hd, ps, P = 64, 8, 128, 16, 96
    for dt, tp, tf in ((torch.float32, 2e-5, 2e-5),
                       (torch.bfloat16, 2e-2, 3e-2)):
        n = 4 * P + 2
        cpu = [torch.as_tensor(rng.randn(4, H, hd)).to(dt),
               torch.as_tensor(rng.randn(n, ps, KV, hd)).to(dt),
               torch.as_tensor(rng.randn(n, ps, KV, hd)).to(dt),
               torch.as_tensor(rng.permutation(n)[:4 * P].reshape(4, P)
                               .astype(np.int32)),
               torch.as_tensor(np.asarray([1500, 1024, 700, 9], np.int32))]
        got = paged_decode_attention_op(*[a.cuda() for a in cpu])
        want = paged_decode_attention_op(*cpu)
        torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tp,
                                   atol=tp)
        q = torch.as_tensor(rng.randn(2, 300, H, hd)).to(dt)
        k, v = (torch.as_tensor(rng.randn(2, 300, KV, hd)).to(dt)
                for _ in range(2))
        got = flash_attention_op(q.cuda(), k.cuda(), v.cuda())
        torch.testing.assert_close(got.cpu().float(),
                                   flash_attention_op(q, k, v).float(),
                                   rtol=tf, atol=tf)
