"""phi-3-vision-4.2b (the vlm family: a dense phi3-mini backbone behind a
prefix of patch embeddings) in the port against the JAX package, on the
CPU.

``smoke_config`` shrinks phi-3-vision's head dim 96 to 32, so the tests
rebuild it on both packages with ``head_dim=96``.  Patches, prompts and
weights come from numpy seeds; the JAX parameters carry across with
``params_from_numpy``.  Patches take positions ``[0, P)`` and the prompt
follows at P, so a lane holds ``P + len(prompt)`` tokens after admission.

f32 throughout: logits and K/V within rtol = atol = 2e-4 (sums in
another order); decode fed given tokens against the forward within 2e-4
of max |logit| (the card's gate in ``chip_smoke.py``); served tokens equal
and the allocator state bit-identical after every step and window.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.launch.serve import synth_requests as j_synth_requests  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_paged_config as j_make_paged_config  # noqa: E402
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
from repro_torch.launch.serve import synth_requests  # noqa: E402
from repro_torch.models import make_paged_config, params_from_numpy  # noqa: E402
from repro_torch.models.transformer import forward  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402
from repro_torch.serve.multi_engine import MultiEngine  # noqa: E402
from repro_torch.serve.scheduler import (Request, Scheduler,  # noqa: E402
                                         make_scheduler_config)

ARCH = "phi-3-vision-4.2b"
TOL = 2e-4


def configs():
    """Both packages' smoke phi-3-vision at its published head dim 96."""
    return (dataclasses.replace(j_smoke_config(ARCH), head_dim=96),
            dataclasses.replace(smoke_config(ARCH), head_dim=96))


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = configs()
    jparams = j_init_params(jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    return jcfg, cfg, jparams, tparams


def patches(rng, n, d):
    return rng.randn(n, d).astype(np.float32)


def test_config_matches_jax():
    jfull, tfull = j_get_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(jfull):
        assert getattr(tfull, f.name) == getattr(jfull, f.name), f.name
    assert (tfull.family, tfull.resolved_head_dim, tfull.frontend_tokens) \
        == ("vlm", 96, 576)
    assert smoke_config(ARCH).resolved_head_dim == 32   # hides hd 96
    assert configs()[1].resolved_head_dim == 96


def test_forward_with_patch_prefix_matches_jax(models):
    jcfg, cfg, jparams, tparams = models
    rng = np.random.RandomState(5)
    toks = rng.randint(0, cfg.vocab_size, (2, 30)).astype(np.int32)
    pe = rng.randn(2, 8, cfg.d_model).astype(np.float32)
    jl, (jk, jv) = j_forward(jparams, jcfg, jnp.asarray(toks),
                             prefix_embeds=jnp.asarray(pe), remat=False,
                             return_kv=True)
    tl, (tk, tv) = forward(tparams, torch.from_numpy(toks), return_kv=True,
                           prefix_embeds=torch.from_numpy(pe))
    assert tl.shape[1] == 38 and tk.shape[2] == 38 and tk.shape[-1] == 96
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)


def test_prefix_embeds_refuse_a_cached_prefix(models):
    jcfg, cfg, jparams, tparams = models
    toks = np.zeros((1, 4), np.int32)
    pe = np.zeros((1, 2, cfg.d_model), np.float32)
    pk = np.zeros((cfg.num_layers, 1, 8, cfg.num_kv_heads, 96), np.float32)
    with pytest.raises(ValueError, match="prefill-skip"):
        j_forward(jparams, jcfg, jnp.asarray(toks),
                  prefix_embeds=jnp.asarray(pe),
                  prefix_kv=(jnp.asarray(pk), jnp.asarray(pk)), pos_offset=8)
    with pytest.raises(ValueError, match="prefill-skip"):
        forward(tparams, torch.from_numpy(toks),
                prefix_embeds=torch.from_numpy(pe),
                prefix_kv=(torch.from_numpy(pk), torch.from_numpy(pk)),
                pos_offset=8)


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


def test_serve_with_patches_matches_jax_engine(models):
    """Three lanes: 8 and 5 patch rows (two prefill groups) and one
    text-only prompt; 6 decode steps, then lanes 0 and 1 released.  Each
    patched lane holds P + len(prompt) tokens after admission; tokens
    equal every step; allocator state, block tables and stash
    bit-identical after admission, every step and the release."""
    jcfg, cfg, jparams, tparams = models
    kw = dict(seq_len=96, lanes=3, page_size=8)
    jeng = JEngine(jcfg, j_make_paged_config(jcfg, dtype=jnp.float32, **kw),
                   jparams, dtype=jnp.float32, alloc_backend="jnp")
    teng = ServingEngine(cfg, make_paged_config(cfg, dtype=torch.float32,
                                                **kw), tparams, device="cpu")
    rng = np.random.RandomState(1)
    lens, n_patch = (19, 12, 30), (8, 5, 0)
    for lane, (n, P) in enumerate(zip(lens, n_patch)):
        p = rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
        pe = patches(rng, P, cfg.d_model) if P else None
        assert jeng.admit(lane, p, patches=pe)
        assert teng.admit(lane, p, patches=pe)
    assert teng.stats.prefill_passes == 3
    np.testing.assert_array_equal(teng.state.paged.seq_lens.numpy(),
                                  [n + P for n, P in zip(lens, n_patch)])
    assert not _state_diff(teng, jeng)
    np.testing.assert_array_equal(teng.state.tokens.numpy(),
                                  np.asarray(jeng.state.tokens))
    for i in range(6):
        np.testing.assert_array_equal(teng.step(), np.asarray(jeng.step()),
                                      err_msg=f"decode step {i}")
        assert not _state_diff(teng, jeng), f"step {i}"
    jeng.release([0, 1])
    teng.release([0, 1])
    assert not _state_diff(teng, jeng)
    validate_paged_kv(teng.kvcfg, teng.state.paged, teng.tenants)


def test_page_charge_and_cache_probe_count_the_patches(models):
    """The scheduler charges a request P + len(prompt) tokens; a patched
    request never probes the prefix cache, even when its tokens open with
    cached pages, while the same tokens without patches hit."""
    _, cfg, _, tparams = models
    kvcfg = make_paged_config(cfg, seq_len=96, lanes=2, page_size=8,
                              dtype=torch.float32)
    scfg = make_scheduler_config(cfg, kvcfg, max_prompt_len=64)
    rng = np.random.RandomState(2)
    toks = rng.randint(0, cfg.vocab_size, size=33).astype(np.int32)
    pe = patches(rng, 6, cfg.d_model)
    assert Scheduler(scfg)._kv_len(Request(rid=0, tokens=toks,
                                           patches=pe)) == 39
    eng = ServingEngine(cfg, kvcfg, tparams, sched_cfg=scfg, device="cpu",
                        prefix_cache=True)
    assert eng.admit(0, toks)
    eng.step()
    eng.release([0], kv_tokens={0: toks})
    assert eng.cache.pages == 4
    assert eng.cache_probe(Request(rid=1, tokens=toks)) == 32
    assert eng.cache_probe(Request(rid=2, tokens=toks, patches=pe)) == 0


def test_patched_lanes_are_not_demoted(models):
    """With the cache on, a lane admitted behind patches leaves nothing in
    the cache at its release (its pages hold patch rows, not its tokens'
    K/V); the JAX engine demotes it.  Tokens equal JAX's."""
    jcfg, cfg, jparams, tparams = models
    kw = dict(seq_len=96, lanes=2, page_size=8)
    jeng = JEngine(jcfg, j_make_paged_config(jcfg, dtype=jnp.float32, **kw),
                   jparams, dtype=jnp.float32, alloc_backend="jnp",
                   prefix_cache=True)
    teng = ServingEngine(cfg, make_paged_config(cfg, dtype=torch.float32,
                                                **kw), tparams, device="cpu",
                         prefix_cache=True)
    rng = np.random.RandomState(3)
    toks = rng.randint(0, cfg.vocab_size, size=27).astype(np.int32)
    pe = patches(rng, 8, cfg.d_model)
    assert jeng.admit(0, toks, patches=pe) and teng.admit(0, toks,
                                                          patches=pe)
    for _ in range(3):
        np.testing.assert_array_equal(teng.step(), np.asarray(jeng.step()))
    jeng.release([0], kv_tokens={0: toks})
    teng.release([0], kv_tokens={0: toks})
    assert jeng.cache.pages == 3 and teng.cache.pages == 0
    assert teng.live_pages == 0
    validate_paged_kv(teng.kvcfg, teng.state.paged, teng.tenants)


def test_decode_matches_forward_with_patches(models):
    """8 patch rows and a 40-token prompt, then 6 decode steps fed given
    tokens against ``forward(prefix_embeds=...)`` of the same tokens: the
    first decode token sits at position P + len."""
    _, cfg, _, tparams = models
    rng = np.random.RandomState(4)
    n, steps = 40, 6
    toks = rng.randint(0, cfg.vocab_size, n + steps).astype(np.int32)
    pe = patches(rng, 8, cfg.d_model)
    kvcfg = make_paged_config(cfg, seq_len=64, lanes=1, page_size=8,
                              dtype=torch.float32)
    eng = ServingEngine(cfg, kvcfg, tparams, device="cpu")
    assert eng.admit(0, toks[:n], patches=pe)
    assert int(eng.state.paged.seq_lens[0]) == 8 + n
    first = forward(tparams, torch.from_numpy(toks[:n])[None],
                    prefix_embeds=torch.from_numpy(pe)[None])[0, -1]
    assert int(eng.state.tokens[0]) == int(first.argmax())
    errs = []
    for t in range(steps):
        tokens = eng.state.tokens.clone()
        tokens[0] = int(toks[n + t])
        eng.state = eng.state._replace(tokens=tokens)
        eng.state, logits, _ = eng._decode(eng.params, eng.state)
        ref = forward(tparams, torch.from_numpy(toks[:n + t + 1])[None],
                      prefix_embeds=torch.from_numpy(pe)[None])[0, -1]
        errs.append(float((logits[0] - ref).abs().max() / ref.abs().max()))
    assert max(errs) <= TOL, errs


def test_synth_requests_match_jax_launcher_draw_for_draw():
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    for seed in (0, 7):
        jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
        jreqs = j_synth_requests(jcfg, 6, jr, priority_every=3)
        treqs = synth_requests(cfg, 6, tr, priority_every=3)
        for a, b in zip(treqs, jreqs):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_array_equal(a.patches, b.patches)
            assert a.patches.shape == (4, cfg.d_model)
            assert a.priority == b.priority
        assert jr.randint(1 << 30) == tr.randint(1 << 30)   # same state


def test_preemption_resumes_patched_request_as_jax(models):
    """One shard of 2 lanes, windows of 2 steps, preemption on: two
    patched requests run, a third at priority 3 preempts one, which later
    re-prefills its patches with prompt + output.  Window by window the
    shared state equals the JAX ``MultiEngine``'s; every output equals the
    request's uninterrupted solo run."""
    jcfg, cfg, jparams, tparams = models
    kw = dict(seq_len=64, lanes=2, page_size=4)
    jkv = j_make_paged_config(jcfg, dtype=jnp.float32, **kw)
    tkv = make_paged_config(cfg, dtype=torch.float32, **kw)
    scfg = make_scheduler_config(cfg, tkv, max_prompt_len=32)
    rng = np.random.RandomState(6)
    reqs = [(rng.randint(0, cfg.vocab_size, size=n).astype(np.int32),
             patches(rng, 4, cfg.d_model)) for n in (9, 11, 7)]

    def make(cls, rid, pri=0):
        return cls(rid=rid, tokens=reqs[rid][0].copy(),
                   patches=reqs[rid][1], priority=pri)
    solo = {}
    for rid in range(3):
        me = MultiEngine(cfg, tkv, tparams, n_engines=1, sched_cfg=scfg,
                         quantum=2, device="cpu")
        me.serve([make(Request, rid)], max_new_tokens=10)
        solo[rid] = list(me.finished[0].output)
    me = MultiEngine(cfg, tkv, tparams, n_engines=1, sched_cfg=scfg,
                     quantum=2, preemption=True, device="cpu")
    jme = JMultiEngine(jcfg, jkv, jparams, n_engines=1, dtype=jnp.float32,
                       sched_cfg=scfg, quantum=2, preemption=True,
                       alloc_backend="jnp", alloc_policy="freelist")

    def window(n):
        assert (me.step_window(validate=True), jme.step_window()) == \
            (True, True)
        for f in FreeListState._fields:
            assert np.array_equal(getattr(me.alloc, f).numpy(),
                                  np.asarray(getattr(jme.alloc, f))), \
                f"window {n}: {f}"
    for m, cls in ((me, Request), (jme, JRequest)):
        m.submit([make(cls, 0), make(cls, 1)], max_new_tokens=10)
    window(0)
    for m, cls in ((me, Request), (jme, JRequest)):
        m.submit([make(cls, 2, pri=3)], max_new_tokens=10)
    n = 1
    while me.has_work or jme.has_work:
        window(n)
        n += 1
        assert n < 40
    assert me.stats.preemptions >= 1
    assert me.stats.preemptions == jme.stats.preemptions
    done = {r.rid: r for r in me.finished}
    assert any(r.preemptions for r in done.values())
    for rid, req in done.items():
        assert req.output == solo[rid], rid
    assert {r.rid: list(r.output) for r in jme.finished} == \
        {rid: r.output for rid, r in done.items()}
    for d in me.tenant_rollup().values():
        assert d["used"] == 0 and d["alloc_count"] == d["free_count"]


@pytest.mark.cuda
def test_kernels_at_head_dim_96_match_plain_on_card():
    """Both attention kernels at hd 96 (phi-3-vision: 32 heads on 32 KV
    heads; also G = 4 and 8) against their plain versions on the card, f32
    (2e-5) and bf16 (2e-2 paged, 3e-2 flash; flash also with lengths
    around the 64-row tile), two launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(0)
    ps, P = 16, 80
    for dt, tp, tf in ((torch.float32, 2e-5, 2e-5),
                       (torch.bfloat16, 2e-2, 3e-2)):
        for KV, G in ((32, 1), (4, 4), (2, 8)):
            n = 4 * P + 2
            cpu = [torch.as_tensor(rng.randn(4, KV * G, 96)).to(dt),
                   torch.as_tensor(rng.randn(n, ps, KV, 96)).to(dt),
                   torch.as_tensor(rng.randn(n, ps, KV, 96)).to(dt),
                   torch.as_tensor(rng.permutation(n)[:4 * P].reshape(4, P)
                                   .astype(np.int32)),
                   torch.as_tensor(np.asarray([1100, 700, 64, 5], np.int32))]
            got = paged_decode_attention_op(*[a.cuda() for a in cpu])
            assert torch.equal(got, paged_decode_attention_op(
                *[a.cuda() for a in cpu]))
            torch.testing.assert_close(got.cpu().float(),
                                       paged_decode_attention_op(*cpu)
                                       .float(), rtol=tp, atol=tp)
            for T in (63, 64, 65, 200):
                q = torch.as_tensor(rng.randn(1, T, KV * G, 96)).to(dt)
                k, v = (torch.as_tensor(rng.randn(1, T, KV, 96)).to(dt)
                        for _ in range(2))
                got = flash_attention_op(q.cuda(), k.cuda(), v.cuda())
                torch.testing.assert_close(
                    got.cpu().float(), flash_attention_op(q, k, v).float(),
                    rtol=tf, atol=tf)
