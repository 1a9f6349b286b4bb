"""whisper-medium (the audio family: a bidirectional encoder over
precomputed frame embeddings, a decoder with cross-attention over its
output, learned positions, LayerNorm and a plain GELU MLP with biases) in
the port against the JAX package, on the CPU.

``smoke_config`` shrinks whisper's head dim 64 to 32 and its 1500 frames
to 16, so the tests rebuild both packages' configs with ``head_dim=64``
and 150 frames (not a multiple of 16).  The JAX init has zero decoder
positions, zero MLP biases and LayerNorms of scale 1 and bias 0: the tests
put seeded nonzero values there in the JAX tree, then carry it across
with ``params_from_numpy``.  Frames, prompts and inputs come from numpy
seeds.

f32 throughout: blocks, logits, K/V and the encoder output within rtol =
atol = 2e-4 (sums in another order); decode fed given tokens against the
forward within 2e-4 of max |logit| (the card's gate in
``chip_smoke.py``); served tokens equal and the allocator state
bit-identical after every operation and window, for one engine and two
shards with preemption.
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
from repro.models.transformer import _cross_block_seq as j_cross  # noqa: E402
from repro.models.transformer import _encoder_block_seq as j_enc  # noqa: E402
from repro.models.transformer import _whisper_encoder as j_encoder  # noqa: E402
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
from repro_torch.models.transformer import (_attn_block_seq,  # noqa: E402
                                            cross_residual, forward)
from repro_torch.serve.engine import ServingEngine  # noqa: E402
from repro_torch.serve.multi_engine import MultiEngine  # noqa: E402
from repro_torch.serve.scheduler import Request, make_scheduler_config  # noqa: E402

ARCH = "whisper-medium"
TOL = dict(rtol=2e-4, atol=2e-4)
FRAMES = 150


def configs():
    """Both packages' smoke whisper at its published head dim 64, with 150
    frames."""
    kw = dict(head_dim=64, encoder_seq_len=FRAMES)
    return (dataclasses.replace(j_smoke_config(ARCH), **kw),
            dataclasses.replace(smoke_config(ARCH), **kw))


def nonzero(tree: dict, rng) -> dict:
    """Seeded values where the JAX init has zeros or ones: every
    LayerNorm's scale and bias, the MLP biases and the decoder positions
    (numpy tree, in place)."""
    for key, val in tree.items():
        if isinstance(val, dict) and set(val) == {"scale", "bias"}:
            val["scale"] = (1 + 0.2 * rng.randn(*val["scale"].shape)
                            ).astype(np.float32)
            val["bias"] = (0.2 * rng.randn(*val["bias"].shape)
                           ).astype(np.float32)
        elif isinstance(val, dict):
            nonzero(val, rng)
        elif key in ("b_in", "b_out", "dec_pos"):
            tree[key] = (0.2 * rng.randn(*val.shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = configs()
    tree = nonzero(jax.tree.map(np.asarray, j_init_params(
        jcfg, dtype=jnp.float32)), np.random.RandomState(7))
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, cfg, device="cpu")
    for t in (tparams.dec_pos, tparams.layers[1].b_in,
              tparams.enc_layers[0].b_out, tparams.cross_layers[1].ln.bias,
              tparams.final_norm.bias):
        assert float(t.abs().min()) > 0
    return jcfg, cfg, jparams, tparams


def frames(rng, n: int, d: int) -> np.ndarray:
    return rng.randn(n, FRAMES, d).astype(np.float32)


def test_config_matches_jax():
    jfull, tfull = j_get_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(jfull):
        assert getattr(tfull, f.name) == getattr(jfull, f.name), f.name
    assert (tfull.family, tfull.encoder_layers, tfull.encoder_seq_len,
            tfull.resolved_head_dim, tfull.norm, tfull.act) == \
        ("audio", 24, 1500, 64, "layernorm", "gelu")
    assert smoke_config(ARCH).resolved_head_dim == 32   # hides hd 64


def _tree_layer(tree, key, i):
    return jax.tree.map(lambda a: a[i], tree[key])


def test_encoder_and_cross_blocks_match_jax(models):
    """Encoder layer 1 (bidirectional, no RoPE) over 150 frames, and
    decoder cross block 0 of 23 rows over an encoder output of 150 rows."""
    jcfg, cfg, jparams, tparams = models
    rng = np.random.RandomState(1)
    x = frames(rng, 2, cfg.d_model)
    je = j_enc(jcfg, _tree_layer(jparams, "enc_layers", 1), jnp.asarray(x))
    te, _ = _attn_block_seq(cfg, tparams.enc_layers[1], torch.from_numpy(x),
                            1 << 30, causal=False)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)
    h = rng.randn(2, 23, cfg.d_model).astype(np.float32)
    jc = j_cross(jcfg, _tree_layer(jparams, "cross_layers", 0),
                 jnp.asarray(h), jnp.asarray(x))
    tc = cross_residual(cfg, tparams.cross_layers[0], torch.from_numpy(h),
                        torch.from_numpy(x))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_forward_and_encoder_match_jax(models):
    """Logits and the decoder's K/V of two 31-token sequences over their
    frames; the prefill's encoder output against ``_whisper_encoder``,
    and the prefill's logits equal to the forward's."""
    jcfg, cfg, jparams, tparams = models
    rng = np.random.RandomState(2)
    toks = rng.randint(0, cfg.vocab_size, (2, 31)).astype(np.int32)
    fr = frames(rng, 2, cfg.d_model)
    jl, (jk, jv) = j_forward(jparams, jcfg, jnp.asarray(toks),
                             encoder_frames=jnp.asarray(fr), remat=False,
                             return_kv=True)
    tl, (tk, tv) = forward(tparams, torch.from_numpy(toks), return_kv=True,
                           encoder_frames=torch.from_numpy(fr))
    assert tk.shape == (cfg.num_layers, 2, 31, cfg.num_kv_heads, 64)
    for t, j in ((tl, jl), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    pl, _, enc = tparams.prefill(torch.from_numpy(toks), torch.from_numpy(fr))
    np.testing.assert_allclose(
        enc.numpy(), np.asarray(j_encoder(jparams, jcfg, jnp.asarray(fr))),
        **TOL)
    assert torch.equal(pl, tl)
    with pytest.raises(ValueError, match="prefill-skip"):
        forward(tparams, torch.from_numpy(toks), pos_offset=8,
                encoder_frames=torch.from_numpy(fr))


def test_decode_matches_forward_teacher_forced(models):
    """After a 21-token admission over 150 frames, 6 decode steps fed the
    given tokens against the forward of the same tokens and frames: the
    decode adds the learned position at ``seq_lens``, reads its own K/V
    through the pages and the lane's ``enc_out``."""
    _, cfg, _, tparams = models
    rng = np.random.RandomState(3)
    n, steps = 21, 6
    toks = rng.randint(0, cfg.vocab_size, n + steps).astype(np.int32)
    fr = frames(rng, 1, cfg.d_model)
    kvcfg = make_paged_config(cfg, seq_len=48, lanes=2, page_size=4,
                              dtype=torch.float32)
    eng = ServingEngine(cfg, kvcfg, tparams, device="cpu")
    assert eng.admit(1, toks[:n], frames=fr[0])
    first = forward(tparams, torch.from_numpy(toks[:n])[None],
                    encoder_frames=torch.from_numpy(fr))[0, -1]
    assert int(eng.state.tokens[1]) == int(first.argmax())
    assert not eng.state.enc_out[0].any()
    errs = []
    for t in range(steps):
        tokens = eng.state.tokens.clone()
        tokens[1] = int(toks[n + t])
        eng.state = eng.state._replace(tokens=tokens)
        eng.state, logits, _ = eng._decode(eng.params, eng.state)
        ref = forward(tparams, torch.from_numpy(toks[:n + t + 1])[None],
                      encoder_frames=torch.from_numpy(fr))[0, -1]
        errs.append(float((logits[1] - ref).abs().max() / ref.abs().max()))
    assert max(errs) <= 2e-4, errs


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


def _engines(models, **cache):
    jcfg, cfg, jparams, tparams = models
    kw = dict(seq_len=64, lanes=3, page_size=8)
    return (JEngine(jcfg, j_make_paged_config(jcfg, dtype=jnp.float32, **kw),
                    jparams, dtype=jnp.float32, alloc_backend="jnp", **cache),
            ServingEngine(cfg, make_paged_config(cfg, dtype=torch.float32,
                                                 **kw), tparams,
                          device="cpu", **cache))


def test_serve_with_frames_matches_jax_engine(models):
    """Three lanes admitted one by one over their frames (prompts of 19,
    12 and 30 tokens), 6 decode steps, lanes 0 and 2 released, then lane 0
    again: tokens equal every step, allocator state bit-identical after
    every operation, each lane's ``enc_out`` equal to JAX's."""
    jeng, teng = _engines(models)
    cfg = teng.cfg
    rng = np.random.RandomState(4)
    fr = frames(rng, 4, cfg.d_model)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (19, 12, 30, 9)]
    for lane in range(3):
        assert jeng.admit(lane, prompts[lane], frames=fr[lane])
        assert teng.admit(lane, prompts[lane], frames=fr[lane])
        assert not _state_diff(teng, jeng), f"admit {lane}"
    np.testing.assert_array_equal(teng.state.tokens.numpy(),
                                  np.asarray(jeng.state.tokens))
    np.testing.assert_allclose(teng.state.enc_out.numpy(),
                               np.asarray(jeng.state.enc_out), **TOL)
    for i in range(6):
        np.testing.assert_array_equal(teng.step(), np.asarray(jeng.step()),
                                      err_msg=f"decode step {i}")
        assert not _state_diff(teng, jeng), f"step {i}"
    for e in (jeng, teng):
        e.release([0, 2])
    assert not _state_diff(teng, jeng)
    assert jeng.admit(0, prompts[3], frames=fr[3])
    assert teng.admit(0, prompts[3], frames=fr[3])
    for i in range(3):
        np.testing.assert_array_equal(teng.step(), np.asarray(jeng.step()),
                                      err_msg=f"decode step {6 + i}")
        assert not _state_diff(teng, jeng), f"step {6 + i}"
    np.testing.assert_allclose(teng.state.enc_out[0].numpy(),
                               np.asarray(jeng.state.enc_out[0]), **TOL)
    for f in ("admitted", "decode_steps", "hmq_admit_bursts",
              "hmq_release_bursts", "decode_bursts", "stash_hits",
              "stash_misses", "tenants"):
        assert getattr(teng.stats, f) == getattr(jeng.stats, f), f
    assert teng.stats.commits == \
        teng.stats.hmq_admit_bursts + 9 + teng.stats.hmq_release_bursts
    validate_paged_kv(teng.kvcfg, teng.state.paged, teng.tenants)


def test_audio_lanes_are_not_demoted(models):
    """With the cache on, a lane admitted over frames leaves nothing in
    the cache at its release (its K/V from the second layer on depends on
    the audio, not on its tokens alone); the JAX engine demotes it.
    Tokens equal JAX's, and the request probes the cache for nothing."""
    jeng, teng = _engines(models, prefix_cache=True)
    cfg = teng.cfg
    rng = np.random.RandomState(5)
    toks = rng.randint(0, cfg.vocab_size, size=27).astype(np.int32)
    fr = frames(rng, 1, cfg.d_model)[0]
    assert jeng.admit(0, toks, frames=fr) and teng.admit(0, toks, frames=fr)
    for _ in range(3):
        np.testing.assert_array_equal(teng.step(), np.asarray(jeng.step()))
    jeng.release([0], kv_tokens={0: toks})
    teng.release([0], kv_tokens={0: toks})
    assert jeng.cache.pages == 3 and teng.cache.pages == 0
    assert teng.live_pages == 0 and not teng._no_demote
    assert teng.cache_probe(Request(rid=1, tokens=toks, frames=fr)) == 0
    assert teng.stats.cache_misses == jeng.stats.cache_misses == 0
    validate_paged_kv(teng.kvcfg, teng.state.paged, teng.tenants)


def test_synth_requests_match_jax_launcher_draw_for_draw():
    jcfg, cfg = configs()
    for seed in (0, 7):
        jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
        jreqs = j_synth_requests(jcfg, 5, jr, priority_every=2)
        treqs = synth_requests(cfg, 5, tr, priority_every=2)
        for a, b in zip(treqs, jreqs):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_array_equal(a.frames, b.frames)
            assert a.frames.shape == (FRAMES, cfg.d_model)
            assert a.patches is None and a.priority == b.priority
        assert jr.randint(1 << 30) == tr.randint(1 << 30)   # same state


def test_two_shards_with_preemption_match_jax(models):
    """Two shards of 2 lanes, windows of 2 steps, preemption on, the
    launcher's synthetic requests (frames included): four fill both
    shards, a fifth at priority 3 preempts a running lane, which resumes
    by prefilling prompt + output over its frames again.  Window by
    window the shared state equals the JAX ``MultiEngine``'s; tokens and
    the rollup equal, nothing in use."""
    jcfg, cfg, jparams, tparams = models
    kw = dict(seq_len=160, lanes=2, page_size=8)
    jkv = j_make_paged_config(jcfg, dtype=jnp.float32, **kw)
    tkv = make_paged_config(cfg, dtype=torch.float32, **kw)
    scfg = make_scheduler_config(cfg, tkv, max_prompt_len=128)
    me = MultiEngine(cfg, tkv, tparams, n_engines=2, sched_cfg=scfg,
                     quantum=2, preemption=True, device="cpu")
    jme = JMultiEngine(jcfg, jkv, jparams, n_engines=2, dtype=jnp.float32,
                       sched_cfg=scfg, quantum=2, preemption=True,
                       alloc_backend="jnp", alloc_policy="freelist")
    reqs = synth_requests(cfg, 5, np.random.RandomState(6))

    def make(cls, r, pri=0):
        return cls(rid=r.rid, tokens=r.tokens.copy(), frames=r.frames,
                   priority=pri)

    def window(n):
        assert (me.step_window(validate=True), jme.step_window()) == \
            (True, True)
        for f in FreeListState._fields:
            assert np.array_equal(getattr(me.alloc, f).numpy(),
                                  np.asarray(getattr(jme.alloc, f))), \
                f"window {n}: {f}"
    for m, cls in ((me, Request), (jme, JRequest)):
        m.submit([make(cls, r) for r in reqs[:4]], max_new_tokens=6)
    window(0)
    for m, cls in ((me, Request), (jme, JRequest)):
        m.submit([make(cls, reqs[4], pri=3)], max_new_tokens=6)
    n = 1
    while me.has_work or jme.has_work:
        window(n)
        n += 1
        assert n < 40
    assert me.stats.preemptions == jme.stats.preemptions >= 1
    out = {r.rid: list(r.output) for r in me.finished}
    assert out == {r.rid: list(r.output) for r in jme.finished}
    assert sorted(out) == list(range(5))
    roll = me.tenant_rollup()
    assert roll == jme.tenant_rollup()
    for d in roll.values():
        assert d["used"] == 0 and d["alloc_count"] == d["free_count"]


def test_launcher_serves_whisper_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
          "--lanes", "2", "--max-new-tokens", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out
    assert "kv_pages: used=0/" in out


@pytest.mark.cuda
def test_kernels_at_whisper_shapes_match_plain_on_card():
    """whisper's attention on the card against the plain versions: flash
    with causal off (encoder 150 x 150 and Tq = 1, 37 over 1500 keys, 16
    heads x 64) and causal (the decoder's prefill), paged decode at hd 64
    and G = 1; f32 (2e-5) and bf16 (3e-2 flash, 2e-2 paged)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(0)
    for dt, tf, tp in ((torch.float32, 2e-5, 2e-5),
                       (torch.bfloat16, 3e-2, 2e-2)):
        for Tq, Tk, causal in ((150, 150, False), (1, 1500, False),
                               (37, 1500, False), (37, 37, True)):
            q = torch.as_tensor(rng.randn(2, Tq, 16, 64)).to(dt)
            k, v = (torch.as_tensor(rng.randn(2, Tk, 16, 64)).to(dt)
                    for _ in range(2))
            got = flash_attention_op(q.cuda(), k.cuda(), v.cuda(),
                                     causal=causal)
            torch.testing.assert_close(
                got.cpu().float(),
                flash_attention_op(q, k, v, causal=causal).float(),
                rtol=tf, atol=tf)
        n = 4 * 29 + 2
        cpu = [torch.as_tensor(rng.randn(4, 16, 64)).to(dt),
               torch.as_tensor(rng.randn(n, 16, 16, 64)).to(dt),
               torch.as_tensor(rng.randn(n, 16, 16, 64)).to(dt),
               torch.as_tensor(rng.permutation(n)[:4 * 29].reshape(4, 29)
                               .astype(np.int32)),
               torch.as_tensor(np.asarray([440, 300, 17, 4], np.int32))]
        got = paged_decode_attention_op(*[a.cuda() for a in cpu])
        torch.testing.assert_close(got.cpu().float(),
                                   paged_decode_attention_op(*cpu).float(),
                                   rtol=tp, atol=tp)


def test_prefill_runs_the_encoder_once_the_jax_prefill_twice(models,
                                                             monkeypatch):
    """The JAX family prefill runs the encoder over the frames twice
    (``_whisper_encoder`` for ``enc_out``, then again inside ``forward``),
    with the same values; the port's runs it once.  Both give the same
    last logits and encoder output."""
    import repro.models.transformer as jt
    from repro.serve.serve_step import make_family_prefill as j_prefill
    from repro_torch.models.transformer import WhisperLM
    from repro_torch.serve.serve_step import make_family_prefill
    jcfg, cfg, jparams, tparams = models
    calls = {"jax": 0, "port": 0}
    j_inner, t_inner = jt._whisper_encoder, WhisperLM.encode

    def j_count(*args, **kwargs):
        calls["jax"] += 1
        return j_inner(*args, **kwargs)

    def t_count(self, frames):
        calls["port"] += 1
        return t_inner(self, frames)
    monkeypatch.setattr(jt, "_whisper_encoder", j_count)
    monkeypatch.setattr(WhisperLM, "encode", t_count)
    rng = np.random.RandomState(8)
    toks = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    lengths = np.asarray([16, 9], np.int32)
    fr = frames(rng, 2, cfg.d_model)
    jres = j_prefill(jcfg)(jparams, dict(tokens=jnp.asarray(toks),
                                         lengths=jnp.asarray(lengths),
                                         frames=jnp.asarray(fr)))
    tres = make_family_prefill(cfg)(tparams, dict(
        tokens=torch.from_numpy(toks), lengths=torch.from_numpy(lengths),
        frames=torch.from_numpy(fr)))
    assert calls == {"jax": 2, "port": 1}
    np.testing.assert_allclose(tres.last_logits.numpy(),
                               np.asarray(jres.last_logits), **TOL)
    np.testing.assert_allclose(tres.enc_out.numpy(),
                               np.asarray(jres.enc_out), **TOL)
