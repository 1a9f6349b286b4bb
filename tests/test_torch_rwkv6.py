"""rwkv6-7b (the ssm family: attention-free RWKV6 layers with a
data-dependent decay) in the port against the JAX package, on the CPU.

``smoke_config`` shrinks the wkv head dim 64 to 32, so the tests rebuild
both packages' configs with ``head_dim=64`` (2 heads of 64 on d_model
128).  The JAX init has a zero bonus ``u`` and LayerNorms of scale 1 and
bias 0: the tests put seeded nonzero values there in the JAX tree, then
carry it across with ``params_from_numpy``.  Inputs come from numpy
seeds.

f32 throughout: the mixes, their decode steps, the forward and the
prefill's states within rtol = atol = 1e-4 (sums in another order; the
chunked recurrence takes exponents of within-chunk cumsums); decode fed
given tokens against the forward within 2e-4 of max |logit| (the card's
gate in ``chip_smoke.py``); served tokens equal and the allocator state
bit-identical after every operation and window, for one engine and for
two shards with preemption.
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
from repro.models import rwkv6 as jrw  # noqa: E402
from repro.models.transformer import _rwkv_stack as j_rwkv_stack  # noqa: E402
from repro.models.transformer import forward as j_forward  # noqa: E402
from repro.serve.engine import AdmissionItem as JItem  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro.serve.multi_engine import MultiEngine as JMultiEngine  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, smoke_config  # noqa: E402
from repro_torch.core.freelist import FreeListState  # noqa: E402
from repro_torch.core.paged_kv import validate_paged_kv  # noqa: E402
from repro_torch.models import make_paged_config, params_from_numpy  # noqa: E402
from repro_torch.models import rwkv6 as rw  # noqa: E402
from repro_torch.models.transformer import forward  # noqa: E402
from repro_torch.serve.engine import AdmissionItem, ServingEngine  # noqa: E402
from repro_torch.serve.multi_engine import MultiEngine  # noqa: E402
from repro_torch.serve.scheduler import Request, make_scheduler_config  # noqa: E402

ARCH = "rwkv6-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
PAGED = dict(seq_len=48, lanes=2, page_size=4)


def configs():
    """Both packages' smoke rwkv6 at its published wkv head dim 64."""
    return (dataclasses.replace(j_smoke_config(ARCH), head_dim=64),
            dataclasses.replace(smoke_config(ARCH), head_dim=64))


def nonzero(tree: dict, rng) -> dict:
    """Seeded values where the JAX init has zeros or ones: every
    LayerNorm's scale and bias and the bonus ``u`` (numpy tree, in
    place)."""
    for key, val in tree.items():
        if isinstance(val, dict) and set(val) == {"scale", "bias"}:
            val["scale"] = (1 + 0.2 * rng.randn(*val["scale"].shape)
                            ).astype(np.float32)
            val["bias"] = (0.2 * rng.randn(*val["bias"].shape)
                           ).astype(np.float32)
        elif isinstance(val, dict):
            nonzero(val, rng)
        elif key == "bonus_u":
            tree[key] = rng.uniform(0.0, 1.0, val.shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = configs()
    tree = nonzero(jax.tree.map(np.asarray, j_init_params(
        jcfg, dtype=jnp.float32)), np.random.RandomState(7))
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, cfg, device="cpu")
    assert tparams.layers[1].tm.bonus_u.dtype == torch.float32
    assert float(tparams.layers[1].tm.bonus_u.abs().min()) > 0
    assert float(tparams.layers[0].ln1.bias.abs().min()) > 0
    return jcfg, cfg, jparams, tparams


def test_config_matches_jax():
    jfull, tfull = j_get_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(jfull):
        assert getattr(tfull, f.name) == getattr(jfull, f.name), f.name
    assert (tfull.family, tfull.num_layers, tfull.d_model,
            tfull.resolved_head_dim, tfull.num_attn_layers) == \
        ("ssm", 32, 4096, 64, 0)
    assert len(ARCH_IDS) == 11 and ARCH in ARCH_IDS
    assert smoke_config(ARCH).resolved_head_dim == 32   # hides hd 64


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree["layers"])


def test_time_and_channel_mix_match_jax(models):
    """Layer 1's time mix over 37 tokens (three chunks of 16, the last
    ragged) from a nonzero wkv state and shift token, and its channel mix
    from a nonzero shift token."""
    jcfg, cfg, jparams, tparams = models
    rng = np.random.RandomState(1)
    spec = tparams.spec
    H, hd, d = spec.heads, spec.head_dim, spec.d_model
    x = rng.randn(2, 37, d).astype(np.float32)
    s0 = (0.3 * rng.randn(2, H, hd, hd)).astype(np.float32)
    prev = rng.randn(2, 1, d).astype(np.float32)
    jl, tl = _layer(jparams, 1), tparams.layers[1]
    jy, jfin = jrw.rwkv6_time_mix(jl["tm"], jrw.RWKV6Spec(d, cfg.d_ff, hd),
                                  jnp.asarray(x), jnp.asarray(s0),
                                  jnp.asarray(prev))
    ty, tfin = rw.rwkv6_time_mix(tl.tm, spec, torch.from_numpy(x),
                                 torch.from_numpy(s0), torch.from_numpy(prev))
    assert tfin.dtype == torch.float32 and tuple(tfin.shape) == (2, H, hd, hd)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tfin.numpy(), np.asarray(jfin), **TOL)
    jc = jrw.rwkv6_channel_mix(jl["cm"], jnp.asarray(x), jnp.asarray(prev))
    tc = rw.rwkv6_channel_mix(tl.cm, torch.from_numpy(x),
                              torch.from_numpy(prev))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_mix_steps_match_jax(models):
    """One-token steps of both mixes from a nonzero state: output, new wkv
    state and each mix's new shift token."""
    _, cfg, jparams, tparams = models
    rng = np.random.RandomState(2)
    spec = tparams.spec
    H, hd, d = spec.heads, spec.head_dim, spec.d_model
    x = rng.randn(3, d).astype(np.float32)
    st = [(0.3 * rng.randn(3, H, hd, hd)).astype(np.float32),
          rng.randn(3, 1, d).astype(np.float32),
          rng.randn(3, 1, d).astype(np.float32)]
    jl, tl = _layer(jparams, 0), tparams.layers[0]
    jy, jw, jtm = jrw.rwkv6_time_mix_step(
        jl["tm"], jrw.RWKV6Spec(d, cfg.d_ff, hd), jnp.asarray(x),
        jrw.RWKV6DecodeState(*map(jnp.asarray, st)))
    ty, tw, ttm = rw.rwkv6_time_mix_step(
        tl.tm, spec, torch.from_numpy(x),
        rw.RWKV6DecodeState(*map(torch.from_numpy, st)))
    for t, j in ((ty, jy), (tw, jw), (ttm, jtm)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    jc, jcm = jrw.rwkv6_channel_mix_step(jl["cm"], jnp.asarray(x),
                                         jnp.asarray(st[2]))
    tc, tcm = rw.rwkv6_channel_mix_step(tl.cm, torch.from_numpy(x),
                                        torch.from_numpy(st[2]))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))


def test_forward_and_prefill_states_match_jax(models):
    """Logits of two 29-token sequences, and the prefill's per-layer
    ``(wkv, tm_prev, cm_prev)`` against ``_rwkv_stack(return_states=True)``;
    the family has no K/V, so ``return_kv`` raises."""
    jcfg, cfg, jparams, tparams = models
    rng = np.random.RandomState(3)
    toks = rng.randint(0, cfg.vocab_size, (2, 29)).astype(np.int32)
    jl = j_forward(jparams, jcfg, jnp.asarray(toks), remat=False)
    tl = forward(tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _, jstates = j_rwkv_stack(jparams, jcfg,
                              jparams["embed"][jnp.asarray(toks)],
                              remat=False, return_states=True)
    tstates = tparams.prefill(torch.from_numpy(toks))
    for t, j in zip(tstates, jstates):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    with pytest.raises(ValueError, match="no K/V"):
        forward(tparams, torch.from_numpy(toks), return_kv=True)


def test_decode_matches_forward_teacher_forced(models):
    """After an 11-token admission, 5 decode steps fed the given tokens
    (the seed overwritten, so no token is folded twice) equal the full
    forward's last logits; each step advances ``seq_lens`` by one and
    commits nothing."""
    _, cfg, _, tparams = models
    rng = np.random.RandomState(4)
    toks = rng.randint(0, cfg.vocab_size, 16).astype(np.int32)
    kvcfg = make_paged_config(cfg, dtype=torch.float32, **PAGED)
    eng = ServingEngine(cfg, kvcfg, tparams, device="cpu")
    assert eng.admit(0, toks[:11])
    errs = []
    for t in range(5):
        tokens = eng.state.tokens.clone()
        tokens[0] = int(toks[11 + t])
        eng.state = eng.state._replace(tokens=tokens)
        eng.state, logits, stats = eng._decode(eng.params, eng.state)
        assert int(eng.state.paged.seq_lens[0]) == 12 + t
        assert int(stats.bursts) == 0 and not stats.tenant.used.any()
        ref = forward(tparams, torch.as_tensor(toks[:12 + t])[None])[0, -1]
        errs.append(float((logits[0] - ref).abs().max() / ref.abs().max()))
    assert max(errs) <= 2e-4, errs


def _paged_diff(tp, jp) -> list[str]:
    out = [f for f in FreeListState._fields
           if not np.array_equal(getattr(tp.alloc, f).numpy(),
                                 np.asarray(getattr(jp.alloc, f)))]
    for f in ("block_tables", "seq_lens", "active", "state_slot",
              "scratch_slot"):
        if not np.array_equal(getattr(tp, f).numpy(),
                              np.asarray(getattr(jp, f))):
            out.append(f)
    for f in ("pages", "depth"):
        if not np.array_equal(getattr(tp.stash, f).numpy(),
                              np.asarray(getattr(jp.stash, f))):
            out.append(f"stash.{f}")
    return out


@pytest.fixture(scope="module")
def served(models):
    """Both engines: two prompts (9 and 6 tokens) admitted together, 6
    steps, lane 0 released, a new 9-token prompt admitted into it, 3 more
    steps, both lanes released.  Records tokens and state differences
    after every operation, and both tenant reports after the first
    admission."""
    jcfg, cfg, jparams, tparams = models
    jkv = j_make_paged_config(jcfg, dtype=jnp.float32, **PAGED)
    tkv = make_paged_config(cfg, dtype=torch.float32, **PAGED)
    for f in ("num_kv_layers", "num_pages", "max_pages_per_lane",
              "state_slots", "scratch_slots", "stash_size",
              "stash_watermark", "stash_refill"):
        assert getattr(tkv, f) == getattr(jkv, f), f
    jeng = JEngine(jcfg, jkv, jparams, dtype=jnp.float32, alloc_backend="jnp")
    teng = ServingEngine(cfg, tkv, tparams, device="cpu")
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 6, 9)]
    log = []

    def record(what, tokens=None):
        log.append((what, tokens, _paged_diff(teng.state.paged,
                                              jeng.state.paged)))

    assert jeng.admit_many([JItem(0, prompts[0]), JItem(1, prompts[1])]) \
        == teng.admit_many([AdmissionItem(0, prompts[0]),
                            AdmissionItem(1, prompts[1])]) == []
    assert jeng.admitted_tokens == teng.admitted_tokens == {}
    reports = (teng.tenant_report(), jeng.tenant_report())
    record("admit")
    for s in range(6):
        record(f"step {s}", (np.asarray(jeng.step()), teng.step()))
    for e in (jeng, teng):
        e.release([0])
    record("release 0")
    assert jeng.admit(0, prompts[2]) and teng.admit(0, prompts[2])
    record("admit 2")
    for s in range(3):
        record(f"step {6 + s}", (np.asarray(jeng.step()), teng.step()))
    rec = (teng.state.rec, jeng.state.rec)
    for e in (jeng, teng):
        e.release([0, 1])
    record("release all")
    return dict(jeng=jeng, teng=teng, log=log, rec=rec, reports=reports)


def test_engine_tokens_equal_jax(served):
    steps = [(w, t) for w, t, _ in served["log"] if t is not None]
    assert len(steps) == 9
    for what, (j, t) in steps:
        np.testing.assert_array_equal(t, j, err_msg=what)


def test_engine_state_bit_identical_after_every_operation(served):
    """FreeListState (every class), tables, seq_lens, slots and stash
    after every operation; tenant reports and counters equal."""
    for what, _, diff in served["log"]:
        assert not diff, f"after {what}: {diff} differ from JAX"
    jeng, teng = served["jeng"], served["teng"]
    assert [t.name for t in teng.tenants.handles] == \
        ["kv_pages", "state_slots", "scratch"]
    assert teng.tenant_report() == jeng.tenant_report()
    for f in ("admitted", "completed", "decode_steps", "alloc_failures",
              "hmq_admit_bursts", "hmq_release_bursts", "decode_bursts",
              "stash_hits", "stash_misses", "burst_slots_live",
              "burst_slots_capacity", "tenants"):
        assert getattr(teng.stats, f) == getattr(jeng.stats, f), f
    validate_paged_kv(teng.kvcfg, teng.state.paged, teng.tenants)


def test_commits_are_the_release_bursts(served):
    """No admission burst and no decode commit: every support-core commit
    of an rwkv6 engine is a release burst."""
    s = served["teng"].stats
    assert s.hmq_admit_bursts == s.decode_commits == 0
    assert s.decode_steps == 9 and s.hmq_release_bursts == 2
    assert s.commits == s.hmq_release_bursts


def test_state_slots_tenant_never_granted_in_both_packages(served):
    """A fault of the reference that the port keeps: an rwkv6 engine
    registers a ``state_slots`` tenant of one slot a lane, but admission
    issues no burst, so the lanes' state is never allocator-managed: the
    tenant is empty after admission in both packages (and every other
    tenant too)."""
    for rep in served["reports"]:
        assert rep["state_slots"]["quota"] == 2
        for d in rep.values():
            assert d["used"] == 0 and d["alloc_count"] == 0
    np.testing.assert_array_equal(
        served["teng"].state.paged.state_slot.numpy(), [-1, -1])


def test_engine_recurrent_state_matches_jax(served):
    trec, jrec = served["rec"]
    assert trec.ssm.dtype == torch.float32 and trec.conv is None
    for f in ("ssm", "tm_prev", "cm_prev"):
        np.testing.assert_allclose(getattr(trec, f).numpy(),
                                   np.asarray(getattr(jrec, f)), **TOL)


def test_two_shards_with_preemption_match_jax(models):
    """Two shards of 2 lanes, windows of 2 steps, preemption on: four
    8-token requests fill both shards, a priority-3 one preempts a running
    lane, which resumes by prefilling prompt and output at their exact
    length.  Window by window the shared state (six classes) equals the
    JAX ``MultiEngine``'s; tokens and the rollup equal, nothing in use."""
    jcfg, cfg, jparams, tparams = models
    kw = dict(seq_len=64, lanes=2, page_size=4)
    jkv = j_make_paged_config(jcfg, dtype=jnp.float32, **kw)
    tkv = make_paged_config(cfg, dtype=torch.float32, **kw)
    scfg = make_scheduler_config(cfg, tkv, max_prompt_len=32)
    assert scfg.exact_buckets
    me = MultiEngine(cfg, tkv, tparams, n_engines=2, sched_cfg=scfg,
                     quantum=2, preemption=True, device="cpu")
    jme = JMultiEngine(jcfg, jkv, jparams, n_engines=2, dtype=jnp.float32,
                       sched_cfg=scfg, quantum=2, preemption=True,
                       alloc_backend="jnp", alloc_policy="freelist")
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, 8).astype(np.int32)
               for _ in range(5)]

    def window(n):
        assert (me.step_window(validate=True), jme.step_window()) == \
            (True, True)
        for f in FreeListState._fields:
            assert np.array_equal(getattr(me.alloc, f).numpy(),
                                  np.asarray(getattr(jme.alloc, f))), \
                f"window {n}: {f}"
    for m, cls in ((me, Request), (jme, JRequest)):
        m.submit([cls(rid=i, tokens=prompts[i].copy()) for i in range(4)],
                 max_new_tokens=8)
    window(0)
    for m, cls in ((me, Request), (jme, JRequest)):
        m.submit([cls(rid=4, tokens=prompts[4].copy(), priority=3)],
                 max_new_tokens=8)
    n = 1
    while me.has_work or jme.has_work:
        window(n)
        n += 1
        assert n < 40
    assert len(me.alloc.free_top) == 6
    assert me.stats.preemptions == jme.stats.preemptions == 1
    out = {r.rid: list(r.output) for r in me.finished}
    assert out == {r.rid: list(r.output) for r in jme.finished}
    assert sorted(out) == list(range(5))
    assert me.stats.window_commits == jme.stats.window_commits
    roll = me.tenant_rollup()
    assert roll == jme.tenant_rollup()
    for d in roll.values():
        assert d["used"] == 0 and d["alloc_count"] == d["free_count"]


def test_launcher_serves_rwkv6_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
          "--lanes", "2", "--max-new-tokens", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out
    assert "admit_bursts=0 " in out
    assert "state_slots: used=0/2" in out


def test_init_serve_state_matches_jax():
    """The synthetic pre-admitted decode state: the JAX package's
    allocator metadata over three classes and a zero recurrent state of
    its shapes (wkv f32, the shift tokens in the model dtype)."""
    from repro.serve.serve_step import init_serve_state as j_init_serve_state
    from repro_torch.core.paged_kv import paged_tenants
    from repro_torch.serve.serve_step import init_serve_state
    jcfg, cfg = configs()
    jkv = j_make_paged_config(jcfg, dtype=jnp.float32, **PAGED)
    tkv = make_paged_config(cfg, dtype=torch.float32, **PAGED)
    js = j_init_serve_state(jcfg, jkv, 2, 9, dtype=jnp.float32)
    ts = init_serve_state(cfg, tkv, 2, paged_tenants(tkv, "cpu"), 9)
    for f in FreeListState._fields:
        np.testing.assert_array_equal(getattr(ts.paged.alloc, f).numpy(),
                                      np.asarray(getattr(js.paged.alloc, f)))
    for f in ("ssm", "tm_prev", "cm_prev"):
        t, j = getattr(ts.rec, f), getattr(js.rec, f)
        assert tuple(t.shape) == j.shape and not t.any()
    assert ts.rec.ssm.dtype == torch.float32 and ts.enc_out is None
