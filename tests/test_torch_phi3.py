"""phi3-medium-14b (dense, GQA 40 heads on 10 KV heads) in the port against
the JAX package, on the CPU.

``smoke_config("phi3-medium-14b")`` collapses the GQA to G = 1 (4 heads on
4 KV heads), so the model tests rebuild it on both packages with 8 query
heads on 2 KV heads (G = 4, phi3-medium's ratio).  The attention ops also
run at the published head count, 40 heads on 10 KV heads, which is no
power of two.  f32 throughout: logits and K/V within rtol = atol = 2e-4,
the attention ops within 2e-5 (sums in another order); served tokens equal
and the allocator state bit-identical after every step.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention_op as j_flash  # noqa: E402
from repro.kernels.paged_attention.ops import \
    paged_decode_attention_op as j_paged  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_paged_config as j_make_paged_config  # noqa: E402
from repro.models.transformer import forward as j_forward  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core.freelist import FreeListState  # noqa: E402
from repro_torch.core.paged_kv import validate_paged_kv  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_op  # noqa: E402
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    paged_decode_attention_op, plan_splits)
from repro_torch.kernels.paged_attention.ref import \
    paged_attention_split  # noqa: E402
from repro_torch.models import make_paged_config, params_from_numpy  # noqa: E402
from repro_torch.models.transformer import forward  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402

ARCH = "phi3-medium-14b"
TOL = 2e-4
OP_TOL = 2e-5
FULL = 1 << 30


def configs():
    """Both packages' smoke phi3-medium with 8 heads on 2 KV heads."""
    kw = dict(num_heads=8, num_kv_heads=2)
    return (dataclasses.replace(j_smoke_config(ARCH), **kw),
            dataclasses.replace(smoke_config(ARCH), **kw))


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = configs()
    jparams = j_init_params(jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    return jcfg, cfg, jparams, tparams


def test_config_matches_jax():
    jfull, tfull = j_get_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(jfull):
        assert getattr(tfull, f.name) == getattr(jfull, f.name), f.name
    assert (tfull.num_heads, tfull.num_kv_heads, tfull.resolved_head_dim) \
        == (40, 10, 128)
    smoke = smoke_config(ARCH)
    assert smoke.num_heads == smoke.num_kv_heads      # G = 1: hides GQA
    jc, tc = configs()
    assert tc.num_heads // tc.num_kv_heads == 4 == jc.num_heads // \
        jc.num_kv_heads


def test_published_size():
    """14.66 B parameters (29.3 GB in bf16) and 200 KiB of K/V a token,
    worked out from the config by the port's own model, built without
    weights on the meta device."""
    from repro_torch.models.transformer import DenseLM
    cfg = get_config(ARCH)
    model = DenseLM(cfg, torch.bfloat16, torch.device("meta"))
    n = sum(p.numel() for p in model.parameters())
    assert 14.6e9 < n < 14.7e9
    kv_bytes = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * 2
    assert kv_bytes == 200 * 1024


def test_forward_logits_and_kv_match_jax(models):
    jcfg, cfg, jparams, tparams = models
    toks = np.random.RandomState(5).randint(
        0, cfg.vocab_size, (2, 37)).astype(np.int32)
    jl, (jk, jv) = j_forward(jparams, jcfg, jnp.asarray(toks), remat=False,
                             return_kv=True)
    tl, (tk, tv) = forward(tparams, torch.from_numpy(toks), return_kv=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seq,lanes,ps", [(2048, 4, 16), (256, 2, 8)])
def test_paged_config_matches_jax(seq, lanes, ps):
    j = j_make_paged_config(j_get_config(ARCH), seq_len=seq, lanes=lanes,
                            page_size=ps)
    t = make_paged_config(get_config(ARCH), seq_len=seq, lanes=lanes,
                          page_size=ps)
    for f in ("num_kv_layers", "kv_heads", "head_dim", "page_size",
              "num_pages", "max_lanes", "max_pages_per_lane", "stash_size",
              "stash_watermark", "stash_refill", "scratch_slots"):
        assert getattr(t, f) == getattr(j, f), f


def test_engine_matches_jax_engine_every_step(models):
    """Three lanes, prompts of 23, 9 and 40 tokens over 8-token pages, 6
    decode steps, then lanes 0 and 2 released: tokens equal every step;
    allocator state, block tables and stash bit-identical after every
    step; invariants hold."""
    jcfg, cfg, jparams, tparams = models
    kw = dict(seq_len=96, lanes=3, page_size=8)
    jeng = JEngine(jcfg, j_make_paged_config(jcfg, dtype=jnp.float32, **kw),
                   jparams, dtype=jnp.float32, alloc_backend="jnp")
    teng = ServingEngine(cfg, make_paged_config(cfg, dtype=torch.float32,
                                                **kw), tparams, device="cpu")
    rng = np.random.RandomState(1)
    for lane, n in enumerate((23, 9, 40)):
        p = rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
        assert jeng.admit(lane, p) and teng.admit(lane, p)

    def check(what):
        jp, tp = jeng.state.paged, teng.state.paged
        for f in FreeListState._fields:
            np.testing.assert_array_equal(
                getattr(tp.alloc, f).numpy(),
                np.asarray(getattr(jp.alloc, f)), err_msg=f"{what}: {f}")
        for f in ("block_tables", "seq_lens", "active", "scratch_slot"):
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jp, f)),
                                          err_msg=f"{what}: {f}")
        np.testing.assert_array_equal(tp.stash.pages.numpy(),
                                      np.asarray(jp.stash.pages))
    check("admission")
    np.testing.assert_array_equal(teng.state.tokens.numpy(),
                                  np.asarray(jeng.state.tokens))
    for i in range(6):
        np.testing.assert_array_equal(teng.step(), np.asarray(jeng.step()),
                                      err_msg=f"decode step {i}")
        check(f"step {i}")
    jeng.release([0, 2])
    teng.release([0, 2])
    check("release")
    validate_paged_kv(teng.kvcfg, teng.state.paged, teng.tenants)


def _paged_inputs(rng, B, KV, G, hd, ps, P):
    n = B * P + 2
    return (rng.randn(B, KV * G, hd).astype(np.float32),
            rng.randn(n, ps, KV, hd).astype(np.float32),
            rng.randn(n, ps, KV, hd).astype(np.float32),
            rng.permutation(n)[:B * P].reshape(B, P).astype(np.int32),
            rng.randint(1, P * ps - 1, size=B).astype(np.int32))


@pytest.mark.parametrize("window", [FULL, 40])
def test_attention_ops_at_ten_kv_heads_match_jax(rng, window):
    """The published head count, 40 on 10 KV heads (hd 32 here): the
    paged op, its split-and-merge with the planner's chunk, and the flash
    op against the JAX package's references."""
    arrays = _paged_inputs(rng, 3, 10, 4, 32, 8, 12)
    want = np.asarray(j_paged(*map(jnp.asarray, arrays), window=window,
                              impl="ref"))
    ts = [torch.from_numpy(a) for a in arrays]
    np.testing.assert_allclose(paged_decode_attention_op(*ts, window).numpy(),
                               want, rtol=OP_TOL, atol=OP_TOL)
    splits, chunk = plan_splits(3, 10, 4, 12, 8, window, 132)
    assert splits > 1 and splits * chunk >= min(window, 12 * 8) + 1
    np.testing.assert_allclose(
        paged_attention_split(*ts, window, chunk).numpy(), want,
        rtol=OP_TOL, atol=OP_TOL)
    q = rng.randn(2, 45, 40, 32).astype(np.float32)
    k = rng.randn(2, 45, 10, 32).astype(np.float32)
    v = rng.randn(2, 45, 10, 32).astype(np.float32)
    want = j_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                   window=window, impl="ref")
    got = flash_attention_op(*map(torch.from_numpy, (q, k, v)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OP_TOL,
                               atol=OP_TOL)


@pytest.mark.parametrize("B,KV,G,P,ps,window", [
    (4, 10, 4, 129, 16, FULL), (1, 10, 4, 129, 16, FULL),
    (4, 10, 4, 33, 8, 64), (3, 5, 8, 40, 16, FULL), (4, 8, 8, 129, 16, FULL),
    (4, 32, 1, 73, 16, FULL)])
@pytest.mark.parametrize("sms", [132, 114])
def test_plan_splits_covers_every_position(B, KV, G, P, ps, window, sms):
    """The split planner at head counts that are no power of two: every
    live position of a lane falls in some chunk, no chunk is empty for the
    longest lane, and the grid stays within one wave where it splits."""
    splits, chunk = plan_splits(B, KV, G, P, ps, window, sms)
    span = min(window, P * ps) + 1
    assert splits * chunk >= span > (splits - 1) * chunk
    blocks = B * KV * -(-G // 8)
    if splits > 1:
        assert blocks * splits <= max(sms, blocks * 2)


@pytest.mark.cuda
def test_kernels_at_phi3_heads_match_plain_on_card():
    """Both attention kernels at phi3-medium's head layout (40 heads on
    10 KV heads x 128, G = 4) against their plain versions on the card,
    f32 (2e-5) and bf16 (2e-2 paged, 3e-2 flash)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(0)
    for dt, tp, tf in ((torch.float32, 2e-5, 2e-5),
                       (torch.bfloat16, 2e-2, 3e-2)):
        cpu = [torch.as_tensor(a).to(dt) if a.dtype == np.float32
               else torch.as_tensor(a)
               for a in _paged_inputs(rng, 4, 10, 4, 128, 16, 96)]
        got = paged_decode_attention_op(*[a.cuda() for a in cpu])
        torch.testing.assert_close(got.cpu().float(),
                                   paged_decode_attention_op(*cpu).float(),
                                   rtol=tp, atol=tp)
        q = torch.as_tensor(rng.randn(2, 300, 40, 128)).to(dt)
        k, v = (torch.as_tensor(rng.randn(2, 300, 10, 128)).to(dt)
                for _ in range(2))
        got = flash_attention_op(q.cuda(), k.cuda(), v.cuda())
        torch.testing.assert_close(got.cpu().float(),
                                   flash_attention_op(q, k, v).float(),
                                   rtol=tf, atol=tf)
