"""The moe family (mixtral-8x7b, phi3.5-moe-42b-a6.6b) in the port against
the JAX package, on the CPU: the MoE layer, its routing and aux loss, the
configs, the paged-KV sizing of the sliding window, and the model forward.

Inputs and weights come from numpy seeds (the JAX init carried across with
``params_from_numpy``).  f32 throughout.  Tolerances: ``moe_apply`` within
1e-5 of the output's max |value| (the expert products sum in another
order); the keep masks and expert choices exactly (integers; the port's
stable sort breaks ties toward the lower expert, as ``jax.lax.top_k``);
the aux loss within 1e-6 relative; the forward's logits within rtol =
atol = 1e-4 (the rest of the block as the dense family's tests).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.core.hmq import round_robin_rank as j_rank  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_paged_config as j_make_paged_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.transformer import forward as j_forward  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, smoke_config  # noqa: E402
from _port_only import assert_config_is_jaxs  # noqa: E402
from repro_torch.models import make_paged_config, params_from_numpy  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import forward, layer_windows  # noqa: E402

ARCHS = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")


def _layers(spec: moe.MoESpec, seed: int):
    """A JAX MoE layer (its own init) and the port's with the same
    weights."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jmoe.MoESpec(*spec),
                       jnp.float32)
    tp = moe.MoE(spec, torch.float32, torch.device("cpu"), None)
    for name, p in tp.named_parameters():
        p.data = torch.from_numpy(np.array(jp[name]))
    return jp, tp


def _j_route(jp, spec, x):
    """The JAX layer's routing, step for step as ``repro.models.moe
    .moe_apply`` runs it (one group): ``(top_e, rank, keep)``."""
    xf = x.reshape(-1, x.shape[-1])
    gates = jax.nn.softmax(xf.astype(jnp.float32) @ jp["router"], axis=-1)
    _, top_e = jax.lax.top_k(gates, spec.experts_per_token)
    choice = top_e.reshape(-1)
    rank = j_rank(choice, jnp.ones_like(choice, dtype=bool))
    C = jmoe.expert_capacity(jmoe.MoESpec(*spec), xf.shape[0])
    return np.asarray(top_e), np.asarray(rank), np.asarray(rank < C)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_moe_apply_matches_jax_without_drops(act):
    """Smoke's capacity factor 16: no pair drops."""
    spec = moe.MoESpec(32, 48, 4, 2, capacity_factor=16.0, act=act)
    jp, tp = _layers(spec, seed=1)
    x = np.random.RandomState(0).randn(2, 24, 32).astype(np.float32)
    want = np.asarray(jmoe.moe_apply(jp, jmoe.MoESpec(*spec),
                                     jnp.asarray(x)))
    got = moe.moe_apply(tp, spec, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    _, _, _, keep, _ = moe.route(tp, spec, torch.from_numpy(x).reshape(-1,
                                                                       32))
    assert bool(keep.all())


@pytest.mark.parametrize("num_experts,tokens", [(8, 96), (16, 160)])
def test_moe_apply_matches_jax_with_drops(num_experts, tokens):
    """The published capacity factor 1.25 over a batch whose tokens share
    a common direction, so that the router favours some experts and they
    overflow: the same pairs drop (keep masks, choices and ranks
    identical) and the outputs agree."""
    spec = moe.MoESpec(32, 48, num_experts, 2, capacity_factor=1.25)
    jp, tp = _layers(spec, seed=2)
    rng = np.random.RandomState(3)
    x = (rng.randn(2, tokens // 2, 32) + 2.0 * rng.randn(32)
         ).astype(np.float32)
    j_top, j_rk, j_keep = _j_route(jp, spec, jnp.asarray(x))
    _, top_e, rank, keep, C = moe.route(tp, spec,
                                        torch.from_numpy(x).reshape(-1, 32))
    assert C == jmoe.expert_capacity(jmoe.MoESpec(*spec), tokens)
    np.testing.assert_array_equal(top_e.numpy(), j_top)
    np.testing.assert_array_equal(rank.numpy(), j_rk)
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    assert 0 < (~j_keep).sum()                  # some pairs do drop
    want = np.asarray(jmoe.moe_apply(jp, jmoe.MoESpec(*spec),
                                     jnp.asarray(x)))
    got = moe.moe_apply(tp, spec, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_top_k_ties_break_toward_the_lower_expert():
    """Equal gates: the port picks the experts ``jax.lax.top_k`` picks."""
    spec = moe.MoESpec(8, 16, 4, 2, capacity_factor=16.0)
    jp, tp = _layers(spec, seed=4)
    tp.router.data.zero_()
    tp.router.data[:, 3] = 1.0
    x = np.abs(np.random.RandomState(5).randn(1, 6, 8)).astype(np.float32)
    jp = dict(jp, router=jnp.asarray(tp.router.numpy()))
    j_top, _, _ = _j_route(jp, spec, jnp.asarray(x))
    _, top_e, _, _, _ = moe.route(tp, spec, torch.from_numpy(x)[0])
    np.testing.assert_array_equal(top_e.numpy(), j_top)
    assert (j_top[:, 1] == 0).all()         # ties among 0, 1, 2 -> 0


def test_moe_aux_loss_matches_jax():
    spec = moe.MoESpec(32, 48, 8, 2)
    jp, tp = _layers(spec, seed=6)
    x = np.random.RandomState(7).randn(3, 20, 32).astype(np.float32)
    want = float(jmoe.moe_aux_loss(jp, jmoe.MoESpec(*spec), jnp.asarray(x)))
    got = float(moe.moe_aux_loss(tp, spec, torch.from_numpy(x)))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_expert_capacity_matches_jax():
    for E, K, cf in ((8, 2, 1.25), (16, 2, 1.25), (8, 2, 4.0), (4, 2, 16.0)):
        spec = moe.MoESpec(8, 8, E, K, capacity_factor=cf)
        for n in (1, 4, 7, 100, 4100, 16360):
            assert moe.expert_capacity(spec, n) == \
                jmoe.expert_capacity(jmoe.MoESpec(*spec), n), (E, cf, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch):
    jfull, tfull = j_get_config(arch), get_config(arch)
    assert_config_is_jaxs(tfull, jfull)
    assert arch in ARCH_IDS and len(ARCH_IDS) == 11
    assert tfull.family == "moe"
    want = [jfull.window] * 32 if arch == "mixtral-8x7b" \
        else [1 << 30] * 32
    assert layer_windows(tfull) == want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq_len,lanes,page_size,kw", [
    (4608, 4, 16, {}), (4352, 4, 16, {}), (4352, 4, 16, dict(stash_size=0)),
    (256, 4, 8, {}), (96, 2, 4, {}), (2048, 64, 16, {}),
    (8192, 2, 64, dict(stash_size=4))])
def test_make_paged_config_matches_jax(arch, seq_len, lanes, page_size, kw):
    """Field for field, the full configs and their smoke reductions
    (window 64); the port's split-cache fields (which the JAX config
    lacks) stay at their defaults: one pool."""
    for jcfg, cfg in ((j_get_config(arch), get_config(arch)),
                      (j_smoke_config(arch), smoke_config(arch))):
        jkv = j_make_paged_config(jcfg, seq_len, lanes, page_size=page_size,
                                  dtype=jnp.float32, **kw)
        tkv = make_paged_config(cfg, seq_len, lanes, page_size=page_size,
                                dtype=torch.float32, **kw)
        jnames = {f.name for f in dataclasses.fields(jkv)}
        for f in dataclasses.fields(tkv):
            if f.name in jnames and f.name != "dtype":
                assert getattr(tkv, f.name) == getattr(jkv, f.name), f.name
            elif f.name not in jnames:
                assert getattr(tkv, f.name) == f.default, f.name


def test_mixtral_paged_sizing_recycles():
    """mixtral at 4 lanes of 16-token pages and seq_len 4608: 1536 pages
    for ceil(4096 / 16) + 2 = 258 live pages a lane, the table addressing
    289 pages, the stash tuned to the window (10, 2, 8)."""
    kv = make_paged_config(get_config("mixtral-8x7b"), 4608, 4, page_size=16)
    assert (kv.num_pages, kv.max_pages_per_lane) == (1536, 289)
    assert (kv.stash_size, kv.stash_watermark, kv.stash_refill) == (10, 2, 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    """The smoke model's logits and K/V over 80 tokens (mixtral's window of
    64 binds)."""
    jcfg, cfg = j_smoke_config(arch), smoke_config(arch)
    jparams = j_init_params(jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    assert tparams.layers[0].moe.router.dtype == torch.float32
    toks = np.random.RandomState(8).randint(0, cfg.vocab_size, (2, 80)
                                            ).astype(np.int32)
    jl, (jk, jv) = j_forward(jparams, jcfg, jnp.asarray(toks),
                             return_kv=True)
    tl, (tk, tv) = forward(tparams, torch.from_numpy(toks), return_kv=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-4)


def test_bf16_model_keeps_an_f32_router():
    """The router is f32 in a bf16 model, loaded from a bf16 JAX tree and
    drawn by ``init_params``; the expert weights take the model dtype."""
    from repro_torch.models import init_params
    jcfg, cfg = j_smoke_config(ARCHS[0]), smoke_config(ARCHS[0])
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, dtype=jnp.bfloat16))
    assert tree["layers"]["moe"]["router"].dtype == np.float32
    wide = jax.tree.map(lambda a: a.astype(np.float32), tree)
    for model in (params_from_numpy(wide, cfg, dtype=torch.bfloat16,
                                    device="cpu"),
                  init_params(cfg, seed=0, device="cpu")):
        blk = model.layers[1].moe
        assert blk.router.dtype == torch.float32
        assert blk.w_in.dtype == blk.w_out.dtype == torch.bfloat16
        assert tuple(blk.w_in.shape) == (cfg.num_experts, cfg.d_model,
                                         2 * cfg.d_ff)
    x = torch.randn(1, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0)).to(torch.bfloat16)
    out = moe.moe_apply(model.layers[0].moe, moe.spec_of(cfg), x)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
