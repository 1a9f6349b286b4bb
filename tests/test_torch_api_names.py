"""The last public names of the JAX API in the port, each against its JAX
counterpart on the CPU at smoke sizes, inputs from numpy seeds.

* ``BurstStats`` and ``DecodeStats`` forward ``mallocs``, ``frees``,
  ``blocks_allocated`` and ``blocks_freed`` (and ``failed``) to their
  core stats: equal integers to JAX's on one admission burst and one
  decode step whose burst both mallocs a page and frees a recycled one.
* ``KV_CLASS``/``STATE_CLASS``, ``PagedKVConfig.tokens_capacity``,
  ``LaneStashState.max_lanes``, ``RequestQueue.capacity`` and
  ``ResponseQueue.capacity``: equal values.
* ``decode_attention``, ``paged_decode_attention`` (with JAX's ``pos``
  and ``gathered_valid``), ``embed``/``unembed`` (tied and untied),
  ``mamba2_forward`` and ``moe_layer_aux``: within 1e-5 relative in f32,
  on parameters carried across by ``params_from_numpy``.
* The zero decode states of Mamba2 and RWKV6 and ``AdamW.abstract_init``
  (on ``meta``): equal shapes and dtypes.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.paged_kv as jpkv  # noqa: E402
from repro.core.lane_stash import init_stash as j_init_stash  # noqa: E402
from repro.core.packets import make_queue as j_make_queue  # noqa: E402
import repro_torch.core.paged_kv as pkv  # noqa: E402
from repro_torch.core.lane_stash import init_stash  # noqa: E402
from repro_torch.core.packets import ResponseQueue, make_queue  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402

from _train_parity import configs, seeded_tree  # noqa: E402

RTOL = 1e-5
FORWARDED = ("mallocs", "frees", "blocks_allocated", "blocks_freed")


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, (what, err, scale)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# ---------------------------------------------------------------- stats --

def test_stats_forwarders_equal_jax_on_a_burst_and_a_decode_step():
    """Lane 0 admitted at 12 tokens (pages of 4, window 8, no stash): its
    first decode step writes position 12, a new page (a malloc), and page
    0 slides out of the window (a single free in the same burst)."""
    base = dict(num_kv_layers=2, kv_heads=1, head_dim=4, page_size=4,
                num_pages=32, max_lanes=2, max_pages_per_lane=8)
    jcfg = jpkv.PagedKVConfig(dtype=jnp.float32, **base)
    cfg = pkv.PagedKVConfig(dtype=torch.float32, **base)
    tenants = pkv.paged_tenants(cfg, "cpu")
    rng = np.random.RandomState(0)
    k = rng.randn(2, 12, 1, 4).astype(np.float32)
    jst, jburst = jpkv.admit_prefill(jcfg, jpkv.init_paged_kv(jcfg),
                                     jnp.int32(0), jnp.asarray(k),
                                     jnp.asarray(k), jnp.int32(12))
    st, burst = pkv.admit_prefill(cfg, pkv.init_paged_kv(cfg, tenants), 0,
                                  torch.from_numpy(k), torch.from_numpy(k),
                                  12, tenants)
    nk = rng.randn(2, 2, 1, 4).astype(np.float32)
    jdec = jax.jit(lambda s, a: jpkv.decode_append(jcfg, s, a, a, window=8))(
        jst, jnp.asarray(nk))[1]
    dec = pkv.decode_append(cfg, st, torch.from_numpy(nk),
                            torch.from_numpy(nk), tenants, window=8)[1]
    assert int(burst.mallocs) > 0 and int(dec.mallocs) > 0
    assert int(dec.frees) > 0
    for what, got, want in (("burst", burst, jburst), ("decode", dec, jdec)):
        for name in FORWARDED:
            assert int(getattr(got, name)) == int(getattr(want, name)), \
                (what, name)
            assert torch.equal(getattr(got, name), getattr(got.core, name))
    assert int(burst.failed) == int(jburst.failed)


def test_class_ids_and_shape_properties_equal_jax():
    assert (pkv.KV_CLASS, pkv.STATE_CLASS) == (jpkv.KV_CLASS,
                                               jpkv.STATE_CLASS)
    base = dict(num_kv_layers=2, kv_heads=1, head_dim=4, page_size=16,
                num_pages=40, max_lanes=3, max_pages_per_lane=8)
    assert pkv.PagedKVConfig(**base).tokens_capacity == \
        jpkv.PagedKVConfig(**base).tokens_capacity == 640
    for lanes, size in ((3, 4), (5, 0)):
        assert init_stash(lanes, size, "cpu").max_lanes == \
            j_init_stash(lanes, size).max_lanes == lanes
    args = ([1, 1, 2], [0, 1, 0], [0, 0, 1], [2, 1, 0])
    assert make_queue(*args, capacity=8).capacity == \
        j_make_queue(*args, capacity=8).capacity == 8
    resp = ResponseQueue(blocks=torch.zeros((5, 2), dtype=torch.int32),
                         status=torch.zeros((5,), dtype=torch.int32))
    from repro.core.packets import ResponseQueue as JResponseQueue
    jresp = JResponseQueue(blocks=jnp.zeros((5, 2), jnp.int32),
                           status=jnp.zeros((5,), jnp.int32))
    assert resp.capacity == jresp.capacity == 5


# ------------------------------------------------------------ attention --

@pytest.mark.parametrize("window,with_lens", [(None, False), (5, True),
                                              (5, False)])
def test_decode_attention_matches_jax(window, with_lens):
    from repro.models.attention import decode_attention as j_decode
    from repro_torch.models.attention import decode_attention
    rng = np.random.RandomState(1)
    B, S, H, KV, hd = 3, 19, 4, 2, 8
    q = rng.randn(B, H, hd).astype(np.float32)
    k, v = (rng.randn(B, S, KV, hd).astype(np.float32) for _ in range(2))
    lens = np.array([7, 19, 12], np.int32)
    valid = np.arange(S)[None, :] < lens[:, None]
    kw = dict(window=window, chunk=8)
    jkw = dict(kw, seq_lens=jnp.asarray(lens) if with_lens else None)
    tkw = dict(kw, seq_lens=torch.from_numpy(lens) if with_lens else None)
    want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(valid), **jkw)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(valid),
                           **tkw)
    _close(got, want, "decode_attention")


@pytest.mark.parametrize("window,windowed", [(1 << 30, False), (6, False),
                                             (6, True)])
def test_paged_decode_attention_matches_jax(window, windowed):
    """The decode's attention with the appended self column; ``windowed``
    passes a gather's own positions and validity (JAX's windowed gather
    layout), the rest the default ``arange``."""
    from repro.models.decode import paged_decode_attention as j_paged
    from repro_torch.models.decode import paged_decode_attention
    rng = np.random.RandomState(2)
    B, S, H, KV, hd = 3, 16, 4, 1, 8
    q = rng.randn(B, H, hd).astype(np.float32)
    kg, vg = (rng.randn(B, S, KV, hd).astype(np.float32) for _ in range(2))
    kn, vn = (rng.randn(B, KV, hd).astype(np.float32) for _ in range(2))
    lens = np.array([9, 15, 4], np.int32)
    active = np.array([True, True, False])
    extra = {}
    if windowed:
        pos = (lens[:, None] - S + np.arange(S)[None, :]).astype(np.int32)
        extra = dict(pos=pos, gathered_valid=pos >= 0)
    want = j_paged(*(jnp.asarray(a) for a in (q, kg, vg, kn, vn, lens,
                                               active)), window,
                   **{k: jnp.asarray(a) for k, a in extra.items()})
    got = paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kg, vg, kn, vn, lens, active)),
        window, **{k: torch.from_numpy(a) for k, a in extra.items()})
    _close(got, want, "paged_decode_attention")
    assert not got[2].any()                  # an inactive lane gives zeros


# ------------------------------------------------- layers, on parameters --

@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-7b"])
def test_embed_unembed_match_jax(arch):
    """gemma3-1b ties its embedding, deepseek-7b has a head of its own."""
    from repro.models import layers as jl
    from repro_torch.models import layers
    jcfg, cfg = configs(arch)
    tree = seeded_tree(jcfg)
    params = params_from_numpy(tree, cfg, device="cpu")
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    x = rng.randn(2, 5, cfg.d_model).astype(np.float32)
    tied = cfg.tie_embeddings
    assert tied == (arch == "gemma3-1b")
    head = "embed" if tied else "unembed"
    _close(layers.embed(params.embed, torch.from_numpy(tokens)),
           jl.embed(jnp.asarray(tree["embed"]), jnp.asarray(tokens)),
           "embed")
    _close(layers.unembed(getattr(params, head), torch.from_numpy(x), tied),
           jl.unembed(jnp.asarray(tree[head]), jnp.asarray(x), tied),
           "unembed")


def test_mamba2_forward_matches_jax():
    from repro.models import mamba2 as jm2
    from repro_torch.models import mamba2 as m2
    jcfg, cfg = configs("zamba2-1.2b")
    tree = seeded_tree(jcfg)
    params = params_from_numpy(tree, cfg, device="cpu")
    spec = m2.make_spec(cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim)
    jspec = jm2.make_spec(cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 21, cfg.d_model).astype(np.float32)
    h0 = rng.randn(2, spec.heads, spec.n_state,
                   spec.head_dim).astype(np.float32)
    j_forward = jax.jit(jm2.mamba2_forward, static_argnums=(1,))
    for init in (None, h0):
        want_y, want_s = j_forward(
            _layer0(tree["layers"]["mamba"]), jspec, jnp.asarray(x),
            None if init is None else jnp.asarray(init))
        got_y, got_s = m2.mamba2_forward(
            params.layers[0].mamba, spec, torch.from_numpy(x),
            None if init is None else torch.from_numpy(init))
        _close(got_y, want_y, "y")
        _close(got_s, want_s, "final state")


def test_moe_layer_aux_matches_jax():
    from repro.models.transformer import moe_layer_aux as j_aux
    from repro_torch.models.transformer import moe_layer_aux
    jcfg, cfg = configs("mixtral-8x7b")
    tree = seeded_tree(jcfg)
    params = params_from_numpy(tree, cfg, device="cpu")
    x = np.random.RandomState(5).randn(2, 9, cfg.d_model).astype(np.float32)
    for li in range(cfg.num_layers):
        want = j_aux(jcfg, jax.tree.map(lambda a: a[li], tree["layers"]),
                     jnp.asarray(x))
        got = moe_layer_aux(cfg, params.layers[li], torch.from_numpy(x))
        assert float(got) > 0
        _close(got, want, f"moe_layer_aux layer {li}")


# ------------------------------------------------- shapes and dtypes only --

def _shapes(tree) -> list:
    return [(tuple(a.shape), np.dtype(str(a.dtype).replace("torch.", "")))
            for a in jax.tree.leaves(tree)]


def _state_shapes(state) -> list:
    return [(tuple(t.shape), np.dtype(str(t.dtype).replace("torch.", "")))
            for t in state]


@pytest.mark.parametrize("family", ["mamba2", "rwkv6"])
def test_zero_decode_states_match_jax(family):
    if family == "mamba2":
        from repro.models import mamba2 as jmod
        from repro_torch.models import mamba2 as mod
        jcfg, cfg = configs("zamba2-1.2b")
        args = (cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim)
        spec, jspec = mod.make_spec(*args), jmod.make_spec(*args)
    else:
        from repro.models import rwkv6 as jmod
        from repro_torch.models import rwkv6 as mod
        jcfg, cfg = configs("rwkv6-7b")
        args = (cfg.d_model, cfg.d_ff, cfg.resolved_head_dim)
        spec, jspec = mod.RWKV6Spec(*args), jmod.RWKV6Spec(*args)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = mod.init_decode_state(spec, 3, dtype, torch.device("cpu"))
        want = jmod.init_decode_state(jspec, 3, jdtype)
        assert got._fields == want._fields
        assert _state_shapes(got) == _shapes(tuple(want))
        assert all(not t.any() for t in got)


def test_adamw_abstract_init_matches_jax():
    """The state's leaves on ``meta``, in the JAX tree's layout, against
    JAX's ``eval_shape`` of its init."""
    from repro.models import init_params as j_init_params
    from repro.train.optimizer import AdamW as JAdamW
    from repro_torch.models import abstract_params, jax_layout
    from repro_torch.train.optimizer import AdamW
    jcfg, cfg = configs("deepseek-7b")
    want = JAdamW().abstract_init(j_init_params(jcfg, dtype=jnp.bfloat16))
    got = AdamW().abstract_init(abstract_params(cfg, dtype=torch.bfloat16))
    assert got.step.device.type == "meta"
    assert all(t.device.type == "meta" for t in (*got.m.values(),
                                                 *got.v.values()))
    assert _state_shapes([got.step]) == _shapes(want.step)
    for moments, jmoments in ((got.m, want.m), (got.v, want.v)):
        tree = jax_layout(moments)
        assert jax.tree.structure(jax.tree.map(lambda a: 0, tree)) == \
            jax.tree.structure(jax.tree.map(lambda a: 0, jmoments))
        assert _shapes(tree) == _shapes(jmoments)
