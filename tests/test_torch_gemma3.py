"""gemma3-1b (local:global windows, GQA 4:1, GeGLU, tied embeddings) in the
port against the JAX package, at ``smoke_config("gemma3-1b")`` with
``local_per_global=1`` -- layer 0 local (window 64), layer 1 global -- in
f32, with the JAX parameters carried across through ``params_from_numpy``.

Sequences are longer than the window, so the local layer masks in prefill
and in decode.  Logits and K/V within rtol = atol = 2e-4 (f32 sums in
another order); served tokens equal; allocator state bit-identical.
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
from repro.models.transformer import forward as j_forward  # noqa: E402
from repro.models.transformer import layer_windows as j_layer_windows  # noqa: E402
from repro.serve.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core.freelist import FreeListState  # noqa: E402
from repro_torch.core.paged_kv import validate_paged_kv  # noqa: E402
from repro_torch.models import make_paged_config, params_from_numpy  # noqa: E402
from repro_torch.models.transformer import forward, layer_windows  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402

ARCH = "gemma3-1b"
TOL = 2e-4


def configs():
    return (dataclasses.replace(j_smoke_config(ARCH), local_per_global=1),
            dataclasses.replace(smoke_config(ARCH), local_per_global=1))


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = configs()
    jparams = j_init_params(jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    return jcfg, cfg, jparams, tparams


def test_config_and_windows_match_jax():
    jfull, tfull = j_get_config(ARCH), get_config(ARCH)
    for f in dataclasses.fields(jfull):
        assert getattr(tfull, f.name) == getattr(jfull, f.name), f.name
    for jc, tc in ((jfull, tfull), configs()):
        assert layer_windows(tc) == np.asarray(j_layer_windows(jc)).tolist()
    assert layer_windows(configs()[1]) == [64, 1 << 30]


def test_forward_logits_and_kv_match_jax(models):
    jcfg, cfg, jparams, tparams = models
    toks = np.random.RandomState(5).randint(
        0, cfg.vocab_size, (2, 90)).astype(np.int32)
    jl, (jk, jv) = j_forward(jparams, jcfg, jnp.asarray(toks), remat=False,
                             return_kv=True)
    tl, (tk, tv) = forward(tparams, torch.from_numpy(toks), return_kv=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)


def test_decode_matches_forward(models, rng):
    """Paged decode logits == forward logits past the window (the JAX
    criterion: max error relative to max |logit| below 2e-3), across a
    page boundary."""
    _, cfg, _, tparams = models
    n_prefill, n_decode = 70, 4
    toks = rng.randint(0, cfg.vocab_size,
                       size=(n_prefill + n_decode,)).astype(np.int32)
    kvcfg = make_paged_config(cfg, seq_len=128, lanes=2, page_size=8,
                              dtype=torch.float32)
    eng = ServingEngine(cfg, kvcfg, tparams, device="cpu")
    assert eng.admit(0, toks[:n_prefill])
    errs = []
    for t in range(n_decode):
        tokens = eng.state.tokens.clone()
        tokens[0] = int(toks[n_prefill + t])
        eng.state = eng.state._replace(tokens=tokens)
        eng.state, logits, _ = eng._decode(eng.params, eng.state)
        ref = forward(tparams, torch.from_numpy(
            toks[: n_prefill + t + 1])[None])[0, -1]
        errs.append(float((logits[0] - ref).abs().max()
                          / (ref.abs().max() + 1e-9)))
    assert max(errs) < 2e-3, errs


def test_paged_config_matches_jax():
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    for seq, lanes, ps in ((2048, 4, 16), (256, 2, 8)):
        j = j_make_paged_config(jcfg, seq_len=seq, lanes=lanes, page_size=ps)
        t = make_paged_config(cfg, seq_len=seq, lanes=lanes, page_size=ps)
        for f in ("num_kv_layers", "kv_heads", "head_dim", "page_size",
                  "num_pages", "max_lanes", "max_pages_per_lane",
                  "stash_size", "stash_watermark", "stash_refill",
                  "scratch_slots"):
            assert getattr(t, f) == getattr(j, f), (seq, f)


def test_engine_matches_jax_engine(models):
    """Prompts of 70 and 90 tokens (window 64), 6 decode steps, lane 0
    released: tokens equal each step; allocator state, block tables and
    stash bit-identical; invariants hold."""
    jcfg, cfg, jparams, tparams = models
    stash = dict(stash_size=4, stash_watermark=1, stash_refill=2)
    jkv = j_make_paged_config(jcfg, seq_len=128, lanes=2, page_size=8,
                              dtype=jnp.float32, **stash)
    tkv = make_paged_config(cfg, seq_len=128, lanes=2, page_size=8,
                            dtype=torch.float32, **stash)
    jeng = JEngine(jcfg, jkv, jparams, dtype=jnp.float32, alloc_backend="jnp")
    teng = ServingEngine(cfg, tkv, tparams, device="cpu")
    rng = np.random.RandomState(1)
    for lane, n in enumerate((70, 90)):
        p = rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
        assert jeng.admit(lane, p) and teng.admit(lane, p)
    np.testing.assert_array_equal(teng.state.tokens.numpy(),
                                  np.asarray(jeng.state.tokens))
    for i in range(6):
        np.testing.assert_array_equal(teng.step(), np.asarray(jeng.step()),
                                      err_msg=f"decode step {i}")
    jeng.release([0])
    teng.release([0])
    jp, tp = jeng.state.paged, teng.state.paged
    for field in FreeListState._fields:
        np.testing.assert_array_equal(getattr(tp.alloc, field).numpy(),
                                      np.asarray(getattr(jp.alloc, field)),
                                      err_msg=field)
    for field in ("block_tables", "seq_lens", "active", "scratch_slot"):
        np.testing.assert_array_equal(getattr(tp, field).numpy(),
                                      np.asarray(getattr(jp, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(tp.stash.pages.numpy(),
                                  np.asarray(jp.stash.pages))
    validate_paged_kv(teng.kvcfg, tp, teng.tenants)
