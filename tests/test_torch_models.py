"""The port's dense LM against the JAX package at the smoke config in f32.

The JAX parameters carry across through ``params_from_numpy``; logits must
agree within rtol = atol = 2e-4 (f32 sums taken in another order).  The
port's own paged decode must reproduce its full-sequence forward, as
``tests/test_serve_equivalence.py::test_decode_matches_forward`` checks
for the JAX package.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.transformer import forward as j_forward  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core.freelist import validate_freelist  # noqa: E402
from repro_torch.models import (init_params, make_paged_config,  # noqa: E402
                                params_from_numpy)
from repro_torch.models.transformer import forward  # noqa: E402
from repro_torch.serve.engine import ServingEngine  # noqa: E402

ARCH = "deepseek-7b"
TOL = 2e-4


@pytest.fixture(scope="module")
def models():
    cfg = smoke_config(ARCH)
    jparams = j_init_params(j_smoke_config(ARCH), dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    return cfg, jparams, tparams


def test_configs_match_jax():
    from repro.configs import get_config as j_get_config
    jfull, tfull = j_get_config(ARCH), get_config(ARCH)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "rope_theta", "norm", "act"):
        assert getattr(tfull, f) == getattr(jfull, f), f
    js, ts = j_smoke_config(ARCH), smoke_config(ARCH)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim"):
        assert getattr(ts, f) == getattr(js, f), f


@pytest.mark.parametrize("batch,seq", [(1, 5), (2, 17), (3, 40)])
def test_forward_logits_match_jax(models, batch, seq):
    cfg, jparams, tparams = models
    toks = np.random.RandomState(seq).randint(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    ref = np.asarray(j_forward(jparams, j_smoke_config(ARCH),
                               jnp.asarray(toks), remat=False))
    got = forward(tparams, torch.from_numpy(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_forward_kv_matches_jax(models):
    """The prefill's per-layer K/V (what admission writes into pages)."""
    cfg, jparams, tparams = models
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                            (2, 9)).astype(np.int32)
    _, (jk, jv) = j_forward(jparams, j_smoke_config(ARCH), jnp.asarray(toks),
                            remat=False, return_kv=True)
    _, (tk, tv) = forward(tparams, torch.from_numpy(toks), return_kv=True)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)


def test_decode_matches_forward(models, rng):
    """Paged decode logits == full-sequence forward logits, the JAX test's
    criterion (max error relative to max |logit| below 2e-3)."""
    cfg, _, tparams = models
    n_prefill, n_decode = 7, 4
    toks = rng.randint(0, cfg.vocab_size,
                       size=(n_prefill + n_decode,)).astype(np.int32)
    kvcfg = make_paged_config(cfg, seq_len=64, lanes=2, page_size=4,
                              dtype=torch.float32)
    eng = ServingEngine(cfg, kvcfg, tparams, device="cpu")
    assert eng.admit(0, toks[:n_prefill])
    validate_freelist(eng.state.paged.alloc)
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
    validate_freelist(eng.state.paged.alloc)
    assert max(errs) < 2e-3, errs


def test_init_params_is_seeded():
    cfg = smoke_config(ARCH)
    a = init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    b = init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    c = init_params(cfg, seed=4, dtype=torch.float32, device="cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
        assert not x.requires_grad
    assert not torch.equal(a.layers[0].wq, c.layers[0].wq)
