"""The hybrid family (zamba2: Mamba2 layers and one shared attention block)
in the port, on the CPU, against the JAX package, in f32 with the JAX
parameters carried across by ``params_from_numpy``.

Two configurations: ``smoke_config("zamba2-1.2b")`` (2 layers, the shared
block once) and a reduced depth of 4 layers with ``attn_every`` 2 (two
applications of the shared block, two KV layers).  Prompts come from
``RandomState`` seeds.

* ``HybridLM`` forward and the family prefill (K/V of each shared-block
  application, per-layer SSD states and conv tails) against the JAX
  package's, rtol = atol = 1e-4 (f32, sums in another order).
* The decode teacher-forced against the full forward, max |decode -
  forward| / max |logit| <= 2e-4.
* The synthetic pre-admitted decode state, and the launcher's CPU path.

``test_torch_hybrid_engine.py`` holds the engine against the JAX engine
and the double fold of the last prompt token,
``test_torch_hybrid_alloc.py`` the failed admission and the prefix cache,
``test_torch_hybrid_multi.py`` two shards against the JAX
``MultiEngine``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import make_paged_config as j_make_paged_config  # noqa: E402
from repro.models.transformer import forward as j_forward  # noqa: E402
from repro.serve.serve_step import make_family_prefill as j_prefill  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.freelist import FreeListState  # noqa: E402
from repro_torch.models import make_paged_config, params_from_numpy  # noqa: E402
from repro_torch.models.transformer import (HybridLM, forward,  # noqa: E402
                                            hybrid_kv_slots)
from repro_torch.serve.engine import ServingEngine  # noqa: E402
from repro_torch.serve.serve_step import make_family_prefill  # noqa: E402

ARCH = "zamba2-1.2b"
TOL = dict(rtol=1e-4, atol=1e-4)
DEPTHS = {"smoke": {}, "reduced": dict(num_layers=4, attn_every=2)}
PAGED = dict(seq_len=48, lanes=2, page_size=4)


def _configs(depth):
    jcfg = dataclasses.replace(j_smoke_config(ARCH), **DEPTHS[depth])
    cfg = dataclasses.replace(smoke_config(ARCH), **DEPTHS[depth])
    return jcfg, cfg


@pytest.fixture(scope="module", params=list(DEPTHS))
def model(request):
    jcfg, cfg = _configs(request.param)
    jparams = j_init_params(jcfg, dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                device="cpu")
    return request.param, jcfg, cfg, jparams, tparams


def _alloc_diff(t_alloc, j_alloc) -> list[str]:
    return [f for f in FreeListState._fields
            if not np.array_equal(getattr(t_alloc, f).numpy(),
                                  np.asarray(getattr(j_alloc, f)))]


def test_forward_and_prefill_match_jax(model):
    depth, jcfg, cfg, jparams, tparams = model
    assert isinstance(tparams, HybridLM)
    n_kv = cfg.num_layers // cfg.attn_every
    assert [hybrid_kv_slots(cfg)[i] for i in range(cfg.num_layers)
            if i % cfg.attn_every == cfg.attn_every - 1] == list(range(n_kv))
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (2, 19)).astype(np.int32)
    jl = jax.jit(lambda p, t: j_forward(p, jcfg, t, remat=False))(
        jparams, jnp.asarray(toks))
    np.testing.assert_allclose(forward(tparams, torch.as_tensor(toks)).numpy(),
                               np.asarray(jl), **TOL)
    batch = {"tokens": toks, "lengths": np.full((2,), 19, np.int32)}
    # the engine's prefill: no logits (decode is seeded with the last
    # prompt token)
    jr = jax.jit(j_prefill(jcfg, recurrent_logits=False))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tr = make_family_prefill(cfg)(tparams, {k: torch.as_tensor(v)
                                            for k, v in batch.items()})
    assert tr.last_logits is None and jr.last_logits is None
    assert tr.kv[0].shape == (2, n_kv, 19, cfg.num_kv_heads,
                              cfg.resolved_head_dim)
    for t, j, what in ((tr.kv[0], jr.kv[0], "k"), (tr.kv[1], jr.kv[1], "v"),
                       (tr.states.ssm, jr.states.ssm, "ssm"),
                       (tr.states.conv, jr.states.conv, "conv")):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL,
                                   err_msg=what)


def test_decode_matches_forward_teacher_forced(model):
    """The JAX package's equivalence test on the port: after a 7-token
    admission, 4 decode steps fed the given tokens (the seed overwritten,
    so no token is folded twice) equal the full forward's last logits."""
    _, _, cfg, _, tparams = model
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, 11).astype(np.int32)
    kvcfg = make_paged_config(cfg, seq_len=64, lanes=2, page_size=4,
                              dtype=torch.float32)
    eng = ServingEngine(cfg, kvcfg, tparams, device="cpu")
    assert eng.admit(0, toks[:7])
    errs = []
    for t in range(4):
        tokens = eng.state.tokens.clone()
        tokens[0] = int(toks[7 + t])
        eng.state = eng.state._replace(tokens=tokens)
        eng.state, logits, _ = eng._decode(eng.params, eng.state)
        ref = forward(tparams, torch.as_tensor(toks[:8 + t])[None])[0, -1]
        errs.append(float((logits[0] - ref).abs().max() / ref.abs().max()))
    assert max(errs) <= 2e-4, errs


def test_launcher_serves_the_hybrid_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
          "--lanes", "2", "--max-new-tokens", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out
    assert "state_slots: used=0/2" in out


def test_init_serve_state_matches_jax():
    """The synthetic pre-admitted decode state of the hybrid: the JAX
    package's allocator metadata and tables over three classes, and a zero
    recurrent state of its shapes (SSD state f32, conv tail in the model
    dtype)."""
    from repro.serve.serve_step import init_serve_state as j_init_serve_state
    from repro_torch.core.paged_kv import paged_tenants
    from repro_torch.serve.serve_step import init_serve_state
    jcfg, cfg = _configs("reduced")
    jkv = j_make_paged_config(jcfg, dtype=jnp.float32, **PAGED)
    tkv = make_paged_config(cfg, dtype=torch.float32, **PAGED)
    js = j_init_serve_state(jcfg, jkv, 2, 9, dtype=jnp.float32)
    ts = init_serve_state(cfg, tkv, 2, paged_tenants(tkv, "cpu"), 9)
    assert not _alloc_diff(ts.paged.alloc, js.paged.alloc)
    assert ts.paged.alloc.free_top.shape == (3,)
    for f in ("block_tables", "seq_lens", "active"):
        np.testing.assert_array_equal(getattr(ts.paged, f).numpy(),
                                      np.asarray(getattr(js.paged, f)))
    for f in ("ssm", "conv"):
        t, j = getattr(ts.rec, f), getattr(js.rec, f)
        assert tuple(t.shape) == j.shape and not t.any()
    assert ts.rec.ssm.dtype == torch.float32
