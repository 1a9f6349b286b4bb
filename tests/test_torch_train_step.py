"""AdamW, gradient compression and the train step of the port against the
JAX package, on the CPU, in f32.

AdamW is held on shared gradients: at step 1, ``m_hat / sqrt(v_hat)`` is
about ``sign(g)``, so a gradient of 1e-9 in one package and -1e-9 in the
other would move a parameter by ``2 * lr``; the same numpy gradients go
to both, and the gradients are held apart (``test_torch_train_grads*``).
Tolerances: parameters, ``m`` and ``v`` within 1e-6 relative (rtol 1e-6,
atol 1e-6 of each leaf's max); the gradient norm within 1e-6 relative;
compression bit for bit (both round half to even; the blocks run over the
JAX tree's stacked leaves); the train step as its test says.
"""
import pytest

torch = pytest.importorskip("torch")

from typing import NamedTuple  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _train_parity import (at, configs, leaves_with_paths,  # noqa: E402
                           numpy_batch, seeded_tree, to_jax, to_torch)
from repro.distributed.compression import CompressionConfig as JCompression  # noqa: E402
from repro.distributed.compression import ErrorFeedback as JErrorFeedback  # noqa: E402
from repro.distributed.compression import _quantize_dequantize as j_qd  # noqa: E402
from repro.distributed.compression import compress_decompress as j_compress  # noqa: E402
from repro.train.optimizer import AdamW as JAdamW  # noqa: E402
from repro.train.train_step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.distributed.compression import (CompressionConfig,  # noqa: E402
                                                 _quantize_dequantize,
                                                 compress_decompress,
                                                 init_error_feedback)
from repro_torch.models import (abstract_params, jax_layout,  # noqa: E402
                                params_from_numpy, params_to_numpy,
                                port_layout)
from repro_torch.train.optimizer import AdamW, AdamWState  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402


def _close_trees(got: dict, want: dict, rtol: float, atol_rel: float):
    bad = []
    for path, w in leaves_with_paths(want):
        g = np.asarray(at(got, path))
        tol = atol_rel * max(float(np.abs(w).max()), 1e-30)
        if not np.allclose(g, w, rtol=rtol, atol=tol):
            bad.append(f"{'/'.join(path)}: {np.abs(g - w).max():.3e}")
    assert not bad, bad


def _grads(jcfg, tree, scale: float, seed: int = 7) -> dict:
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (scale * rng.randn(*a.shape)).astype(np.float32), tree)


def _named(cfg, tree: dict) -> dict:
    """A numpy JAX tree -> ``{parameter name: tensor}``."""
    return {n: torch.from_numpy(np.array(a)) for n, a in
            port_layout(tree, dict(abstract_params(cfg).named_parameters())
                        ).items()}


@pytest.mark.parametrize("arch,grad_scale", [
    ("deepseek-7b", 1e-3),          # global norm below the clip
    ("deepseek-7b", 0.5),           # clipped
    ("zamba2-1.2b", 0.5),           # f32 leaves beside the model dtype
    ("whisper-medium", 1e-3)])
def test_adamw_matches_jax_on_shared_gradients(arch, grad_scale):
    """Three updates from the same numpy gradients in both packages."""
    jcfg, cfg = configs(arch)
    tree = seeded_tree(jcfg)
    opt, jopt = AdamW(lr=1e-3), JAdamW(lr=1e-3)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    model = params_from_numpy(tree, cfg, device="cpu")
    state = opt.init(model)
    for it in range(3):
        g = _grads(jcfg, tree, grad_scale, seed=it)
        jparams, jstate, jn = jopt.update(jax.tree.map(jnp.asarray, g),
                                          jstate, jparams)
        state, gn = opt.update(_named(cfg, g), state, model)
        assert abs(float(gn) - float(jn)) <= 1e-6 * float(jn)
        if grad_scale > 0.1:
            assert float(jn) > opt.grad_clip     # the clip binds
    assert int(state.step) == int(jstate.step) == 3
    _close_trees(params_to_numpy(model), jax.tree.map(np.asarray, jparams),
                 1e-6, 1e-6)
    for mine, theirs in ((state.m, jstate.m), (state.v, jstate.v)):
        _close_trees(jax_layout(mine), jax.tree.map(np.asarray, theirs),
                     1e-6, 1e-6)


def test_adamw_bias_correction_uses_an_f32_step():
    """``b1 ** step`` in f32, as the JAX optimizer: at step 3 its
    correction differs from the float64 one in the last bits."""
    opt = AdamW(b1=0.9)
    p = torch.nn.Linear(1, 1, bias=False).requires_grad_(False)
    p.weight.data = torch.ones(1, 1)
    state = AdamWState(step=torch.tensor(2, dtype=torch.int32),
                       m={"weight": torch.zeros(1, 1)},
                       v={"weight": torch.zeros(1, 1)})
    jp, jstate = {"weight": jnp.ones((1, 1))}, JAdamW(b1=0.9).init(
        {"weight": jnp.ones((1, 1))})
    jstate = jstate._replace(step=jnp.int32(2))
    g = np.full((1, 1), 0.25, np.float32)
    jp, jstate, _ = JAdamW(b1=0.9).update({"weight": jnp.asarray(g)}, jstate,
                                          jp)
    opt.update({"weight": torch.from_numpy(g)}, state, p)
    assert p.weight.item() == float(jp["weight"][0, 0])


@pytest.mark.parametrize("n,block", [(1000, 256), (256, 256), (7, 4)])
def test_quantize_dequantize_bit_for_bit(n, block):
    rng = np.random.RandomState(n)
    g = (rng.randn(n) * rng.choice([1e-6, 1.0, 1e3], n)).astype(np.float32)
    g[::13] = 0.0
    g[1::17] = -0.0
    got = _quantize_dequantize(torch.from_numpy(g), 8, block).numpy()
    want = np.asarray(j_qd(jnp.asarray(g), 8, block))
    assert got.tobytes() == want.tobytes()


def test_compression_with_error_feedback_bit_for_bit():
    """Three rounds with the residual carried in the state, and the
    stateless path (an ``AdamWState`` has no ``ef``): every gradient and
    residual bit for bit."""
    jcfg, cfg = configs("gemma3-1b")
    tree = seeded_tree(jcfg)
    model = params_from_numpy(tree, cfg, device="cpu")
    ccfg, jccfg = CompressionConfig(enabled=True), JCompression(enabled=True)

    class WithEF(NamedTuple):        # a state with an ``ef`` field
        ef: object
    state = WithEF(ef=init_error_feedback(model))
    jstate = WithEF(ef=JErrorFeedback(residual=jax.tree.map(
        lambda a: jnp.zeros(a.shape, jnp.float32), tree)))
    for it in range(3):
        g = _grads(jcfg, tree, 1e-2, seed=10 + it)
        jg, jstate = j_compress(jax.tree.map(jnp.asarray, g), jstate, jccfg)
        pg, state = compress_decompress(_named(cfg, g), state, ccfg)
        for mine, theirs in ((jax_layout(pg), jg),
                             (jax_layout(state.ef.residual),
                              jstate.ef.residual)):
            for path, w in leaves_with_paths(jax.tree.map(np.asarray,
                                                          theirs)):
                assert at(mine, path).numpy().tobytes() == w.tobytes(), path
    g = _grads(jcfg, tree, 1e-2, seed=20)
    jg, _ = j_compress(jax.tree.map(jnp.asarray, g), JAdamW().init(
        jax.tree.map(jnp.asarray, tree)), jccfg)
    plain = AdamW().init(model)
    pg, same = compress_decompress(_named(cfg, g), plain, ccfg)
    assert same is plain
    for path, w in leaves_with_paths(jax.tree.map(np.asarray, jg)):
        assert at(jax_layout(pg), path).numpy().tobytes() == w.tobytes()


@pytest.mark.parametrize("arch,compress", [("deepseek-7b", False),
                                           ("rwkv6-7b", True)])
def test_train_step_with_grad_accum_matches_jax(arch, compress):
    """``make_train_step(grad_accum=2)`` from the same parameters and batch
    in both packages: the loss, the gradient norm, the gradient the update
    applied (``m / (1 - b1)`` after one step) and every parameter.

    The gradients are computed apart, so the applied gradient is held
    within rtol 1e-4, atol 1e-6 of each leaf's max, and with compression
    within one quantum of its block (max |g| / 127: a value near a rounding
    boundary may round the other way); each parameter moves at most one
    step of ``lr`` away from JAX's (at step 1 the update is about
    ``sign(g)``, and a near-zero gradient may flip it)."""
    jcfg, cfg = configs(arch)
    tree = seeded_tree(jcfg)
    batch = numpy_batch(jcfg, B=4, S=24)
    lr = 1e-3
    jopt, opt = JAdamW(lr=lr), AdamW(lr=lr)
    comp = dict(compression=CompressionConfig(enabled=True)) if compress \
        else {}
    jcomp = dict(compression=JCompression(enabled=True)) if compress else {}
    jparams = jax.tree.map(jnp.asarray, tree)
    jp, jstate, jm = j_make_train_step(jcfg, jopt, grad_accum=2, **jcomp)(
        jparams, jopt.init(jparams), to_jax(batch))
    model = params_from_numpy(tree, cfg, device="cpu").requires_grad_(True)
    step = make_train_step(cfg, opt, grad_accum=2, **comp)
    model, state, m = step(model, opt.init(model), to_torch(batch))
    assert set(m) == set(jm) == {"loss", "grad_norm"}
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) \
        <= 1e-4 * float(jm["grad_norm"])
    assert all(p.grad is None for p in model.parameters())
    _close_trees(jax_layout(state.m), jax.tree.map(np.asarray, jstate.m),
                 1e-4, 1 / 127 if compress else 1e-6)
    got = params_to_numpy(model)
    for path, w in leaves_with_paths(jax.tree.map(np.asarray, jp)):
        # one step: (1 + weight_decay * |p|) * lr at most, both sides
        bound = 2 * lr * (1 + opt.weight_decay * np.abs(w).max()) + 1e-7
        assert np.abs(at(got, path) - w).max() <= bound, path


def test_train_step_without_accumulation_reports_tokens():
    """``grad_accum=1``: the metrics of ``loss_fn`` (loss, tokens) and the
    gradient norm, as the JAX step returns them."""
    jcfg, cfg = configs("gemma3-1b")
    tree = seeded_tree(jcfg)
    batch = numpy_batch(jcfg, B=2, S=16)
    jopt, opt = JAdamW(), AdamW()
    jparams = jax.tree.map(jnp.asarray, tree)
    _, _, jm = j_make_train_step(jcfg, jopt)(jparams, jopt.init(jparams),
                                             to_jax(batch))
    model = params_from_numpy(tree, cfg, device="cpu").requires_grad_(True)
    _, state, m = make_train_step(cfg, opt)(model, opt.init(model),
                                            to_torch(batch))
    assert set(m) == set(jm) == {"loss", "tokens", "grad_norm"}
    assert int(m["tokens"]) == int(jm["tokens"])
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    assert int(state.step) == 1
