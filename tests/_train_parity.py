"""Shared set-up of the training parity tests (``tests/test_torch_train*``
and ``tests/test_torch_trainer.py``): both packages' reduced configs, the
JAX parameter tree with seeded values where its init has constants, and
numpy batches.

The reduced configs keep what ``smoke_config`` would hide, as
``chip_smoke.SMALL_DEPTH`` does: phi3-medium's G = 4, qwen2's G = 8 (with
its QKV bias), phi-3-vision's head dim 96, rwkv6's wkv heads of 64,
whisper's head dim 64 over 150 frames (no multiple of a chunk), zamba2 at
4 layers (the shared block twice) and gemma3 with one local and one global
layer (a window of 64 that the tests' 128-token sequences exceed, as they
exceed mixtral's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import init_params as j_init_params
from repro_torch.configs import smoke_config
from _port_only import SHARED_ARCH_IDS

REDUCED = {"zamba2-1.2b": dict(num_layers=4, attn_every=2),
           "gemma3-1b": dict(local_per_global=1),
           "phi3-medium-14b": dict(num_heads=8, num_kv_heads=2),
           "qwen2-72b": dict(num_heads=8, num_kv_heads=1),
           "phi-3-vision-4.2b": dict(head_dim=96),
           "rwkv6-7b": dict(head_dim=64),
           "whisper-medium": dict(head_dim=64, encoder_seq_len=150)}
#: tokens a batch row holds: gemma3's and mixtral's windows of 64 bind at
#: 128
SEQ = {"gemma3-1b": 128, "mixtral-8x7b": 128}
#: the archs the JAX package has (a port-only arch has no twin to train)
ARCHS = SHARED_ARCH_IDS


def configs(arch: str):
    """(JAX config, port config), reduced alike."""
    kw = REDUCED.get(arch, {})
    return (dataclasses.replace(j_smoke_config(arch), **kw),
            dataclasses.replace(smoke_config(arch), **kw))


def seeded_tree(jcfg, seed: int = 0, dtype=jnp.float32) -> dict:
    """The JAX init as a numpy tree, every constant leaf (zero QKV and MLP
    biases, zero bonus, zero decoder positions, unit LayerNorms, Mamba2's
    ``D``/``dt_bias``/``A_log``, RMSNorm scales) moved by seeded noise of
    0.1, so that its gradient and its effect are held too."""
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, seed=seed,
                                                  dtype=dtype))
    rng = np.random.RandomState(seed + 1)

    def move(a):
        if a.size and np.all(a == a.flat[0]):
            noise = 0.1 * rng.randn(*a.shape).astype(np.float32)
            return (a.astype(np.float32) + noise).astype(a.dtype)
        return a
    return jax.tree.map(move, tree)


def numpy_batch(jcfg, B: int = 2, S: int = 40, seed: int = 0,
                ignore: bool = True) -> dict:
    """Tokens, labels (the tokens rolled left; with ``ignore`` the first
    five of row 0 are ``IGNORE_LABEL``), patches (vlm: 4 rows) or frames
    (audio) from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, jcfg.vocab_size, (B, S)
                                   ).astype(np.int32)}
    if jcfg.family == "vlm":
        batch["patches"] = rng.randn(B, 4, jcfg.d_model).astype(np.float32)
    if jcfg.family == "audio":
        batch["frames"] = rng.randn(B, jcfg.encoder_seq_len, jcfg.d_model
                                    ).astype(np.float32)
    labels = np.roll(batch["tokens"], -1, axis=1)
    if ignore:
        labels[0, :5] = -1
    batch["labels"] = labels
    return batch


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def leaves_with_paths(tree: dict):
    """``[(path tuple, numpy leaf)]`` of a nested dict."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append((tuple(k.key for k in path), np.asarray(leaf)))
    return out


def at(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


#: the aims of the gradient parity (f32): the loss relative, each
#: gradient's max |difference| relative to its max |g|
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def check_loss_and_grads(arch: str) -> None:
    """``loss_fn`` and every gradient of the port against
    ``jax.value_and_grad(repro.models.model_zoo.loss_fn)`` at the reduced
    config, with IGNORE_LABEL rows (and, for the vlm, the logits slice);
    then remat off against remat on in the port."""
    from repro.models.model_zoo import loss_fn as j_loss_fn
    from repro_torch.models import jax_layout, loss_fn, params_from_numpy
    jcfg, cfg = configs(arch)
    tree = seeded_tree(jcfg)
    batch = numpy_batch(jcfg, S=SEQ.get(arch, 40))
    (jl, jm), jg = jax.value_and_grad(
        lambda p: j_loss_fn(p, jcfg, to_jax(batch)), has_aux=True)(
            jax.tree.map(jnp.asarray, tree))
    model = params_from_numpy(tree, cfg, device="cpu").requires_grad_(True)
    grads = {}
    for remat in (True, False):
        loss, metrics = loss_fn(model, cfg, to_torch(batch), remat=remat)
        loss.backward()
        loss = loss.detach()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        assert int(metrics["tokens"]) == int(jm["tokens"])
        assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    pg = jax_layout(grads[True])
    bad = []
    for path, g in leaves_with_paths(jax.tree.map(np.asarray, jg)):
        got = at(pg, path).numpy()
        assert got.shape == g.shape, path
        err = np.abs(got - g).max() / max(np.abs(g).max(), 1e-30)
        if err > GRAD_RTOL or not np.all(np.isfinite(got)):
            bad.append(f"{'/'.join(path)}: {err:.2e}")
    assert not bad, f"{arch}: gradients off: {bad}"
    for name, g in grads[True].items():
        torch.testing.assert_close(grads[False][name], g, rtol=1e-6,
                                   atol=1e-7 * float(g.abs().max()))
