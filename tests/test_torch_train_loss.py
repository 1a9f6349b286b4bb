"""The training inputs and the loss of the port against the JAX package, on
the CPU: the chunked cross entropy (forward and gradient, f32 and bf16,
rows no multiple of the chunk, no f32 ``[rows, V]`` buffer), the
parameter tree both ways (exact), the training route of every attention
call site, ``input_specs``, ``abstract_params`` and ``synth_batch``.

Tolerances: the cross entropy's nll within rtol = atol = 1e-5 in both
dtypes (both upcast the same logits); its f32 gradient within 1e-5, its
bf16 gradient within one bf16 rounding (rtol 8e-3, atol 1e-3: the f32
values before the cast may differ in the last bits).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from _train_parity import (ARCHS, configs, leaves_with_paths,  # noqa: E402
                           numpy_batch, seeded_tree, to_jax, to_torch)
from repro.models.losses import softmax_cross_entropy as j_ce  # noqa: E402
from repro.models.model_zoo import abstract_params as j_abstract  # noqa: E402
from repro.models.model_zoo import input_specs as j_input_specs  # noqa: E402
from repro.models.model_zoo import loss_fn as j_loss_fn  # noqa: E402
from repro.models.model_zoo import synth_batch as j_synth_batch  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_op  # noqa: E402
from repro_torch.models import (abstract_params, forward_train,  # noqa: E402
                                input_specs, jax_layout, loss_fn,
                                params_from_numpy, params_to_numpy,
                                synth_batch)
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.losses import softmax_cross_entropy  # noqa: E402
from repro_torch.models.model_zoo import jax_path  # noqa: E402

J_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _ce_case(dtype, shape=(3, 7, 33), seed=0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape) * 3).astype(np.float32)
    labels = rng.randint(0, shape[-1], shape[:-1]).astype(np.int32)
    g = rng.randn(*shape[:-1]).astype(np.float32)
    t = torch.from_numpy(logits).to(dtype)
    # the JAX side sees the same (rounded) logits
    j = jnp.asarray(t.float().numpy()).astype(J_DTYPE[dtype])
    return t, j, labels, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk_rows", [None, 4, 1])
def test_cross_entropy_matches_jax(dtype, chunk_rows):
    """21 rows in chunks of 4 (a ragged last chunk), of 1, or all at once."""
    t, j, labels, g = _ce_case(dtype)
    t.requires_grad_(True)
    nll = softmax_cross_entropy(t, torch.from_numpy(labels), chunk_rows)
    j_nll, vjp = jax.vjp(lambda x: j_ce(x, jnp.asarray(labels)), j)
    assert nll.dtype == torch.float32
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(j_nll),
                               rtol=1e-5, atol=1e-5)
    nll.backward(torch.from_numpy(g))
    (j_d,) = vjp(jnp.asarray(g))
    assert t.grad.dtype == dtype
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 \
        else dict(rtol=8e-3, atol=1e-3)
    np.testing.assert_allclose(t.grad.float().numpy(),
                               np.asarray(j_d.astype(jnp.float32)), **tol)


def test_cross_entropy_matches_log_softmax_reference():
    """The JAX package's own check: forward and gradient against
    ``-log_softmax[label]``."""
    t, _, labels, _ = _ce_case(torch.float32, (4, 7, 33), seed=1)
    t.requires_grad_(True)
    ref_in = t.detach().clone().requires_grad_(True)
    lab = torch.from_numpy(labels).long()
    nll = softmax_cross_entropy(t, lab, 5)
    ref = -torch.log_softmax(ref_in, -1).gather(-1, lab[..., None])[..., 0]
    torch.testing.assert_close(nll, ref, rtol=1e-5, atol=1e-5)
    nll.sum().backward()
    ref.sum().backward()
    torch.testing.assert_close(t.grad, ref_in.grad, rtol=1e-5, atol=1e-5)


class _Sizes(TorchDispatchMode):
    """Records the dtype and element count of every op's tensor outputs."""

    def __init__(self):
        super().__init__()
        self.outs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.outs.append((str(func), o.dtype, o.numel()))
        return out


def test_cross_entropy_holds_no_f32_rows_by_vocab_buffer():
    """bf16 logits of 64 rows x 1000 words in chunks of 8 rows: no op of
    either pass makes an f32 tensor larger than one chunk, nor a one-hot."""
    N, V, chunk = 64, 1000, 8
    t = torch.randn(N, V).to(torch.bfloat16).requires_grad_(True)
    lab = torch.randint(0, V, (N,))
    with _Sizes() as sizes:
        softmax_cross_entropy(t, lab, chunk).sum().backward()
    big = [(f, n) for f, dt, n in sizes.outs
           if dt in (torch.float32, torch.int64, torch.bool)
           and n > chunk * V]
    assert not big, big
    assert t.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_params_to_numpy_inverts_params_from_numpy(arch):
    """The JAX tree, carried into the port and back: the same keys,
    shapes, dtypes and values, exactly."""
    jcfg, cfg = configs(arch)
    tree = seeded_tree(jcfg)
    back = params_to_numpy(params_from_numpy(tree, cfg, device="cpu"))
    want = leaves_with_paths(tree)
    got = leaves_with_paths(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


def test_jax_path_names():
    assert jax_path("layers.3.wq") == (("layers", "attn", "wq"), 3)
    assert jax_path("shared_attn.w_in") == (("shared_attn", "mlp", "w_in"),
                                            None)
    assert jax_path("layers.0.tm.ln_out.bias") == (
        ("layers", "tm", "ln_out", "bias"), 0)
    assert jax_path("cross_layers.1.wo") == (("cross_layers", "attn", "wo"),
                                             1)
    assert jax_path("final_norm.scale") == (("final_norm", "scale"), None)
    assert jax_path("embed") == (("embed",), None)


@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-1.2b",
                                  "whisper-medium", "phi-3-vision-4.2b"])
def test_training_forward_routes_every_attention_call_explicitly(
        arch, monkeypatch):
    """``forward_train`` passes ``differentiable=True`` at every attention
    call site (self, the shared block, the encoder, cross); the serving
    forward passes False at each.  The route is an argument: the test runs
    both on the CPU, where the device would choose nothing."""
    jcfg, cfg = configs(arch)
    model = params_from_numpy(seeded_tree(jcfg), cfg, device="cpu")
    batch = to_torch(numpy_batch(jcfg, S=24))
    calls = []
    real = transformer.attention

    def spy(*args, **kw):
        calls.append(kw.get("differentiable", False))
        return real(*args, **kw)
    monkeypatch.setattr(transformer, "attention", spy)
    forward_train(model, cfg, batch)
    n = len(calls)
    want = {"gemma3-1b": cfg.num_layers, "zamba2-1.2b": 2,
            "whisper-medium": cfg.encoder_layers + 2 * cfg.num_layers,
            "phi-3-vision-4.2b": cfg.num_layers}[arch]
    assert n == want and all(calls)
    calls.clear()
    with torch.no_grad():
        transformer.forward(model, batch["tokens"],
                            prefix_embeds=batch.get("patches"),
                            encoder_frames=batch.get("frames"))
    assert len(calls) == n and not any(calls)


def test_flash_op_refuses_an_input_that_requires_a_gradient():
    """The kernel has no backward: with grad mode on, an input that
    requires a gradient raises on either device (here the CPU); frozen
    inputs, or grad mode off, run as before."""
    q, k, v = (torch.randn(1, 8, 2, 16) for _ in range(3))
    out = flash_attention_op(q, k, v)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention_op(q.clone().requires_grad_(True), k, v)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention_op(q, k, v.clone().requires_grad_(True))
    with torch.no_grad():
        torch.testing.assert_close(
            flash_attention_op(q.clone().requires_grad_(True), k, v), out)


def test_serving_forward_with_frozen_parameters_keeps_no_graph():
    """Serving holds frozen parameters: under grad mode its logits carry no
    graph, and the same model trains once the trainer turns gradients
    on."""
    jcfg, cfg = configs("gemma3-1b")
    model = params_from_numpy(seeded_tree(jcfg), cfg, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    tokens = torch.from_numpy(numpy_batch(jcfg, S=16)["tokens"])
    assert transformer.forward(model, tokens).grad_fn is None
    model.requires_grad_(True)
    assert transformer.forward(model, tokens).grad_fn is not None


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma3-1b"])
def test_loss_fn_with_every_label_ignored(arch):
    """Every label IGNORE_LABEL: loss 0 over a denominator of 1, as in
    JAX; no gradient moves."""
    jcfg, cfg = configs(arch)
    tree = seeded_tree(jcfg)
    batch = numpy_batch(jcfg, S=12)
    batch["labels"][:] = -1
    jl, jm = j_loss_fn(jax.tree.map(jnp.asarray, tree), jcfg, to_jax(batch))
    model = params_from_numpy(tree, cfg, device="cpu").requires_grad_(True)
    loss, metrics = loss_fn(model, cfg, to_torch(batch))
    loss.backward()
    assert float(loss.detach()) == float(jl) == 0.0
    assert int(metrics["tokens"]) == int(jm["tokens"]) == 1
    assert all(float(p.grad.abs().max()) == 0.0 for p in model.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_abstract_params_match_jax(arch):
    jcfg, cfg = configs(arch)
    for shape in ("train_4k", "prefill_32k"):
        want = j_input_specs(jcfg, shape)
        got = input_specs(cfg, shape)
        assert set(got) == set(want)
        for k, spec in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == spec.shape
            assert str(got[k].dtype).removeprefix("torch.") == str(spec.dtype)
    j_tree = j_abstract(jcfg, jnp.bfloat16)
    meta = abstract_params(cfg, torch.bfloat16)
    assert all(p.device.type == "meta" for p in meta.parameters())
    got = jax_layout(dict(meta.named_parameters()))
    flat = jax.tree_util.tree_flatten_with_path(j_tree)[0]
    assert len(flat) == len(leaves_with_paths(jax.tree.map(
        lambda s: np.zeros(0), j_tree)))
    for path, spec in flat:
        sub = got
        for key in path:
            sub = sub[key.key]
        assert tuple(sub.shape) == spec.shape, path
        assert str(sub.dtype).removeprefix("torch.") == str(spec.dtype), path


@pytest.mark.parametrize("arch", ["deepseek-7b", "phi-3-vision-4.2b",
                                  "whisper-medium"])
def test_synth_batch_layout_matches_jax(arch):
    """Keys, shapes and dtypes as the JAX function's (its values come from
    ``jax.random``, the port's from a torch generator); labels are the
    tokens rolled left by one."""
    jcfg, cfg = configs(arch)
    want = j_synth_batch(jcfg, 2, 16, seed=3)
    got = synth_batch(cfg, 2, 16, seed=3, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)
    assert torch.equal(got["labels"], torch.roll(got["tokens"], -1, 1))
    again = synth_batch(cfg, 2, 16, seed=3, device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)
