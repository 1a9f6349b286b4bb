"""Loss and gradients of the port against the JAX package, on the CPU, in
f32, for the dense backbones (deepseek-7b, gemma3-1b, phi3-medium-14b,
qwen2-72b); ``test_torch_train_grads_families.py`` holds the other four.

Tolerances (f32): the loss within 1e-5 relative, every gradient's max
|difference| within 1e-4 of its max |g| (sums in another order, the
chunked softmax and the scan rounding otherwise); remat off against remat
on within 1e-6 relative.  The JAX tree carries seeded values where its
init has constants (``_train_parity.seeded_tree``).
"""
import pytest

pytest.importorskip("torch")

from _train_parity import check_loss_and_grads  # noqa: E402


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma3-1b",
                                  "phi3-medium-14b", "qwen2-72b"])
def test_loss_and_every_gradient_match_jax(arch):
    check_loss_and_grads(arch)
