"""Loss and gradients of the port against the JAX package, on the CPU, in
f32, for the vlm, hybrid, ssm and audio families (phi-3-vision-4.2b with
its logits slice, zamba2-1.2b with the shared block twice, rwkv6-7b,
whisper-medium with its encoder and cross blocks); the tolerances of
``test_torch_train_grads.py``.
"""
import pytest

pytest.importorskip("torch")

from _train_parity import check_loss_and_grads  # noqa: E402


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "zamba2-1.2b",
                                  "rwkv6-7b", "whisper-medium"])
def test_loss_and_every_gradient_match_jax(arch):
    check_loss_and_grads(arch)
