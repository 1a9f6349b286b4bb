"""Loss and gradients of the port against the JAX package, on the CPU, in
f32, for the vlm, hybrid, ssm, audio and moe families (phi-3-vision-4.2b
with its logits slice, zamba2-1.2b with the shared block twice, rwkv6-7b,
whisper-medium with its encoder and cross blocks, mixtral-8x7b under its
window of 64 over 128-token rows, phi3.5-moe-42b-a6.6b); the tolerances
of ``test_torch_train_grads.py``.  The moe router's gradient flows
through the renormalised top-k probabilities, the experts' through the
kept pairs; smoke's capacity factor 16 drops no pair, as in the JAX
package's training forward at these sizes.
"""
import pytest

pytest.importorskip("torch")

from _train_parity import check_loss_and_grads  # noqa: E402


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "zamba2-1.2b",
                                  "rwkv6-7b", "whisper-medium",
                                  "mixtral-8x7b", "phi3.5-moe-42b-a6.6b"])
def test_loss_and_every_gradient_match_jax(arch):
    check_loss_and_grads(arch)
