"""Plain reference of mixtral-8x7b (Mixtral 8x7B, arXiv:2401.04088): the
Mistral decoder with every layer's attention over every earlier token
(the published model attends densely over its 32k context, with no
sliding window) and a mixture of 8 SwiGLU experts, top-2, in place of
the MLP.  The router is the published
one: no token is dropped, so a token's result does not depend on the
tokens batched with it; the configuration runs the program at a capacity
factor of ``num_experts / experts_per_token``, at which the program drops
none either.  The model is
:func:`portbench.reference.decoder.served_logits`."""
from portbench.reference.decoder import served_logits


def check(model: dict) -> None:
    if model.get("window") is not None:
        raise ValueError("mixtral-8x7b attends densely, with no window")
    E, k = model["num_experts"], model["experts_per_token"]
    if model["moe_capacity_factor"] * k < E:
        raise ValueError(
            f"capacity factor {model['moe_capacity_factor']} can drop "
            f"tokens; the reference routes every token to its {k} experts")


__all__ = ["served_logits", "check"]
