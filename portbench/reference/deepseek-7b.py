"""Plain reference of deepseek-7b (DeepSeek LLM 7B, arXiv:2401.02954): a
Llama-style dense decoder, 30 blocks of rotary multi-head attention over
every earlier token and a SwiGLU MLP.  The model is
:func:`portbench.reference.decoder.served_logits` with no window and no
experts."""
from portbench.reference.decoder import served_logits


def check(model: dict) -> None:
    if model.get("num_experts", 0) > 1 or model.get("window") is not None:
        raise ValueError("deepseek-7b is dense, with full attention")


__all__ = ["served_logits", "check"]
