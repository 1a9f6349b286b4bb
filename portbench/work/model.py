"""Model FLOPs of served tokens, for the MFUs: every linear layer's
multiply-adds at two FLOPs each (an MoE token counts the experts it is
routed to and the router), attention's two products over the keys the
token attends, and the vocabulary projection once per produced token
(at decode, every token; at prefill, the last prompt position)."""

from . import flash_attention


def linear_params(model: dict) -> int:
    """Weights one token multiplies in one layer."""
    d, hd = model["d_model"], model["head_dim"]
    H, KV, ff = model["num_heads"], model["num_kv_heads"], model["d_ff"]
    attn = d * (H + 2 * KV) * hd + H * hd * d
    E = model.get("num_experts", 0)
    if E > 1:
        return attn + model["experts_per_token"] * 3 * d * ff + d * E
    return attn + 3 * d * ff


def decode_flops(model: dict, live_keys: int, lane_steps: int) -> float:
    """``lane_steps`` decoded tokens attending ``live_keys`` keys in all."""
    L, H, hd = model["num_layers"], model["num_heads"], model["head_dim"]
    per_token = 2.0 * linear_params(model) * L \
        + 2.0 * model["d_model"] * model["vocab_size"]
    return per_token * lane_steps + 4.0 * H * hd * live_keys * L


def prefill_flops(model: dict, prompts: list) -> float:
    """The admitted prompts (their lengths), each producing one token."""
    L = model["num_layers"]
    tokens = sum(int(n) for n in prompts)
    attn, _ = flash_attention.work(model, prompts)
    return 2.0 * linear_params(model) * L * tokens + attn \
        + 2.0 * model["d_model"] * model["vocab_size"] * len(prompts)
