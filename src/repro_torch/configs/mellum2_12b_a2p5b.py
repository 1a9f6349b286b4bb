"""Mellum2 12B (2.5B active) — MoE (64 experts, top-8) on every layer,
three sliding-window layers to one global layer
[hf:JetBrains/Mellum2-12B-A2.5B-Instruct, config.json].

28L in the pattern (sliding, sliding, sliding, full) x 7, d_model=2304, 32
query heads on 4 KV heads x 128, 64 experts of d_ff=896 (SwiGLU, softmax
router, top-8 renormalised, no shared expert), vocab=98304, untied head,
RMSNorm eps 1e-6, no attention bias.  Sliding layers see 1024 tokens with
plain RoPE at theta 500000; full layers take YaRN RoPE at the same theta
(factor 16 over 8192 original positions, beta_fast 32, beta_slow 1,
attention factor 0.1 ln 16 + 1).  The sliding layers' K/V lives in a
pool of its own that recycles past the window (``kv_split_window``).
The router drops no token: the capacity
factor is ``num_experts / experts_per_token``.  The config names no
QK-norm (none is taken); its multi-token-prediction head is not served.
"""
import math

from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mellum2-12b-a2.5b",
    family="moe",
    num_layers=28,
    d_model=2304,
    num_heads=32,
    num_kv_heads=4,
    d_ff=896,
    vocab_size=98304,
    head_dim=128,
    num_experts=64,
    experts_per_token=8,
    moe_capacity_factor=8.0,
    attn_pattern="local_global",
    local_per_global=3,
    window=1024,
    kv_split_window=True,
    rope_theta=500_000.0,
    yarn_factor=16.0,
    yarn_original_max_position=8192,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_attention_factor=0.1 * math.log(16.0) + 1.0,
    norm="rmsnorm",
    act="swiglu",
    source="hf:JetBrains/Mellum2-12B-A2.5B-Instruct; config.json",
))
