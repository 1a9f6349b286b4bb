"""Zamba2-1.2B — hybrid: Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].

38 Mamba2 layers, d_model=2048, shared attn block (32H, kv=32) applied every
6 layers (weights shared across invocations — the zamba2 signature),
d_ff=8192, vocab=32000, ssm_state=64.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="swiglu",
    source="arXiv:2411.15242; hf",
))
