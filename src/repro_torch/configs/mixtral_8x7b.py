"""Mixtral 8x7B — MoE (8 experts, top-2), sliding-window attention
[arXiv:2401.04088; hf].

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336 per expert, vocab=32000,
SWA window 4096.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    num_experts=8,
    experts_per_token=2,
    attn_pattern="swa",
    window=4096,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="swiglu",
    source="arXiv:2401.04088; hf",
))
