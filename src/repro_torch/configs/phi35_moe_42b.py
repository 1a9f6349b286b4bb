"""Phi-3.5-MoE 42B (6.6B active) — MoE (16 experts, top-2)
[hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=6400 per expert, vocab=32064.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    head_dim=128,
    num_experts=16,
    experts_per_token=2,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="swiglu",
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
))
