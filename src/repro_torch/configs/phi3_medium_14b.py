"""Phi-3-medium 14B — dense, RoPE + SwiGLU + GQA [arXiv:2404.14219; unverified].

40L, d_model=5120, 40 heads (GQA kv=10), d_ff=17920, vocab=100352.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    head_dim=128,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="swiglu",
    source="arXiv:2404.14219; unverified",
))
