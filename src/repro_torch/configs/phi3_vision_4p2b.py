"""Phi-3-vision 4.2B — phi3-mini backbone + CLIP frontend (STUB)
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

32L, d_model=3072, 32 heads (kv=32), d_ff=8192, vocab=32064.
The CLIP image encoder is a stub: a request carries precomputed patch
embeddings (576 rows of d_model), the prefix its prompt follows.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    frontend="vision_stub",
    frontend_tokens=576,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="swiglu",
    source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
))
