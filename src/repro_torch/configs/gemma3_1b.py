"""Gemma-3 1B — dense, 5:1 local:global attention, 128k-capable
[hf:google/gemma-3-1b-pt; unverified].

26L, d_model=1152, 4 heads (GQA kv=1), d_ff=6912, vocab=262144.
head_dim=256 (gemma3 uses wide heads); local window 512.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    attn_pattern="local_global",
    local_per_global=5,
    window=512,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="geglu",
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; unverified",
))
