"""Whisper-medium — encoder-decoder, conv audio frontend (STUB)
[arXiv:2212.04356; unverified] (copy of :mod:`repro.configs.whisper_medium`).

24 encoder + 24 decoder layers, d_model=1024, 16 heads (kv=16), d_ff=4096,
vocab=51865.  The conv frontend is a stub: a request carries precomputed
frame embeddings (1500 frames of d_model).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    encoder_layers=24,
    encoder_seq_len=1500,
    frontend="audio_stub",
    norm="layernorm",
    act="gelu",
    source="arXiv:2212.04356; unverified",
))
