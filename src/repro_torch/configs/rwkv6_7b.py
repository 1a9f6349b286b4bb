"""RWKV-6 (Finch) 7B — attention-free, data-dependent decay
[arXiv:2404.05892; hf] (copy of :mod:`repro.configs.rwkv6_7b`).

32L, d_model=4096, d_ff=14336, vocab=65536.  64 wkv heads of size 64.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,          # wkv heads (d_model / 64)
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    head_dim=64,
    ssm_state=64,          # per-head state is [64 x 64]
    ssm_head_dim=64,
    norm="layernorm",
    act="gelu",            # channel-mix uses squared relu; see models/rwkv6.py
    source="arXiv:2404.05892; hf",
))
