"""DeepSeek-LLM 7B — llama-arch dense decoder [arXiv:2401.02954; hf].

30L, d_model=4096, 32 heads (MHA: kv=32), d_ff=11008, vocab=102400.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    head_dim=128,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="swiglu",
    source="arXiv:2401.02954; hf",
))
