"""Architecture config system (copy of :mod:`repro.configs.base`).

One :class:`ArchConfig` describes an architecture; ``configs/<id>.py``
instantiates the published numbers and :func:`get_config` resolves an arch
id.  This slice of the port carries the dense family only, so the registry
knows ``deepseek-7b``; the other arch modules are ported with their model
families (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

_REGISTRY: dict[str, "ArchConfig"] = {}

#: arch ids the port can build today
ARCH_IDS = ("deepseek-7b",)

_MODULE_BY_ID = {
    "deepseek-7b": "deepseek_7b",
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A unified description of one architecture (same fields as the JAX
    package's ``ArchConfig``, so configs compare field for field)."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None           # default d_model // num_heads
    qkv_bias: bool = False
    # --- attention pattern ---
    attn_pattern: str = "full"               # full | swa | local_global
    window: Optional[int] = None             # SWA window (tokens)
    local_per_global: int = 0
    rope_theta: float = 10_000.0
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    attn_every: int = 0
    # --- encoder-decoder ---
    encoder_layers: int = 0
    encoder_seq_len: int = 0
    # --- modality frontend stub ---
    frontend: Optional[str] = None
    frontend_tokens: int = 0
    # --- misc ---
    norm: str = "rmsnorm"                    # rmsnorm | layernorm
    act: str = "swiglu"                      # swiglu | geglu | gelu
    tie_embeddings: bool = False
    source: str = ""                         # provenance note

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def num_attn_layers(self) -> int:
        """Number of attention (KV-cache-bearing) layer instances."""
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            return self.num_layers // max(self.attn_every, 1)
        return self.num_layers


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _REGISTRY:
        mod = _MODULE_BY_ID.get(arch_id)
        if mod is None:
            raise KeyError(f"unknown arch '{arch_id}'; the port knows "
                           f"{sorted(_MODULE_BY_ID)} (see ROADMAP.md)")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[arch_id]


def smoke_config(arch_id: str) -> ArchConfig:
    """A reduced same-family config for CPU smoke tests (the JAX package's
    reduction, field for field)."""
    full = get_config(arch_id)
    return dataclasses.replace(
        full,
        num_layers=min(full.num_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(full.num_kv_heads, 4) if full.num_kv_heads > 1 else 1,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        num_experts=min(full.num_experts, 4) if full.num_experts else 0,
        moe_capacity_factor=16.0,
        window=min(full.window, 64) if full.window else None,
        ssm_state=min(full.ssm_state, 16) if full.ssm_state else 0,
        ssm_head_dim=32 if full.ssm_state else 64,
        attn_every=2 if full.attn_every else 0,
        encoder_layers=min(full.encoder_layers, 2),
        encoder_seq_len=min(full.encoder_seq_len, 16),
        frontend_tokens=min(full.frontend_tokens, 8) if full.frontend_tokens else 0,
    )
