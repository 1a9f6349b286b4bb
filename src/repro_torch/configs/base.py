"""Architecture config system (copy of :mod:`repro.configs.base`).

One :class:`ArchConfig` describes an architecture; ``configs/<id>.py``
instantiates the published numbers and :func:`get_config` resolves an arch
id.  The port carries the dense family -- ``deepseek-7b`` (full attention),
``gemma3-1b`` (local:global windows, GQA), ``phi3-medium-14b`` (GQA 4:1)
and ``qwen2-72b`` (GQA 8:1, QKV bias, RoPE theta 1e6) --, the vlm family
-- ``phi-3-vision-4.2b`` (a phi3-mini backbone at head dim 96 behind a
prefix of precomputed patch embeddings) --, the hybrid family --
``zamba2-1.2b`` (Mamba2 layers with one shared attention block) --, the
ssm family -- ``rwkv6-7b`` (attention-free, data-dependent decay) -- and
the audio family -- ``whisper-medium`` (an encoder over precomputed frame
embeddings, a decoder with cross-attention) -- and the moe family --
``mixtral-8x7b`` (8 experts, top-2, sliding-window attention) and
``phi3.5-moe-42b-a6.6b`` (16 experts, top-2, full attention): every arch
of the JAX package -- and ``mellum2-12b-a2.5b`` (64 experts, top-8, three
sliding-window layers to one global YaRN layer), which the JAX package
does not have (:data:`PORT_ONLY_ARCH_IDS`).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

_REGISTRY: dict[str, "ArchConfig"] = {}

#: arch ids the port can build today
ARCH_IDS = ("deepseek-7b", "gemma3-1b", "phi3-medium-14b", "qwen2-72b",
            "phi-3-vision-4.2b", "zamba2-1.2b", "rwkv6-7b", "whisper-medium",
            "mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "mellum2-12b-a2.5b")

#: arch ids of the port that the JAX package it was ported from does not
#: have: no parity test can hold them to it
PORT_ONLY_ARCH_IDS = ("mellum2-12b-a2.5b",)

_MODULE_BY_ID = {
    "deepseek-7b": "deepseek_7b",
    "gemma3-1b": "gemma3_1b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen2-72b": "qwen2_72b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "zamba2-1.2b": "zamba2_1p2b",
    "rwkv6-7b": "rwkv6_7b",
    "whisper-medium": "whisper_medium",
    "mixtral-8x7b": "mixtral_8x7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "mellum2-12b-a2.5b": "mellum2_12b_a2p5b",
}

#: the four assigned input shapes (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
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
    # --- under local_global, the windowed layers' K/V in a second paged
    # pool that recycles past the window (a field of the port alone: the
    # JAX package keeps every layer in one pool) ---
    kv_split_window: bool = False
    rope_theta: float = 10_000.0
    # --- YaRN RoPE on the global (full-attention) layers; 0 = plain RoPE
    # everywhere (a field of the port alone: the JAX package has no YaRN) ---
    yarn_factor: float = 0.0
    yarn_original_max_position: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_attention_factor: float = 1.0
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
    def is_attention_free(self) -> bool:
        return self.family == "ssm" and self.attn_every == 0

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / bounded-window attention)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attn_pattern in ("swa", "local_global")

    @property
    def num_attn_layers(self) -> int:
        """Number of attention (KV-cache-bearing) layer instances."""
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            return self.num_layers // max(self.attn_every, 1)
        return self.num_layers

    def param_count(self) -> int:
        """Analytic parameter count (the roofline's model FLOPs; the JAX
        package's formula, term for term)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        if self.qkv_bias:
            per_attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        gated = self.act in ("swiglu", "geglu")
        per_mlp = d * ff * (3 if gated else 2)
        if self.family == "moe":
            per_mlp = per_mlp * self.num_experts + d * self.num_experts  # + router
        norms = 2 * d
        if self.family == "ssm":  # rwkv6: time-mix + channel-mix
            return emb + self.num_layers * self._rwkv_layer_params() + d
        if self.family == "hybrid":
            mamba = self._mamba_layer_params()
            shared_attn = per_attn + per_mlp + norms
            return emb + self.num_layers * mamba + shared_attn + d
        per_layer = per_attn + per_mlp + norms
        total = emb + self.num_layers * per_layer + d
        if self.encoder_layers:
            total += self.encoder_layers * per_layer + self.encoder_seq_len * d + d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        gated = self.act in ("swiglu", "geglu")
        per_expert = d * ff * (3 if gated else 2)
        inactive = (self.num_experts - self.experts_per_token) * per_expert
        return self.param_count() - self.num_layers * inactive

    def _mamba_layer_params(self) -> int:
        d = self.d_model
        d_inner = 2 * d
        heads = d_inner // self.ssm_head_dim
        n = self.ssm_state
        # in_proj (z,x,B,C,dt) + out_proj + conv + A,D + norms
        return d * (2 * d_inner + 2 * n + heads) + d_inner * d \
            + 4 * (d_inner + 2 * n) + 2 * heads + 2 * d + d_inner

    def _rwkv_layer_params(self) -> int:
        d, ff = self.d_model, self.d_ff
        # time-mix: r,k,v,g,o projections + decay LoRA + token-shift mixing
        tm = 5 * d * d + 2 * d * 64 + 6 * d
        cm = 2 * d * ff + d * d  # channel-mix: key [d,ff], value [ff,d], recept [d,d]
        return tm + cm + 2 * d


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


def all_configs() -> dict[str, ArchConfig]:
    """Every arch the port can build, by id (:data:`ARCH_IDS`)."""
    return {a: get_config(a) for a in ARCH_IDS}


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
        # a top-k wider than half the 4 experts left is cut to 2 (the JAX
        # archs' top-2 unchanged)
        experts_per_token=min(full.experts_per_token, 2)
        if full.experts_per_token else 0,
        moe_capacity_factor=16.0,
        window=min(full.window, 64) if full.window else None,
        ssm_state=min(full.ssm_state, 16) if full.ssm_state else 0,
        ssm_head_dim=32 if full.ssm_state else 64,
        attn_every=2 if full.attn_every else 0,
        encoder_layers=min(full.encoder_layers, 2),
        encoder_seq_len=min(full.encoder_seq_len, 16),
        frontend_tokens=min(full.frontend_tokens, 8) if full.frontend_tokens else 0,
    )
