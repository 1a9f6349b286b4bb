"""Paged decode attention: one CUDA launch per decode layer."""
from .ops import PAGED_KERNEL, paged_decode_attention_op  # noqa: F401
